"""LIIF-style ReLU MLP, registered as ``'mlp'`` (port of
``stif_tpu/nn/mlp.py``): Linear / ReLU over ``hidden_list``, a last plain
Linear, applied over the last axis. Parameters are keyed as the reference's
``nn.Sequential`` keys them: ``layers.{2i}``."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn


class MLP(nn.Module):
    def __init__(self, in_dim: int, out_dim: int = 3,
                 hidden_list: Sequence[int] = ()):
        super().__init__()
        layers, last = [], in_dim
        for h in hidden_list:
            layers += [nn.Linear(last, h), nn.ReLU()]
            last = h
        layers.append(nn.Linear(last, out_dim))
        self.layers = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)
