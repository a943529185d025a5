"""SIREN coordinate MLP (port of ``stif_tpu/nn/siren.py``, fp32 path).

Parameters follow the reference schema: sine layers are ``net.{i}.linear``,
the plain linear output layer is ``net.{last}``. The forward hands the field
list to ``siren_apply_fused`` and never concatenates it itself: on the GPU
the fused kernel reads the fields in place.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn

from stif_tpu_torch.ops.siren_fused import (
    siren_apply_fused,
    siren_apply_fused_plain,
)


class SineLayer(nn.Module):
    def __init__(self, in_features: int, out_features: int, is_first: bool,
                 omega0: float = 30.0):
        super().__init__()
        self.linear = nn.Linear(in_features, out_features)
        # SIREN init: U(-1/n, 1/n) first, U(-sqrt(6/n)/omega0, +) hidden;
        # the bias keeps nn.Linear's default
        bound = (1.0 / in_features if is_first
                 else math.sqrt(6.0 / in_features) / omega0)
        nn.init.uniform_(self.linear.weight, -bound, bound)


class Siren(nn.Module):
    """net = [Sine(first), Sine x hidden_layers, Linear].

    ``fused=False`` runs the plain PyTorch version on any device: it is the
    yardstick the fused kernel is compared against, never a fallback.
    """

    def __init__(self, in_features: int, hidden_features: Sequence[int],
                 hidden_layers: int, out_features: int, omega0: float = 30.0,
                 fused: bool = True):
        super().__init__()
        dims = ([in_features] + list(hidden_features[:hidden_layers + 1])
                + [out_features])
        layers = [SineLayer(dims[i], dims[i + 1], i == 0, omega0)
                  for i in range(len(dims) - 2)]
        last = nn.Linear(dims[-2], dims[-1])
        bound = math.sqrt(6.0 / dims[-2]) / omega0
        nn.init.uniform_(last.weight, -bound, bound)
        self.net = nn.ModuleList(layers + [last])
        self.omega0 = omega0
        self.fused = fused

    def forward(self, x) -> torch.Tensor:
        """``x``: (..., Cin), or a list of (..., c_i) fields sharing leading
        dims, concatenated on the feature axis inside the op."""
        linears = [m.linear for m in self.net[:-1]] + [self.net[-1]]
        ws = [lin.weight.t().contiguous() for lin in linears]
        bs = [lin.bias for lin in linears]
        fn = siren_apply_fused if self.fused else siren_apply_fused_plain
        return fn(x, ws, bs, omega0=self.omega0)
