"""Conv building blocks, channels-last (port of ``stif_tpu/nn/blocks.py``).

Parameters follow the reference ``.pth`` schema (OIHW conv weights). The
forward takes and returns NHWC tensors; the NCHW view handed to the conv is
a permutation, so cuDNN sees a channels-last tensor and no copy is made.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def lrelu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.1), the reference's activation."""
    return F.leaky_relu(x, negative_slope=0.1)


def remat(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``; with grad mode on, under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in the backward pass instead of stored, as the JAX package's
    ``nn.remat``. Without grad it is a plain call. ``fn`` draws no random
    numbers, so the RNG state is not stashed."""
    if not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kwargs)


class Conv(nn.Conv2d):
    """2-D conv on NHWC tensors with an explicit symmetric ``padding`` (torch
    convention), so strided convs give torch's output sizes."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ResidualBlockNoBN(nn.Module):
    """x + conv2(relu(conv1(x))); kaiming-normal init scaled by 0.1, zero
    bias (reference ``module_util.py``)."""

    def __init__(self, nf: int = 64):
        super().__init__()
        self.conv1 = Conv(nf, nf, 3, 1, 1)
        self.conv2 = Conv(nf, nf, 3, 1, 1)
        for conv in (self.conv1, self.conv2):
            nn.init.normal_(conv.weight, std=0.1 * math.sqrt(2.0 / (9 * nf)))
            nn.init.zeros_(conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(x)))


class ResidualTrunk(nn.Sequential):
    """``make_layer``: ``n_blocks`` residual blocks keyed ``{i}.conv{1,2}``
    (the JAX package scans deep trunks with stacked parameters; the maths is
    the same)."""

    def __init__(self, nf: int = 64, n_blocks: int = 5):
        super().__init__(*[ResidualBlockNoBN(nf) for _ in range(n_blocks)])
