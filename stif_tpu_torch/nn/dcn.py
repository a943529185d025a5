"""DCN_sep: deformable conv whose offsets and mask come from another feature
map (port of ``stif_tpu/nn/dcn.py``)."""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from stif_tpu_torch.nn.blocks import Conv
from stif_tpu_torch.ops.deform_conv import deform_conv2d, split_offset_mask


class DCNSep(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 dilation: int = 1, deformable_groups: int = 8,
                 gather_dtype=None):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.kernel_size = k
        self.deformable_groups = deformable_groups
        self.gather_dtype = gather_dtype  # e.g. torch.bfloat16 gather source
        # zero-initialised: a fresh DCNSep samples the regular grid
        self.conv_offset_mask = Conv(in_channels, deformable_groups * 3 * k * k,
                                     k, stride, padding)
        nn.init.zeros_(self.conv_offset_mask.weight)
        nn.init.zeros_(self.conv_offset_mask.bias)
        stdv = 1.0 / math.sqrt(in_channels * k * k)
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, k, k).uniform_(-stdv, stdv))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor, fea: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) features to convolve; fea: the features that
        produce the offsets and mask."""
        offset, mask = split_offset_mask(self.conv_offset_mask(fea),
                                         self.deformable_groups,
                                         self.kernel_size)
        return deform_conv2d(x, offset, mask, self.weight, self.bias,
                             stride=self.stride, padding=self.padding,
                             dilation=self.dilation,
                             gather_dtype=self.gather_dtype)
