"""DCN_sep: deformable conv whose offsets and mask come from another feature
map (port of ``stif_tpu/nn/dcn.py``). ``impl`` and ``shift_bound`` pick the
DCN implementation as in the JAX package (``ops/deform_conv.py``); on the
card the op runs the DCN kernels."""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from stif_tpu_torch.nn.blocks import Conv
from stif_tpu_torch.ops import capture
from stif_tpu_torch.ops.deform_conv import (deform_conv2d,
                                            deform_conv2d_plain,
                                            split_offset_mask)


class DCNSep(nn.Module, capture.Switched):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 dilation: int = 1, deformable_groups: int = 8,
                 gather_dtype=None, impl: str = "auto",
                 shift_bound: int = 6):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.kernel_size = k
        self.deformable_groups = deformable_groups
        self.gather_dtype = gather_dtype  # e.g. torch.bfloat16 gather source
        self.impl = impl                  # "auto" / "patch" / "dense" / "window"
        self.shift_bound = shift_bound    # dense: max |shift| covered
        self.use_kernel = True  # False: plain PyTorch (``set_dcn_kernel``)
        # zero-initialised: a fresh DCNSep samples the regular grid
        self.conv_offset_mask = Conv(in_channels, deformable_groups * 3 * k * k,
                                     k, stride, padding)
        nn.init.zeros_(self.conv_offset_mask.weight)
        nn.init.zeros_(self.conv_offset_mask.bias)
        stdv = 1.0 / math.sqrt(in_channels * k * k)
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, k, k).uniform_(-stdv, stdv))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def route_flags(self) -> tuple:
        return (self.use_kernel,)

    def forward(self, x: torch.Tensor, fea: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) features to convolve; fea: the features that
        produce the offsets and mask."""
        offset, mask = split_offset_mask(self.conv_offset_mask(fea),
                                         self.deformable_groups,
                                         self.kernel_size)
        op = deform_conv2d if self.use_kernel else deform_conv2d_plain
        return op(x, offset, mask, self.weight, self.bias,
                  stride=self.stride, padding=self.padding,
                  dilation=self.dilation, impl=self.impl,
                  gather_dtype=self.gather_dtype,
                  shift_bound=self.shift_bound)


def set_dcn_kernel(model: nn.Module, on: bool) -> None:
    """Run every ``DCNSep`` of ``model`` through the DCN op
    (``deform_conv2d``: the kernels on the card), or, with ``on`` False,
    through its plain PyTorch form differentiated by autograd: the yardstick
    the kernels are held against on the card. A change makes a new program
    key (``ops/capture.py``)."""
    for m in model.modules():
        if isinstance(m, DCNSep):
            before = m.route_flags()
            m.use_kernel = on
            capture.switched(capture.epochs_of(m), before, m.route_flags())
