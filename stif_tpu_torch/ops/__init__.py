"""Tensor ops of the port (counterparts of ``stif_tpu.ops``)."""

from stif_tpu_torch.ops.coords import make_coord
from stif_tpu_torch.ops.deform_conv import deform_conv2d, split_offset_mask
from stif_tpu_torch.ops.grid_sample import grid_sample
from stif_tpu_torch.ops.pixel_shuffle import pixel_shuffle
from stif_tpu_torch.ops.resize import imresize, imresize_to, resize_bilinear
from stif_tpu_torch.ops.siren_fused import (
    siren_apply_fused,
    siren_apply_fused_plain,
)
from stif_tpu_torch.ops.warp import warp_grid

__all__ = [
    "deform_conv2d",
    "grid_sample",
    "imresize",
    "imresize_to",
    "make_coord",
    "pixel_shuffle",
    "resize_bilinear",
    "siren_apply_fused",
    "siren_apply_fused_plain",
    "split_offset_mask",
    "warp_grid",
]
