"""Tensor ops of the port (counterparts of ``stif_tpu.ops``)."""

from stif_tpu_torch.ops.coords import make_coord, make_coord_demo
from stif_tpu_torch.ops.deform_conv import (
    dcn_backward,
    dcn_backward_plain,
    dcn_col2im_plain,
    dcn_forward,
    dcn_forward_plain,
    dcn_im2col_plain,
    dcn_shift_stats,
    deform_conv2d,
    deform_conv2d_plain,
    set_dcn_impl,
    split_offset_mask,
)
from stif_tpu_torch.ops.fold import fold3x3
from stif_tpu_torch.ops.grid_sample import grid_sample, grid_sample_plain
from stif_tpu_torch.ops.pixel_shuffle import pixel_shuffle
from stif_tpu_torch.ops.resize import imresize, imresize_to, resize_bilinear
from stif_tpu_torch.ops.siren_fused import (
    siren_apply_fused,
    siren_apply_fused_plain,
)
from stif_tpu_torch.ops.warp import backward_warp, warp_grid, warp_grid_coords

__all__ = [
    "backward_warp",
    "dcn_backward",
    "dcn_backward_plain",
    "dcn_col2im_plain",
    "dcn_forward",
    "dcn_forward_plain",
    "dcn_im2col_plain",
    "dcn_shift_stats",
    "deform_conv2d",
    "deform_conv2d_plain",
    "fold3x3",
    "grid_sample",
    "grid_sample_plain",
    "imresize",
    "imresize_to",
    "make_coord",
    "make_coord_demo",
    "pixel_shuffle",
    "resize_bilinear",
    "set_dcn_impl",
    "siren_apply_fused",
    "siren_apply_fused_plain",
    "split_offset_mask",
    "warp_grid",
    "warp_grid_coords",
]
