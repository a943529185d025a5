"""Channels-last ``grid_sample`` (port of ``stif_tpu/ops/grid_sample.py``).

The JAX module re-implements ``torch.nn.functional.grid_sample`` for the TPU;
its parity target is that op. So here it is a thin NHWC wrapper over it:
modes ``nearest`` / ``bilinear``, padding ``zeros`` / ``border``, both
``align_corners`` conventions. Nearest rounds half to even, as both do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stif_tpu_torch.ops.precision import round_to


def grid_sample(x: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear",
                padding_mode: str = "zeros", align_corners: bool = False,
                source_dtype=None) -> torch.Tensor:
    """Sample ``x`` (B, H, W, C) at ``grid`` (B, Hg, Wg, 2) or (B, Q, 2).

    Grid channel order is torch's: ``grid[..., 0] = x`` (width axis),
    ``grid[..., 1] = y``, in [-1, 1]. Returns a contiguous (B, Hg, Wg, C),
    or (B, Q, C) for a flat grid.

    ``source_dtype`` (e.g. ``torch.bfloat16``, ``torch.float8_e4m3fn``)
    rounds the source before a bilinear gather; the interpolation stays
    fp32. The nearest mode ignores it, as the JAX op does.
    """
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unsupported mode: {mode}")
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    if mode == "bilinear":
        x = round_to(x, source_dtype)
    flat = grid.dim() == 3
    g = grid[:, :, None, :] if flat else grid
    out = F.grid_sample(x.permute(0, 3, 1, 2), g.to(x.dtype), mode=mode,
                        padding_mode=padding_mode,
                        align_corners=align_corners)
    out = out.permute(0, 2, 3, 1)
    if flat:
        out = out[:, :, 0, :]
    return out.contiguous()
