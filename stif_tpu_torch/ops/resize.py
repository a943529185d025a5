"""Image resampling (port of ``stif_tpu/ops/resize.py``).

- ``imresize`` / ``imresize_to``: MATLAB-convention bicubic with
  antialiasing and symmetric edge padding, the degradation model and the
  ``rgb_skip_bicubic`` skip source. ``F.interpolate(mode="bicubic")`` is a
  different kernel and is not a stand-in.
- ``resize_bilinear``: ``F.interpolate(mode="bilinear")`` semantics.

Both are separable: NumPy builds a constant (out, in) matrix per axis from
the static shapes, and the resample is two fp32 matrix products, exactly as
in the JAX package. The matrix builders are this package's own copies. The
matrices come from the per-bucket store (``ops/constants.py``): built and
uploaded on the first call of a shape, read on the device after.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from stif_tpu_torch.ops.constants import constant


def _cubic(x):
    """Keys cubic kernel, a = -0.5 (MATLAB's 'cubic')."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    return (1.5 * ax3 - 2.5 * ax2 + 1.0) * (ax <= 1) + (
        -0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0
    ) * ((ax > 1) & (ax <= 2))


@lru_cache(maxsize=256)
def _matlab_resize_matrix(in_length: int, out_length: int, scale: float,
                          antialiasing: bool) -> np.ndarray:
    """Dense (out_length, in_length) MATLAB-bicubic resample matrix with the
    symmetric boundary folded in."""
    kernel_width = 4.0
    if scale < 1 and antialiasing:
        kernel_width = kernel_width / scale

    x = np.arange(1, out_length + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    P = int(math.ceil(kernel_width)) + 2

    indices = left[:, None] + np.arange(P, dtype=np.float64)[None, :]
    dist = u[:, None] - indices
    if scale < 1 and antialiasing:
        weights = scale * _cubic(dist * scale)
    else:
        weights = _cubic(dist)
    weights = weights / weights.sum(axis=1, keepdims=True)

    # trim all-zero first / last tap columns (MATLAB convention)
    zero_cols = (weights == 0).sum(axis=0)
    if not math.isclose(zero_cols[0], 0, rel_tol=1e-6):
        indices = indices[:, 1:P - 1]
        weights = weights[:, 1:P - 1]
    if not math.isclose(zero_cols[-1], 0, rel_tol=1e-6):
        indices = indices[:, 0:P - 2]
        weights = weights[:, 0:P - 2]

    s = int(-indices.min() + 1)  # symmetric pad length
    padded = (indices + s - 1).astype(np.int64)
    # fold the mirror padding into source indices
    src = np.where(padded < s, s - 1 - padded,
                   np.where(padded < s + in_length, padded - s,
                            in_length - 1 - (padded - s - in_length)))
    M = np.zeros((out_length, in_length), dtype=np.float64)
    rows = np.broadcast_to(np.arange(out_length)[:, None], src.shape)
    np.add.at(M, (rows, src), weights)
    return M.astype(np.float32)


@lru_cache(maxsize=256)
def _bilinear_resize_matrix(in_length: int, out_length: int,
                            align_corners: bool) -> np.ndarray:
    """Dense (out_length, in_length) torch-interpolate bilinear matrix."""
    if align_corners:
        if out_length == 1:
            src = np.zeros(out_length)
        else:
            src = np.arange(out_length) * (in_length - 1) / (out_length - 1)
    else:
        src = (np.arange(out_length) + 0.5) * (in_length / out_length) - 0.5
    # torch clamps the source index below at 0; above, i1 clamps to in-1
    src = np.maximum(src, 0.0)
    i0 = np.minimum(np.floor(src).astype(np.int64), in_length - 1)
    i1 = np.minimum(i0 + 1, in_length - 1)
    frac = src - i0
    M = np.zeros((out_length, in_length), dtype=np.float64)
    o = np.arange(out_length)
    np.add.at(M, (o, i0), 1.0 - frac)
    np.add.at(M, (o, i1), frac)
    return M.astype(np.float32)


def _separable(img: torch.Tensor, builder, args_h, args_w) -> torch.Tensor:
    """Apply the (out_h, in_h) and (out_w, in_w) matrices ``builder`` makes
    from ``args_h`` and ``args_w`` to (..., H, W, C)."""
    mh = constant(builder, *args_h, device=img.device)
    mw = constant(builder, *args_w, device=img.device)
    out = torch.einsum("oh,...hwc->...owc", mh, img)
    return torch.einsum("ow,...hwc->...hoc", mw, out)


def imresize(img: torch.Tensor, scale: float,
             antialiasing: bool = True) -> torch.Tensor:
    """MATLAB bicubic resize of (..., H, W, C) by ``scale``; output dims are
    ``ceil(in * scale)``. fp32 throughout."""
    img = torch.as_tensor(img, dtype=torch.float32)
    in_h, in_w = img.shape[-3], img.shape[-2]
    out_h, out_w = math.ceil(in_h * scale), math.ceil(in_w * scale)
    return _separable(img, _matlab_resize_matrix,
                      (in_h, out_h, scale, antialiasing),
                      (in_w, out_w, scale, antialiasing))


def imresize_to(img: torch.Tensor, out_hw,
                antialiasing: bool = True) -> torch.Tensor:
    """MATLAB bicubic resize of (..., H, W, C) to an explicit
    ``(out_h, out_w)`` with per-dim scales. fp32 throughout."""
    img = torch.as_tensor(img, dtype=torch.float32)
    in_h, in_w = img.shape[-3], img.shape[-2]
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    return _separable(img, _matlab_resize_matrix,
                      (in_h, out_h, out_h / in_h, antialiasing),
                      (in_w, out_w, out_w / in_w, antialiasing))


def resize_bilinear(x: torch.Tensor, size=None, scale_factor=None,
                    align_corners: bool = False) -> torch.Tensor:
    """``F.interpolate(mode='bilinear')`` for channels-last (..., H, W, C).
    ``size`` is (out_h, out_w); or ``scale_factor`` (out = floor(in * sf))."""
    in_h, in_w = x.shape[-3], x.shape[-2]
    if size is None:
        if scale_factor is None:
            raise ValueError("need size or scale_factor")
        size = (int(math.floor(in_h * scale_factor)),
                int(math.floor(in_w * scale_factor)))
    out_h, out_w = size
    out = _separable(x.float(), _bilinear_resize_matrix,
                     (in_h, out_h, align_corners),
                     (in_w, out_w, align_corners))
    return out.to(x.dtype)
