"""Channels-last ``grid_sample`` (port of ``stif_tpu/ops/grid_sample.py``).

The JAX module re-implements ``torch.nn.functional.grid_sample`` for the TPU;
its parity target is that op. Modes ``nearest`` / ``bilinear``, padding
``zeros`` / ``border``, both ``align_corners`` conventions. Nearest rounds
half to even, as both do.

On a CPU tensor the op is the plain version, ``grid_sample_plain``: a thin
NHWC wrapper over ``F.grid_sample``. On a CUDA tensor it launches the
hand-written kernel ``csrc/grid_sample.cu``, which reads the channels-last
source in place and writes the channels-last result once, with ATen's
arithmetic, or raises: nothing falls back from the kernel. The kernel is
the forward of an ``autograd.Function`` whose backward is ATen's
``grid_sampler_2d_backward``, the call that ``F.grid_sample``'s own
backward makes; with grad off, or no operand that requires grad, the
Function records nothing.

``grid_sample.launches`` counts the kernel's launches (a captured graph's
replays add theirs, ``ops/capture.py``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from stif_tpu_torch.ops import capture, cuda_build
from stif_tpu_torch.ops.precision import round_to

_MODES = {"bilinear": 0, "nearest": 1}  # ATen's GridSamplerInterpolation
_PADDINGS = {"zeros": 0, "border": 1}   # ATen's GridSamplerPadding


def grid_sample_plain(x: torch.Tensor, grid: torch.Tensor,
                      mode: str = "bilinear", padding_mode: str = "zeros",
                      align_corners: bool = False) -> torch.Tensor:
    """``F.grid_sample`` on the channels-first view of ``x`` (B, H, W, C),
    its result made channels-last: (B, Hg, Wg, C), or (B, Q, C) for a flat
    (B, Q, 2) grid, contiguous."""
    flat = grid.dim() == 3
    g = grid[:, :, None, :] if flat else grid
    out = F.grid_sample(x.permute(0, 3, 1, 2), g.to(x.dtype), mode=mode,
                        padding_mode=padding_mode,
                        align_corners=align_corners)
    out = out.permute(0, 2, 3, 1)
    if flat:
        out = out[:, :, 0, :]
    return out.contiguous()


def launch_plan(c: int, strides, pointers) -> Tuple[int, int]:
    """(floats per vector, lanes per query) of the kernel for rows of ``c``
    channels: the widest vector of 4, 2 or 1 floats that divides ``c`` and
    every element stride in ``strides`` and whose bytes divide every address
    in ``pointers``; then the fewest lanes, a power of two from 4 to 32,
    that cover a row's vectors in at most 2 steps (on the H100, within
    0.02 ms of the fastest lane count at each of the decoder's gathers)."""
    for vec in (4, 2, 1):
        if (c % vec == 0 and all(s % vec == 0 for s in strides)
                and all(p % (4 * vec) == 0 for p in pointers)):
            break
    group = 4
    while group < 32 and group * 2 < -(-c // vec):
        group *= 2
    return vec, group


def _library():
    fn = cuda_build.load("grid_sample").grid_sample_forward
    if fn.argtypes is None:
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [vp, ll, ll, ll, i, i, i, vp, ll, ll, ll, i, ll, vp,
                       i, i, i, i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def _gather(x: torch.Tensor, grid: torch.Tensor, mode: str,
            padding_mode: str, align_corners: bool) -> torch.Tensor:
    """The kernel's launch: ``x`` (B, H, W, C), ``grid`` (B, Hg, Wg, 2) or
    (B, Q, 2), both float32 on one card."""
    dev = x.device
    if x.dtype != torch.float32 or grid.dtype != torch.float32:
        raise ValueError("grid_sample: the kernel takes float32, got "
                         f"{x.dtype} and {grid.dtype}")
    if grid.device != dev:
        raise ValueError(f"grid_sample: grid on {grid.device}, source on "
                         f"{dev}")
    if x.dim() != 4 or grid.dim() not in (3, 4) or grid.shape[-1] != 2 \
            or grid.shape[0] != x.shape[0]:
        raise ValueError("grid_sample: x (B, H, W, C) and a grid (B, Hg, Wg, "
                         f"2) or (B, Q, 2), got {tuple(x.shape)} and "
                         f"{tuple(grid.shape)}")
    B, H, W, C = x.shape
    if C > 1 and x.stride(3) != 1:
        raise ValueError("grid_sample: the kernel reads a source with unit "
                         f"channel stride, got strides {tuple(x.stride())}")
    if H == 0 or W == 0:
        raise ValueError(f"grid_sample: an empty source {tuple(x.shape)}")
    out = torch.empty(*grid.shape[:-1], C, device=dev, dtype=torch.float32)
    g = grid.reshape(B, -1, 2)
    Q = g.shape[1]
    if B == 0 or Q == 0 or C == 0:
        return out
    if B > 65535:
        raise ValueError(f"grid_sample: a batch of {B} > 65535")
    # a stride of a dim of size 1 is never stepped: read it as 0
    s_n, s_h, s_w = (s if n > 1 else 0
                     for n, s in zip(x.shape[:3], x.stride()[:3]))
    vec, group = launch_plan(C, (s_n, s_h, s_w),
                             (x.data_ptr(), out.data_ptr()))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library()(x.data_ptr(), s_n, s_h, s_w, H, W, C, g.data_ptr(),
                         *g.stride(), B, Q, out.data_ptr(), _MODES[mode],
                         _PADDINGS[padding_mode], int(align_corners), vec,
                         group.bit_length() - 1, stream)
    if err != 0:
        raise RuntimeError(f"grid_sample kernel launch failed: CUDA error "
                           f"{err}")
    capture.launched(grid_sample)
    return out


class _GatherFn(torch.autograd.Function):
    """The kernel forward, ATen's ``grid_sampler_2d_backward``."""

    @staticmethod
    def forward(ctx, x, grid, mode, padding_mode, align_corners):
        ctx.save_for_backward(x, grid)
        ctx.args = (_MODES[mode], _PADDINGS[padding_mode], align_corners)
        return _gather(x, grid, mode, padding_mode, align_corners)

    @staticmethod
    def backward(ctx, grad):
        x, grid = ctx.saved_tensors
        flat = grid.dim() == 3
        g = grid[:, :, None, :] if flat else grid
        go = grad[:, :, None, :] if flat else grad
        gx, gg = torch.ops.aten.grid_sampler_2d_backward(
            go.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), g, *ctx.args,
            list(ctx.needs_input_grad[:2]))
        if gx is not None:
            gx = gx.permute(0, 2, 3, 1)
        if gg is not None and flat:
            gg = gg[:, :, 0, :]
        # ATen's CUDA backward computes the grid's gradient whatever the mask
        return (gx, gg if ctx.needs_input_grad[1] else None, None, None,
                None)


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
    if mode not in _MODES:
        raise ValueError(f"unsupported mode: {mode}")
    if padding_mode not in _PADDINGS:
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    if mode == "bilinear":
        x = round_to(x, source_dtype)
    if x.device.type == "cpu":
        return grid_sample_plain(x, grid, mode, padding_mode, align_corners)
    if x.device.type != "cuda":
        raise ValueError(f"grid_sample: unsupported device {x.device}")
    grid = grid.to(x.dtype)  # as the plain version does
    return _GatherFn.apply(x, grid, mode, padding_mode, align_corners)


grid_sample.launches = 0
