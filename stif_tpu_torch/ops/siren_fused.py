"""Fused SIREN MLP (port of ``stif_tpu/ops/siren_pallas.py``).

``siren_apply_fused`` computes what the TPU kernel ``_siren_kernel``
computes: concatenate the input fields, ``h = sin(omega0 * (h W_i + b_i))``
on every layer but the last, which is linear; fp32 throughout. On a CUDA
tensor it launches the hand-written Hopper kernel ``csrc/siren_fused.cu``
(the wide concatenated input and the hidden activations stay in shared
memory) or raises; on a CPU tensor it computes the plain version,
``siren_apply_fused_plain``. Nothing falls back from the kernel.

Fields may be views: any field whose leading dims are broadcast (stride 0,
e.g. ``v.expand(nt, *v.shape)``) ahead of row-major rows with unit column
stride is read in place through a row period, without a copy.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch

from stif_tpu_torch.ops import cuda_build

_MAX_FIELDS = 8
_MAX_LAYERS = 8
_MAX_WIDTH = 256  # widest layer output the kernel's thread mapping takes


def _as_fields(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def siren_apply_fused_plain(x, weights: Sequence[torch.Tensor],
                            biases: Sequence[torch.Tensor],
                            omega0: float = 30.0) -> torch.Tensor:
    """Plain PyTorch SIREN forward: ``torch.cat`` the fields, then
    ``x @ W + b`` and ``sin(omega0 * .)`` per layer, the last layer linear.
    x: (..., Cin) or a list of (..., c_i) sharing leading dims;
    weights[i]: (Cin_i, Cout_i); biases[i]: (Cout_i,)."""
    h = torch.cat(_as_fields(x), dim=-1)
    n = len(weights)
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = h @ w + b
        if i < n - 1:
            h = torch.sin(omega0 * h)
    return h


def _field_layout(v: torch.Tensor, q: int) -> Tuple[int, int, int]:
    """(width, row_stride, period) of a field read as ``q`` logical rows:
    logical row r is source row r % period at ``data_ptr + row * stride``."""
    width = v.shape[-1]
    if v.stride(-1) != 1 and width > 1:
        raise ValueError("siren_apply_fused: a field needs unit column "
                         f"stride, got strides {tuple(v.stride())}")
    dims = [(n, s) for n, s in zip(v.shape[:-1], v.stride()[:-1]) if n != 1]
    while dims and dims[0][1] == 0:  # broadcast outer dims: rows repeat
        dims.pop(0)
    period = math.prod(n for n, _ in dims)
    row_stride = dims[-1][1] if dims else width
    for (n0, s0), (n1, s1) in zip(dims, dims[1:]):
        if s0 != s1 * n1:
            raise ValueError("siren_apply_fused: a field's rows must be "
                             "evenly strided after its broadcast dims, got "
                             f"shape {tuple(v.shape)} strides {tuple(v.stride())}")
    if period == 0 or q % period:
        raise ValueError("siren_apply_fused: bad field period")
    return width, row_stride, period


def _library():
    lib = cuda_build.load("siren_fused")
    fn = lib.siren_fused_forward
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(vp),
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                       ctypes.POINTER(vp), ctypes.POINTER(vp),
                       ctypes.POINTER(ctypes.c_int), vp, ctypes.c_longlong,
                       ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return fn


def siren_apply_fused(x, weights: Sequence[torch.Tensor],
                      biases: Sequence[torch.Tensor],
                      omega0: float = 30.0) -> torch.Tensor:
    """Fused SIREN forward. Same arguments and result as
    ``siren_apply_fused_plain``; on CUDA tensors it runs the kernel."""
    xs = _as_fields(x)
    dev = xs[0].device
    if dev.type == "cpu":
        return siren_apply_fused_plain(xs, weights, biases, omega0)
    if dev.type != "cuda":
        raise ValueError(f"siren_apply_fused: unsupported device {dev}")

    lead = xs[0].shape[:-1]
    if not 1 <= len(xs) <= _MAX_FIELDS:
        raise ValueError(f"siren_apply_fused: 1..{_MAX_FIELDS} fields")
    if not 1 <= len(weights) <= _MAX_LAYERS or len(biases) != len(weights):
        raise ValueError(f"siren_apply_fused: 1..{_MAX_LAYERS} layers")
    tensors = xs + list(weights) + list(biases)
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError("siren_apply_fused: every input must be float32 "
                             f"on {dev}, got {t.dtype} on {t.device}")
    for v in xs:
        if v.shape[:-1] != lead:
            raise ValueError("siren_apply_fused: fields must share leading "
                             f"dims, got {[tuple(v.shape) for v in xs]}")
    dims = [sum(v.shape[-1] for v in xs)]
    for w, b in zip(weights, biases):
        if w.dim() != 2 or w.shape[0] != dims[-1] or b.shape != w.shape[1:]:
            raise ValueError("siren_apply_fused: layer shapes do not chain: "
                             f"{tuple(w.shape)}, {tuple(b.shape)} after "
                             f"width {dims[-1]}")
        if not (w.is_contiguous() and b.is_contiguous()
                and w.data_ptr() % 16 == 0):
            raise ValueError("siren_apply_fused: weights and biases must be "
                             "contiguous, weights 16-byte aligned")
        if w.shape[1] > _MAX_WIDTH:
            raise ValueError(f"siren_apply_fused: layer width {w.shape[1]} "
                             f"> {_MAX_WIDTH}")
        dims.append(w.shape[1])

    q = math.prod(lead)
    out = torch.empty((q, dims[-1]), device=dev, dtype=torch.float32)
    if q == 0:
        return out.reshape(*lead, dims[-1])
    layouts = [_field_layout(v, q) for v in xs]
    fn = _library()
    vp = ctypes.c_void_p
    field_ptrs = (vp * len(xs))(*[v.data_ptr() for v in xs])
    meta = (ctypes.c_longlong * (3 * len(xs)))(
        *[m for lay in layouts for m in lay])
    w_ptrs = (vp * len(weights))(*[w.data_ptr() for w in weights])
    b_ptrs = (vp * len(biases))(*[b.data_ptr() for b in biases])
    cdims = (ctypes.c_int * len(dims))(*dims)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(len(xs), field_ptrs, meta, len(weights), w_ptrs, b_ptrs,
                 cdims, out.data_ptr(), q, omega0, stream)
    if err != 0:
        raise RuntimeError(f"siren_fused kernel launch failed: CUDA error {err}")
    siren_apply_fused.launches += 1
    return out.reshape(*lead, dims[-1])


siren_apply_fused.launches = 0
