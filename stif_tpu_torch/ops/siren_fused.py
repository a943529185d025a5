"""Fused SIREN MLP (port of ``stif_tpu/ops/siren_pallas.py``).

``siren_apply_fused`` computes what the TPU kernel ``_siren_kernel``
computes: concatenate the input fields, ``h = sin(omega0 * (h W_i + b_i))``
on every layer but the last, which is linear; fp32 throughout. On a CUDA
tensor it launches the hand-written Hopper kernel ``csrc/siren_fused.cu``
(the products on the tensor cores in 3xTF32, the wide concatenated input
and the hidden activations never in device memory) or raises; on a CPU
tensor it computes the plain version, ``siren_apply_fused_plain``. Nothing
falls back from the kernel. The kernel has no backward: on a CUDA tensor it
raises when grad mode is on and an operand requires grad, and on any device
it raises on a DTensor operand (a tensor-parallel weight, whose raw pointer
holds one shard).

The launch geometry is worked out here, by ``launch_plan``: rows per tile,
each layer's tile width (its width rounded up to 8), how its weights are
cut into K-chunks for the kernel's shared-memory ring, and the bytes of
shared memory. The C entry checks the plan again and refuses one it cannot
run. ``siren_apply_fused.launches`` counts the launches and
``siren_apply_fused.tensor_core_layers`` the layers they ran on the tensor
cores (``LaunchPlan.tensor_core_layers`` each).

Fields may be views: any field whose leading dims are broadcast (stride 0,
e.g. ``v.expand(nt, *v.shape)``) ahead of row-major rows with unit column
stride is read in place through a row period, without a copy.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from stif_tpu_torch.ops import capture, cuda_build

_MAX_FIELDS = 8
_MAX_LAYERS = 8
_MAX_WIDTH = 256  # widest layer: the widest tensor-core product
_MAX_IN = 4096    # widest concatenated input row
# the kernel's geometry (csrc/siren_fused.cu)
_TILE_ROWS = 128        # query rows per block: 64 per multiplier warpgroup
_THREADS = 512          # four warpgroups: two split, two multiply
_GROUP = 128            # threads of a warpgroup
_MULTIPLIERS = 2
_STAGE_FLOATS = 2048    # one chunk of weights in the ring
# mbarriers, the weight ring (2 stages), the operand stages (3, hi and lo)
_ACT_OFFSET = 128 + (2 + 3 * 2) * 4 * _STAGE_FLOATS
MAX_SMEM_BYTES = 232448  # dynamic shared memory one block may use on sm_90


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


def _acc_floats(width: int) -> int:
    """The kernel's accumulator floats a thread for a net whose widest tile
    is ``width`` (one of its three compiled sizes)."""
    return 32 if width <= 64 else 64 if width <= 128 else 128


_KB_MAX = {32: 4, 64: 2, 128: 2}  # k-blocks of 8 rows a chunk, by size


def chunk_rows(width: int, widest: int) -> int:
    """Rows of a layer's weights per chunk of the kernel's ring at tile
    width ``width`` in a net whose widest tile is ``widest``: a multiple of
    8 with ``kc * width <= 2048`` floats, at most 8 k-blocks' worth of what
    the net's accumulator size leaves registers for."""
    return min(_STAGE_FLOATS // width // 8 * 8,
               8 * _KB_MAX[_acc_floats(widest)])


@dataclass(frozen=True)
class LaunchPlan:
    """Launch geometry of the fused kernel for one net.

    ``pitch[l]`` is the width of layer l's tensor-core tile, the layer's
    width rounded up to 8; ``kc[l]`` the rows of its weight matrix per
    chunk of the ring. The first layer streams its input in chunks of
    ``kc[0]`` columns of the concatenated row."""

    tile_rows: int
    threads: int
    pitch: Tuple[int, ...]
    kc: Tuple[int, ...]
    smem_bytes: int

    @property
    def tensor_core_layers(self) -> int:
        """Layers whose products run on the tensor cores: every one."""
        return len(self.pitch)

    def flat(self):
        """The plan as the C entry reads it (see ``siren_fused_forward``)."""
        out = [self.tile_rows, self.threads, self.smem_bytes]
        for pitch, kc in zip(self.pitch, self.kc):
            out += [pitch, kc]
        return out


def launch_plan(splits: Sequence[int], dims: Sequence[int]) -> LaunchPlan:
    """The kernel's launch plan for fields of widths ``splits`` and layer
    widths ``dims`` (input width first). Raises ``ValueError`` for a net
    the kernel does not take."""
    splits, dims = list(splits), list(dims)
    if not 1 <= len(splits) <= _MAX_FIELDS or min(splits) < 1:
        raise ValueError(f"siren_apply_fused: 1..{_MAX_FIELDS} fields of "
                         f"width >= 1, got {splits}")
    if not 2 <= len(dims) <= _MAX_LAYERS + 1 or sum(splits) != dims[0]:
        raise ValueError(f"siren_apply_fused: 1..{_MAX_LAYERS} layers after "
                         f"an input of width {sum(splits)}, got {dims}")
    if dims[0] > _MAX_IN:
        raise ValueError(f"siren_apply_fused: input width {dims[0]} > "
                         f"{_MAX_IN}")
    pitch = []
    for n in dims[1:]:
        if not 1 <= n <= _MAX_WIDTH:
            raise ValueError(f"siren_apply_fused: layer width {n} outside "
                             f"1..{_MAX_WIDTH}")
        pitch.append(-(-n // 8) * 8)
    widest = max(pitch)
    kc = [chunk_rows(p, widest) for p in pitch]
    # activations: per multiplier thread one 16-byte slot for each 8
    # columns of the widest layer, and at least one per field (the first
    # layer's source-row offsets)
    slots = max([len(splits)] + [p // 8 for p in pitch])
    smem = _ACT_OFFSET + _MULTIPLIERS * slots * _GROUP * 16
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"siren_apply_fused: {smem} bytes of shared memory")
    return LaunchPlan(_TILE_ROWS, _THREADS, tuple(pitch), tuple(kc), smem)


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
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int), ctypes.c_int, vp,
                       ctypes.c_longlong, ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return fn


def blocks_per_sm(plan: LaunchPlan) -> int:
    """Blocks of the kernel one SM holds under ``plan`` (the CUDA occupancy
    calculator's answer; builds the kernel if needed)."""
    fn = cuda_build.load("siren_fused").siren_fused_blocks_per_sm
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    n = fn(plan.smem_bytes, max(plan.pitch))
    if n < 0:
        raise RuntimeError(f"siren_fused occupancy query: CUDA error {-n}")
    return n


def is_dtensor(t) -> bool:
    """Whether ``t`` is a ``torch.distributed`` DTensor."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def siren_apply_fused(x, weights: Sequence[torch.Tensor],
                      biases: Sequence[torch.Tensor],
                      omega0: float = 30.0) -> torch.Tensor:
    """Fused SIREN forward. Same arguments and result as
    ``siren_apply_fused_plain``; on CUDA tensors it runs the kernel."""
    xs = _as_fields(x)
    if any(is_dtensor(t) for t in xs + list(weights) + list(biases)):
        # a sharded weight's pointer holds one shard of its columns: the
        # kernel would read past it or compute a slice as if it were whole
        raise RuntimeError(
            "siren_apply_fused: an operand is a DTensor (tensor-parallel "
            "layer); the fused kernel reads whole tensors through raw "
            "pointers. apply_tensor_parallel turns the kernel off in the "
            "nets it shards.")
    dev = xs[0].device
    if dev.type == "cpu":
        return siren_apply_fused_plain(xs, weights, biases, omega0)
    if dev.type != "cuda":
        raise ValueError(f"siren_apply_fused: unsupported device {dev}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in xs + list(weights) + list(biases)):
        # the output is written through ctypes and has no autograd history:
        # running here would silently cut every gradient upstream of the net
        raise RuntimeError(
            "siren_apply_fused: the fused kernel has no backward (nor has "
            "the Pallas kernel it ports); call it under torch.no_grad() / "
            "inference_mode() or on tensors that do not require grad. "
            "Training builds its SIREN nets with fused=False.")

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
        dims.append(w.shape[1])
    plan = launch_plan([v.shape[-1] for v in xs], dims)

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
    flat = plan.flat()
    cplan = (ctypes.c_int * len(flat))(*flat)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(len(xs), field_ptrs, meta, len(weights), w_ptrs, b_ptrs,
                 cdims, cplan, len(flat), out.data_ptr(), q, omega0, stream)
    if err != 0:
        raise RuntimeError(f"siren_fused kernel launch failed: CUDA error {err}")
    capture.launched(siren_apply_fused,
                     tensor_core_layers=plan.tensor_core_layers)
    return out.reshape(*lead, dims[-1])


siren_apply_fused.launches = 0
# layers run on the tensor cores, summed over the launches
siren_apply_fused.tensor_core_layers = 0
