"""Modulated deformable convolution, DCNv2 (port of
``stif_tpu/ops/deform_conv.py``).

Per-tap learned (dy, dx) offsets shared by each deformable group's
channels, bilinear sampling with zero padding per corner (a corner outside
the image contributes 0), a sigmoid mask, then one dense contraction with
the conv weight over (K taps x Cin).

The op is one ``torch.autograd.Function``. On a CUDA tensor its forward is
one launch of the hand-written Hopper kernel ``dcn_forward``
(``csrc/deform_conv.cu``): it samples each tap's slab of the column matrix
into shared memory and contracts it with the weight on the tensor cores
(3xTF32), so the column matrix (B*Ho*Wo, K*Cin), 35 MB at the encoder's
largest call, is never written. Its backward is ``dcn_backward``: per tap the
grad-columns (grad_out x W^T) in shared memory, grad x by fp32 atomics,
grad offset and mask from the same corner reads, and the weight's gradient
from the re-sampled slab, summed over pixel tiles in a fixed order. On a CPU
tensor the same functions are the plain versions here,
``dcn_forward_plain`` and ``dcn_backward_plain`` (built from
``dcn_im2col_plain``, ``dcn_col2im_plain`` and matrix products). Nothing
falls back from a kernel: on a CUDA tensor the op launches or raises.
``launch_plan`` works out each kernel's tiles, grid, channel padding and
shared memory; the C entries check it again. The JAX package writes this op
in XLA gathers with a custom VJP for the gather's transpose; it has no
Pallas kernel for it.

``impl`` follows the JAX package's switch (``set_dcn_impl`` for
``impl="auto"`` call sites):

* ``"patch"``: exact reads for any offsets;
* ``"window"``: on the TPU a tap-clustered gather layout with an exact
  fallback, so the same values as ``"patch"``; here it is ``"patch"``: the
  window gather is not ported;
* ``"dense"``: the JAX package's gather-free shift contraction, exact iff
  every sample lies within ``shift_bound`` pixels of its query
  (``dcn_shift_stats``); beyond it each corner's read index is clamped to
  the bound, its weight kept. Same kernels, given the bound. It needs
  stride 1 and same-size queries: ``"auto"`` falls back to ``"patch"``
  otherwise, a named ``"dense"`` raises.

``gather_dtype`` rounds the sampled source x (``round_to``) ahead of the
op; offsets, weights, mask and the contraction stay fp32. (The JAX
package's ``"dense"`` with a ``gather_dtype`` also rounds its one-hot
column weights to it; here only x is rounded.)
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
from torch.autograd.function import once_differentiable

from stif_tpu_torch.ops import capture, cuda_build
from stif_tpu_torch.ops.precision import round_to

IntPair = Union[int, Tuple[int, int]]

# Module-wide defaults of impl="auto" call sites (``set_dcn_impl``).
_DEFAULT_IMPL = "patch"
_DEFAULT_SHIFT_BOUND = None  # None: each call site's shift_bound
_DEFAULT_WINDOW = (8, 8)     # kept for the JAX package's API; no effect here
IMPLS = ("patch", "dense", "window")
_META = 29  # longs the C entries read (csrc/deform_conv.cu)
_ROUTE_EPOCHS = {}  # ``set_dcn_impl``'s epochs (``ops/capture.py``)


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def set_dcn_impl(impl: str, shift_bound: int = None, window=None) -> None:
    """Set the implementation of ``impl="auto"`` DCN calls: ``"patch"``,
    ``"dense"`` or ``"window"``. ``shift_bound`` overrides every auto call
    site's bound (check it with ``dcn_shift_stats`` first); ``window`` sets
    the JAX package's (Wy, Wx) tap-cluster window, which changes nothing
    here. A change makes a new program key (``ops/capture.py``)."""
    global _DEFAULT_IMPL, _DEFAULT_SHIFT_BOUND, _DEFAULT_WINDOW
    if impl not in IMPLS:
        raise ValueError(f"set_dcn_impl: impl must be one of {IMPLS}, "
                         f"got {impl!r}")
    before = (_DEFAULT_IMPL, _DEFAULT_SHIFT_BOUND)
    _DEFAULT_IMPL = impl
    _DEFAULT_SHIFT_BOUND = shift_bound
    if window is not None:
        _DEFAULT_WINDOW = (int(window[0]), int(window[1]))
    capture.switched(_ROUTE_EPOCHS, before, (impl, shift_bound))


def dcn_route() -> tuple:
    """The process-wide part of a program's key (``ops/capture.py``): the
    defaults of ``impl="auto"`` DCN calls and their epoch."""
    flags = (_DEFAULT_IMPL, _DEFAULT_SHIFT_BOUND)
    return flags, _ROUTE_EPOCHS.get(flags, 0)


def split_offset_mask(conv_out: torch.Tensor, deformable_groups: int,
                      kernel_size: IntPair = 3):
    """Split a raw ``conv_offset_mask`` output (B, H, W, 3*G*K) into
    offset (B, H, W, G, K, 2) — ``concat(o1, o2)`` read per group as
    interleaved (dy, dx) pairs per tap, a strided view of ``conv_out`` —
    and sigmoid mask (B, H, W, G, K)."""
    kh, kw = _pair(kernel_size)
    K = kh * kw
    G = deformable_groups
    B, H, W, _ = conv_out.shape
    offset = conv_out[..., :2 * G * K].reshape(B, H, W, G, K, 2)
    mask = torch.sigmoid(conv_out[..., 2 * G * K:].reshape(B, H, W, G, K))
    return offset, mask


def dcn_shift_stats(offset: torch.Tensor, kernel_size: IntPair = 3,
                    dilation: IntPair = 1) -> torch.Tensor:
    """Max |shift| a dense DCN needs for these offsets (B, H, W, G, K, 2):
    the scalar max over |dy + tap| and |dx + tap|, plus 1. ``impl="dense"``
    with ``shift_bound`` at least this is exact."""
    kh, kw = _pair(kernel_size)
    dh, dw = _pair(dilation)
    f32 = torch.float32
    ti = (torch.arange(kh, dtype=f32) * dh - (kh // 2) * dh).repeat_interleave(kw)
    tj = (torch.arange(kw, dtype=f32) * dw - (kw // 2) * dw).repeat(kh)
    ti, tj = ti.to(offset.device), tj.to(offset.device)
    dy = (offset[..., 0] + ti).abs()
    dx = (offset[..., 1] + tj).abs()
    return torch.maximum(dy.max(), dx.max()) + 1.0


# ------------------------------------------------------------ plain versions

class _Geometry:
    """Shapes and conv geometry of one call."""

    def __init__(self, x, offset, kernel_size, stride, padding, dilation,
                 shift_bound):
        self.B, self.H, self.W, self.Cin = x.shape
        self.kh, self.kw = _pair(kernel_size)
        self.K = self.kh * self.kw
        self.Ho, self.Wo, self.G = offset.shape[1], offset.shape[2], offset.shape[3]
        self.sh, self.sw = _pair(stride)
        self.ph, self.pw = _pair(padding)
        self.dh, self.dw = _pair(dilation)
        self.S = shift_bound
        if self.G <= 0 or self.Cin % self.G:
            raise ValueError(f"deform_conv2d: Cin {self.Cin} is not a "
                             f"multiple of {self.G} groups")
        self.CpG = self.Cin // self.G
        want_off = (self.B, self.Ho, self.Wo, self.G, self.K, 2)
        if tuple(offset.shape) != want_off:
            raise ValueError(f"deform_conv2d: offset shape "
                             f"{tuple(offset.shape)}, expected {want_off}")
        if shift_bound is not None and (
                (self.sh, self.sw) != (1, 1)
                or (self.Ho, self.Wo) != (self.H, self.W)):
            raise ValueError("deform_conv2d: a shift bound (impl='dense') "
                             "needs stride-1 same-size queries")

    @property
    def Q(self):
        return self.Ho * self.Wo

    def meta(self, offset, mask, cout):
        m = [self.B, self.H, self.W, self.Cin, self.G, self.Ho, self.Wo,
             self.kh, self.kw, self.sh, self.sw, self.ph, self.pw, self.dh,
             self.dw, -1 if self.S is None else int(self.S), cout]
        m += list(offset.stride()) + list(mask.stride()) + [_META]
        return (ctypes.c_longlong * _META)(*m)


def _axis(p, n: int, q, S):
    """One axis of the bilinear samples at positions ``p``: the corner
    weights (0 outside the map), their derivatives in ``p`` (-1 and +1, 0
    outside), and their read indices, in range and, with a shift bound
    ``S``, clamped to [q - S, q + S] around query index ``q``."""
    f = torch.floor(p)
    l = p - f
    i0 = f.clamp(-2, n).long()  # outside stays outside
    i1 = i0 + 1
    v0 = ((i0 >= 0) & (i0 < n)).to(p.dtype)
    v1 = ((i1 >= 0) & (i1 < n)).to(p.dtype)
    r0, r1 = i0.clamp(0, n - 1), i1.clamp(0, n - 1)
    if S is not None:
        r0 = torch.minimum(torch.maximum(r0, q - S), q + S)
        r1 = torch.minimum(torch.maximum(r1, q - S), q + S)
    return (v0 * (1 - l), v1 * l), (-v0, v1), (r0, r1)


def _samples(geo: _Geometry, offset, mask, device):
    """Per (b, q, g, k): the y and x axes (``_axis``) and the mask, each
    (B, Q, G, K)."""
    f32 = torch.float32
    ho = torch.arange(geo.Ho, device=device)
    wo = torch.arange(geo.Wo, device=device)
    ti = (torch.arange(geo.kh, device=device) * geo.dh).repeat_interleave(geo.kw)
    tj = (torch.arange(geo.kw, device=device) * geo.dw).repeat(geo.kh)
    shape = (geo.Ho, geo.Wo, geo.K)
    base_y = (ho[:, None, None] * geo.sh - geo.ph + ti).expand(shape)
    base_x = (wo[None, :, None] * geo.sw - geo.pw + tj).expand(shape)
    base_y = base_y.reshape(1, geo.Q, 1, geo.K).to(f32)
    base_x = base_x.reshape(1, geo.Q, 1, geo.K).to(f32)
    q_y = ho[:, None].expand(geo.Ho, geo.Wo).reshape(1, geo.Q, 1, 1)
    q_x = wo[None, :].expand(geo.Ho, geo.Wo).reshape(1, geo.Q, 1, 1)
    off = offset.reshape(geo.B, geo.Q, geo.G, geo.K, 2)
    ay = _axis(base_y + off[..., 0], geo.H, q_y, geo.S)
    ax = _axis(base_x + off[..., 1], geo.W, q_x, geo.S)
    return ay, ax, mask.reshape(geo.B, geo.Q, geo.G, geo.K)


def _corners(geo: _Geometry, ay, ax):
    """The four corners 00, 01, 10, 11: (y weight, x weight, y derivative,
    x derivative, flat pixel index into H*W), each (B, Q, G, K)."""
    (wy, dy, ry), (wx, dx, rx) = ay, ax
    return [(wy[a], wx[b], dy[a], dx[b], ry[a] * geo.W + rx[b])
            for a in (0, 1) for b in (0, 1)]


def _gather(xf, idx, geo: _Geometry):
    """x's group channels at flat pixel ``idx``: (B, Q, G, K, CpG)."""
    bi = torch.arange(geo.B, device=xf.device)[:, None, None, None]
    gi = torch.arange(geo.G, device=xf.device)[None, None, :, None]
    return xf[bi, idx, gi]


def dcn_im2col_plain(x, offset, mask, kernel_size: IntPair = 3,
                     stride: IntPair = 1, padding: IntPair = 1,
                     dilation: IntPair = 1,
                     shift_bound: Optional[int] = None) -> torch.Tensor:
    """The column matrix (B*Ho*Wo, K*Cin), k-major then Cin: each tap's
    four-corner bilinear sample of x times the mask (plain PyTorch,
    differentiable by autograd). x: (B, H, W, Cin); offset (B, Ho, Wo, G,
    K, 2) (dy, dx); mask (B, Ho, Wo, G, K); ``shift_bound`` None: exact
    reads; an int: the ``impl="dense"`` clamp."""
    geo = _Geometry(x, offset, kernel_size, stride, padding, dilation,
                    shift_bound)
    ay, ax, m = _samples(geo, offset, mask, x.device)
    xf = x.reshape(geo.B, geo.H * geo.W, geo.G, geo.CpG)
    col = 0
    for wy, wx, _, _, idx in _corners(geo, ay, ax):
        col = col + _gather(xf, idx, geo) * (wy * wx * m)[..., None]
    # (B, Q, G, K, CpG) -> (B*Q, K*Cin)
    return col.permute(0, 1, 3, 2, 4).reshape(geo.B * geo.Q, geo.K * geo.Cin)


def dcn_col2im_plain(grad_cols, x, offset, mask, kernel_size: IntPair = 3,
                     stride: IntPair = 1, padding: IntPair = 1,
                     dilation: IntPair = 1,
                     shift_bound: Optional[int] = None):
    """The backward of ``dcn_im2col_plain`` from the grad-columns (B*Ho*Wo,
    K*Cin): (grad x (B, H, W, Cin), by ``index_add_`` into each corner's
    read; grad offset (B, Ho, Wo, G, K, 2); grad mask (B, Ho, Wo, G, K)).
    With ``dot`` the sum over a group's channels of grad-col x corner value:
    grad mask = the sum over corners of weight x dot; grad dy (dx) = mask x
    the sum of dot x the corner weight differentiated in y (x)."""
    geo = _Geometry(x, offset, kernel_size, stride, padding, dilation,
                    shift_bound)
    ay, ax, m = _samples(geo, offset, mask, x.device)
    B, Q, G, K, CpG = geo.B, geo.Q, geo.G, geo.K, geo.CpG
    gcol = grad_cols.reshape(B, Q, K, G, CpG).permute(0, 1, 3, 2, 4)
    xf = x.reshape(B, geo.H * geo.W, G, CpG)
    gx = torch.zeros(B * geo.H * geo.W * G, CpG, dtype=x.dtype,
                     device=x.device)
    bi = torch.arange(B, device=x.device)[:, None, None, None]
    gi = torch.arange(G, device=x.device)[None, None, :, None]
    g_mask = g_y = g_x = 0
    for wy, wx, dy, dx, idx in _corners(geo, ay, ax):
        dot = (gcol * _gather(xf, idx, geo)).sum(-1)
        rows = ((bi * (geo.H * geo.W) + idx) * G + gi).reshape(-1)
        gx.index_add_(0, rows,
                      (gcol * (wy * wx * m)[..., None]).reshape(-1, CpG))
        g_mask = g_mask + wy * wx * dot
        g_y = g_y + dy * wx * dot
        g_x = g_x + wy * dx * dot
    g_off = torch.stack([g_y * m, g_x * m], -1)
    return (gx.reshape(B, geo.H, geo.W, geo.Cin),
            g_off.reshape(B, geo.Ho, geo.Wo, G, K, 2),
            g_mask.reshape(B, geo.Ho, geo.Wo, G, K))


def _weight_rows(weight):
    """OIHW (Cout, Cin, kh, kw) as the (K*Cin, Cout) matrix of the columns'
    layout."""
    Cout, Cin, kh, kw = weight.shape
    return weight.permute(2, 3, 1, 0).reshape(kh * kw * Cin, Cout)


def dcn_forward_plain(x, offset, mask, weight, bias=None,
                      stride: IntPair = 1, padding: IntPair = 1,
                      dilation: IntPair = 1,
                      shift_bound: Optional[int] = None) -> torch.Tensor:
    """The op's forward in plain PyTorch: the columns
    (``dcn_im2col_plain``) times the weight by one ``addmm``. x: (B, H, W,
    Cin); offset (B, Ho, Wo, G, K, 2); mask (B, Ho, Wo, G, K); weight OIHW
    (Cout, Cin, kh, kw); bias (Cout,) or None. Returns (B, Ho, Wo, Cout)."""
    Cout, _, kh, kw = weight.shape
    cols = dcn_im2col_plain(x, offset, mask, (kh, kw), stride, padding,
                            dilation, shift_bound)
    wr = _weight_rows(weight)
    out = cols @ wr if bias is None else torch.addmm(bias, cols, wr)
    return out.reshape(*offset.shape[:3], Cout)


def dcn_backward_plain(grad_out, x, offset, mask, weight,
                       stride: IntPair = 1, padding: IntPair = 1,
                       dilation: IntPair = 1,
                       shift_bound: Optional[int] = None):
    """The op's backward in plain PyTorch from grad_out (B, Ho, Wo, Cout):
    (grad x, grad offset, grad mask, grad weight OIHW) by the grad-columns
    (``grad_out @ W^T``), ``dcn_col2im_plain`` and the columns built again
    for the weight's gradient. The bias's gradient is ``grad_out``'s sum."""
    Cout, Cin, kh, kw = weight.shape
    g = grad_out.reshape(-1, Cout)
    wr = _weight_rows(weight)
    gx, goff, gmask = dcn_col2im_plain(g @ wr.t(), x, offset, mask, (kh, kw),
                                       stride, padding, dilation, shift_bound)
    cols = dcn_im2col_plain(x, offset, mask, (kh, kw), stride, padding,
                            dilation, shift_bound)
    gw = (cols.t() @ g).reshape(kh, kw, Cin, Cout).permute(3, 2, 0, 1)
    return gx, goff, gmask, gw


# ------------------------------------------------------------------ kernels

# the kernels' geometry (csrc/deform_conv.cu)
FORWARD_ROWS, FORWARD_THREADS = 128, 512  # output pixels per tile, threads
SMS = 132          # streaming multiprocessors of an H100 SXM
BACKWARD_ROWS, BACKWARD_THREADS = 64, 256
TILE_N = 64        # output channels per tile
MAX_CHUNK = 64     # input channels per chunk
MAX_RUN = 576      # weights per output channel of a chunk (64 x 3 x 3)
MAX_TAPS = 72
_LD_A, _LD_WB, _LD_G, _LD_S = 68, 68, 72, 72  # shared row pitches (floats)
BACKWARD_SMEM = 16 + 4 * (MAX_CHUNK * _LD_WB + BACKWARD_ROWS * _LD_G
                          + BACKWARD_ROWS * _LD_A + BACKWARD_ROWS * _LD_S)
TARGET_BLOCKS = 3 * SMS  # backward: about three blocks per SM


def _round8(n: int) -> int:
    return (n + 7) // 8 * 8


@dataclass(frozen=True)
class DcnPlan:
    """Launch geometry of ``dcn_forward`` or ``dcn_backward`` for one call.

    A tile is ``tile_rows`` output pixels; input channels go in chunks of
    ``chunk`` (whole groups, at most 64 channels and 576 weights per output
    channel), padded with zeros to ``chunk_pad`` (the tensor cores' 8) in
    shared memory; output channels in ``n_col_tiles`` tiles of 64. The
    forward's grid is (pixel tiles, column tiles), its weight tile
    ``weight_pitch`` floats per output channel (the padded chunk's taps).
    The backward's grid is (parts, taps x chunks x column tiles), each block
    walking ``tiles_per_block`` pixel tiles and writing one partial of the
    weight's gradient, summed by a second launch when there are several;
    ``accumulate``: grad offset and mask by atomics (several column tiles,
    or a group wider than a chunk)."""

    kind: str
    tile_rows: int
    threads: int
    chunk: int
    chunk_pad: int
    n_chunks: int
    n_col_tiles: int
    smem_bytes: int
    grid: Tuple[int, int]
    weight_pitch: int = 0
    tiles_per_block: int = 0
    accumulate: bool = False

    def flat(self):
        """The plan as the C entries read it (see ``csrc/deform_conv.cu``)."""
        out = [self.tile_rows, self.threads, self.chunk, self.chunk_pad,
               self.n_chunks, self.n_col_tiles, self.smem_bytes, *self.grid]
        if self.kind == "forward":
            return out + [self.weight_pitch]
        return out + [self.tiles_per_block, int(self.accumulate)]


def launch_plan(kind: str, pixels: int, cin: int, groups: int, cout: int,
                taps: int = 9) -> DcnPlan:
    """The launch plan of the ``"forward"`` or ``"backward"`` kernel for
    ``pixels`` output pixels (B*Ho*Wo), ``cin`` input channels in
    ``groups`` deformable groups, ``cout`` output channels and ``taps``
    kernel taps (kh*kw, at most 72). Raises ``ValueError`` for a call the
    kernels do not take."""
    if kind not in ("forward", "backward"):
        raise ValueError(f"launch_plan: kind {kind!r}")
    if (min(cin, groups, cout, taps) < 1 or pixels < 0 or cin % groups
            or taps > MAX_TAPS):
        raise ValueError(f"dcn_{kind}: {pixels} pixels, Cin {cin}, {groups} "
                         f"groups, Cout {cout}, {taps} taps (at most "
                         f"{MAX_TAPS})")
    cpg = cin // groups
    most = MAX_RUN // taps
    most = min(MAX_CHUNK, most // 8 * 8) if most >= 8 else most
    chunk = min(cin, cpg * (most // cpg) if cpg <= most else most)
    n_chunks = -(-cin // chunk)
    n_col = -(-cout // TILE_N)
    if taps * n_chunks * n_col > 65535:
        raise ValueError(f"dcn_{kind}: {taps * n_chunks * n_col} blocks per "
                         "pixel tile")
    head = dict(kind=kind, chunk=chunk, chunk_pad=_round8(chunk),
                n_chunks=n_chunks, n_col_tiles=n_col)
    if kind == "forward":
        pitch = _round8(chunk) * taps
        pitch += (36 - pitch % 32) % 32  # 4 mod 32: no bank conflicts
        # one block per SM (the weight tile fills shared memory): a call
        # whose 64-pixel tiles fit in one wave takes those, shorter blocks
        rows = 64 if -(-pixels // 64) * n_col <= SMS else FORWARD_ROWS
        return DcnPlan(**head, tile_rows=rows, threads=FORWARD_THREADS,
                       smem_bytes=16 + 4 * (TILE_N * pitch + 2 * rows * _LD_A)
                       + 32 * rows,
                       grid=(-(-pixels // rows), n_col), weight_pitch=pitch)
    n_tiles = -(-pixels // BACKWARD_ROWS)
    per_tile = taps * n_chunks * n_col
    tpb = max(1, -(-n_tiles * per_tile // TARGET_BLOCKS))
    return DcnPlan(**head, tile_rows=BACKWARD_ROWS, threads=BACKWARD_THREADS,
                   smem_bytes=BACKWARD_SMEM,
                   grid=(max(1, -(-n_tiles // tpb)), per_tile),
                   tiles_per_block=tpb,
                   accumulate=n_col > 1 or cpg > chunk)


def _library():
    lib = cuda_build.load("deform_conv")
    if lib.dcn_forward.argtypes is None:
        vp, ip = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
        meta = ctypes.POINTER(ctypes.c_longlong)
        lib.dcn_forward.argtypes = [vp] * 6 + [meta, ctypes.c_int, ip,
                                               ctypes.c_int, vp]
        lib.dcn_backward.argtypes = [vp] * 10 + [meta, ctypes.c_int, ip,
                                                 ctypes.c_int, vp]
        lib.dcn_blocks_per_sm.argtypes = [ctypes.c_int, ip]
        for fn in (lib.dcn_forward, lib.dcn_backward, lib.dcn_blocks_per_sm):
            fn.restype = ctypes.c_int
    return lib


def blocks_per_sm(forward: DcnPlan) -> Tuple[int, int]:
    """Blocks of the forward kernel (under the plan ``forward``) and of the
    backward kernel that one SM holds (the CUDA occupancy calculator's
    answer; builds the kernels if needed)."""
    out = (ctypes.c_int * 2)()
    err = _library().dcn_blocks_per_sm(forward.smem_bytes, out)
    if err != 0:
        raise RuntimeError(f"dcn occupancy query: CUDA error {err}")
    return out[0], out[1]


def _check_card(what: str, tensors, contiguous) -> torch.device:
    """The common CUDA device of ``tensors``; raises on another device, a
    dtype other than float32, a negative stride, or a tensor of
    ``contiguous`` that is not contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{what}: every input must be float32 on {dev}, "
                             f"got {t.dtype} on {t.device}")
        if any(s < 0 for s in t.stride()):
            raise ValueError(f"{what}: negative strides {tuple(t.stride())}")
    for t in contiguous:
        if not t.is_contiguous():
            raise ValueError(f"{what}: x, grad_out, the weight and the bias "
                             "must be contiguous, got strides "
                             f"{tuple(t.stride())}")
    return dev


def _card_geometry(what, x, offset, mask, weight, stride, padding, dilation,
                   shift_bound) -> _Geometry:
    geo = _Geometry(x, offset, weight.shape[2:], stride, padding, dilation,
                    shift_bound)
    if tuple(mask.shape) != tuple(offset.shape[:5]):
        raise ValueError(f"{what}: mask shape {tuple(mask.shape)}, expected "
                         f"{tuple(offset.shape[:5])}")
    if weight.dim() != 4 or weight.shape[1] != geo.Cin:
        raise ValueError(f"{what}: weight shape {tuple(weight.shape)} for "
                         f"{geo.Cin} input channels")
    if geo.H * geo.W * geo.Cin >= 2**31:  # the kernels' 32-bit offsets
        raise ValueError(f"{what}: an image of {geo.H}x{geo.W}x{geo.Cin} "
                         "elements; the kernels take fewer than 2**31")
    return geo


def _launch(what: str, fn, dev, args) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _flat(plan: DcnPlan):
    flat = plan.flat()
    return (ctypes.c_int * len(flat))(*flat), len(flat)


def dcn_forward(x, offset, mask, weight, bias=None, stride: IntPair = 1,
                padding: IntPair = 1, dilation: IntPair = 1,
                shift_bound: Optional[int] = None) -> torch.Tensor:
    """The op's forward, ``dcn_forward_plain``'s result. On CUDA tensors it
    launches the fused sample-and-contract kernel (x, the OIHW weight and
    the bias contiguous, offset and mask read in place at any strides; no
    column matrix is written) or raises; on CPU tensors it is the plain
    version."""
    if x.device.type == "cpu":
        return dcn_forward_plain(x, offset, mask, weight, bias, stride,
                                 padding, dilation, shift_bound)
    if x.device.type != "cuda":
        raise ValueError(f"dcn_forward: unsupported device {x.device}")
    extra = [] if bias is None else [bias]
    dev = _check_card("dcn_forward", [x, offset, mask, weight] + extra,
                      [x, weight] + extra)
    geo = _card_geometry("dcn_forward", x, offset, mask, weight, stride,
                         padding, dilation, shift_bound)
    Cout = weight.shape[0]
    if bias is not None and tuple(bias.shape) != (Cout,):
        raise ValueError(f"dcn_forward: bias shape {tuple(bias.shape)}")
    plan = launch_plan("forward", geo.B * geo.Q, geo.Cin, geo.G, Cout,
                       geo.K)
    out = torch.empty(geo.B, geo.Ho, geo.Wo, Cout, device=dev,
                      dtype=torch.float32)
    _launch("dcn_forward", _library().dcn_forward, dev,
            (x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
             weight.data_ptr(),
             None if bias is None else bias.data_ptr(), out.data_ptr(),
             geo.meta(offset, mask, Cout), _META, *_flat(plan)))
    capture.launched(dcn_forward)
    return out


dcn_forward.launches = 0


def dcn_backward(grad_out, x, offset, mask, weight, stride: IntPair = 1,
                 padding: IntPair = 1, dilation: IntPair = 1,
                 shift_bound: Optional[int] = None):
    """(grad x, grad offset, grad mask, grad weight OIHW) of
    ``dcn_backward_plain``. On CUDA tensors it launches the fused backward
    kernel (grad x summed by fp32 atomics, in any order; the weight's
    gradient summed from per-block partials in a fixed order, a second
    launch when there are several) or raises; on CPU tensors it is the
    plain version."""
    if x.device.type == "cpu":
        return dcn_backward_plain(grad_out, x, offset, mask, weight, stride,
                                  padding, dilation, shift_bound)
    if x.device.type != "cuda":
        raise ValueError(f"dcn_backward: unsupported device {x.device}")
    dev = _check_card("dcn_backward", (grad_out, x, offset, mask, weight),
                      (grad_out, x, weight))
    geo = _card_geometry("dcn_backward", x, offset, mask, weight, stride,
                         padding, dilation, shift_bound)
    Cout, Cin = weight.shape[:2]
    if tuple(grad_out.shape) != (geo.B, geo.Ho, geo.Wo, Cout):
        raise ValueError(f"dcn_backward: grad_out shape "
                         f"{tuple(grad_out.shape)}")
    plan = launch_plan("backward", geo.B * geo.Q, Cin, geo.G, Cout, geo.K)
    f32 = dict(device=dev, dtype=torch.float32)
    gx = torch.zeros_like(x)
    new = torch.zeros if plan.accumulate else torch.empty
    goff, gmask = new(offset.shape, **f32), new(mask.shape, **f32)
    gw = (torch.empty if geo.B * geo.Q else torch.zeros)(weight.shape, **f32)
    parts = plan.grid[0]
    ws = gw if parts == 1 else torch.empty(parts, *weight.shape, **f32)
    _launch("dcn_backward", _library().dcn_backward, dev,
            (grad_out.data_ptr(), x.data_ptr(), offset.data_ptr(),
             mask.data_ptr(), weight.data_ptr(), gx.data_ptr(),
             goff.data_ptr(),
             gmask.data_ptr(), ws.data_ptr(), gw.data_ptr(),
             geo.meta(offset, mask, Cout), _META, *_flat(plan)))
    capture.launched(dcn_backward)
    return gx, goff, gmask, gw


dcn_backward.launches = 0


# -------------------------------------------------------------------- the op

class DeformConv2dFunction(torch.autograd.Function):
    """Modulated deformable conv: ``dcn_forward``, and ``dcn_backward`` for
    every gradient but the bias's (``grad_out``'s sum). ``geom``: (stride,
    padding, dilation, shift_bound)."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, geom):
        stride, padding, dilation, S = geom
        x = x.contiguous()
        out = dcn_forward(x, offset, mask, weight, bias, stride, padding,
                          dilation, S)
        ctx.save_for_backward(x, offset, mask, weight)
        ctx.geom, ctx.has_bias = geom, bias is not None
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        x, offset, mask, weight = ctx.saved_tensors
        stride, padding, dilation, S = ctx.geom
        need = ctx.needs_input_grad
        grads = [None] * 6
        if any(need[:4]):
            got = dcn_backward(grad_out.contiguous(), x, offset, mask, weight,
                               stride, padding, dilation, S)
            grads[:4] = [g if n else None for g, n in zip(got, need)]
        if ctx.has_bias and need[4]:
            grads[4] = grad_out.reshape(-1, weight.shape[0]).sum(0)
        return tuple(grads)


def resolve_impl(impl: str, shift_bound: int, stride: IntPair, in_hw,
                 out_hw) -> Optional[int]:
    """The shift bound a call runs with: None for the exact reads
    (``"patch"``, ``"window"``), the bound for ``"dense"``; ``"auto"`` reads
    ``set_dcn_impl``'s defaults, as in the JAX package."""
    strided = _pair(stride) != (1, 1) or tuple(out_hw) != tuple(in_hw)
    if impl == "auto":
        impl = _DEFAULT_IMPL
        if _DEFAULT_SHIFT_BOUND is not None:
            shift_bound = _DEFAULT_SHIFT_BOUND
        if impl == "dense" and strided:
            impl = "patch"  # dense needs stride-1 same-size queries
    if impl in ("patch", "window"):
        return None
    if impl == "dense":
        if strided:
            raise ValueError("deform_conv2d: impl='dense' needs stride-1 "
                             "same-size queries")
        return int(shift_bound)
    raise ValueError(f"deform_conv2d: impl must be 'auto' or one of "
                     f"{IMPLS}, got {impl!r}")


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  weight: torch.Tensor, bias=None, stride: IntPair = 1,
                  padding: IntPair = 1, dilation: IntPair = 1,
                  impl: str = "auto", gather_dtype=None, shift_bound: int = 6,
                  window=None) -> torch.Tensor:
    """Modulated deformable conv, channels-last.

    x: (B, H, W, Cin); offset: (B, Ho, Wo, G, K, 2) (dy, dx) in pixels;
    mask: (B, Ho, Wo, G, K), already sigmoided; weight: (Cout, Cin, kh, kw)
    OIHW, tap k = i*kw + j; bias: (Cout,) or None. Returns (B, Ho, Wo, Cout).
    ``impl``, ``shift_bound``, ``window``: see the module docstring.
    ``gather_dtype`` (e.g. ``torch.bfloat16``) rounds the sampled source
    ``x``; corner weights, mask and the contraction stay fp32.
    """
    S = resolve_impl(impl, shift_bound, stride, x.shape[1:3],
                     offset.shape[1:3])
    return DeformConv2dFunction.apply(round_to(x, gather_dtype), offset,
                                      mask, weight, bias,
                                      (stride, padding, dilation, S))


def deform_conv2d_plain(x: torch.Tensor, offset: torch.Tensor,
                        mask: torch.Tensor, weight: torch.Tensor, bias=None,
                        stride: IntPair = 1, padding: IntPair = 1,
                        dilation: IntPair = 1, impl: str = "auto",
                        gather_dtype=None, shift_bound: int = 6,
                        window=None) -> torch.Tensor:
    """``deform_conv2d`` in plain PyTorch on any device, differentiated by
    autograd: the yardstick the kernels are held against on the card
    (``DCNSep.use_kernel = False``)."""
    S = resolve_impl(impl, shift_bound, stride, x.shape[1:3],
                     offset.shape[1:3])
    return dcn_forward_plain(round_to(x, gather_dtype), offset, mask, weight,
                             bias, stride, padding, dilation, S)
