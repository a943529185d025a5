"""Modulated deformable convolution, DCNv2 (port of
``stif_tpu/ops/deform_conv.py``).

Per-tap learned (dy, dx) offsets shared by each deformable group's
channels, bilinear sampling with zero padding per corner (a corner outside
the image contributes 0), a sigmoid mask, then one dense contraction with
the conv weight over (K taps x Cin).

The op is one ``torch.autograd.Function``. Its forward builds the column
matrix (B*Ho*Wo, K*Cin), k-major then Cin, and contracts it with the weight
in one ``torch.addmm``; its backward takes the grad-columns by a matmul,
turns them into the gradients of x, offset and mask, and takes the weight's
gradient against the columns built again (not saved: 35 MB at the encoder's
largest call). On a CUDA tensor the columns and the backward come from the
hand-written Hopper kernels of ``csrc/deform_conv.cu``, ``dcn_im2col`` and
``dcn_col2im`` (grad x by fp32 atomics, grad offset and mask fused in), or
the wrapper raises; on a CPU tensor from their plain versions here,
``dcn_im2col_plain`` and ``dcn_col2im_plain``. Nothing falls back from a
kernel. The JAX package writes this op in XLA gathers with a custom VJP for
the gather's transpose; it has no Pallas kernel for it.

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
from typing import Optional, Tuple, Union

import torch
from torch.autograd.function import once_differentiable

from stif_tpu_torch.ops import cuda_build
from stif_tpu_torch.ops.precision import round_to

IntPair = Union[int, Tuple[int, int]]

# Module-wide defaults of impl="auto" call sites (``set_dcn_impl``).
_DEFAULT_IMPL = "patch"
_DEFAULT_SHIFT_BOUND = None  # None: each call site's shift_bound
_DEFAULT_WINDOW = (8, 8)     # kept for the JAX package's API; no effect here
IMPLS = ("patch", "dense", "window")
_META = 28  # longs the C entries read (csrc/deform_conv.cu)


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def set_dcn_impl(impl: str, shift_bound: int = None, window=None) -> None:
    """Set the implementation of ``impl="auto"`` DCN calls: ``"patch"``,
    ``"dense"`` or ``"window"``. ``shift_bound`` overrides every auto call
    site's bound (check it with ``dcn_shift_stats`` first); ``window`` sets
    the JAX package's (Wy, Wx) tap-cluster window, which changes nothing
    here."""
    global _DEFAULT_IMPL, _DEFAULT_SHIFT_BOUND, _DEFAULT_WINDOW
    if impl not in IMPLS:
        raise ValueError(f"set_dcn_impl: impl must be one of {IMPLS}, "
                         f"got {impl!r}")
    _DEFAULT_IMPL = impl
    _DEFAULT_SHIFT_BOUND = shift_bound
    if window is not None:
        _DEFAULT_WINDOW = (int(window[0]), int(window[1]))


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

    def meta(self, offset, mask):
        m = [self.B, self.H, self.W, self.Cin, self.G, self.Ho, self.Wo,
             self.kh, self.kw, self.sh, self.sw, self.ph, self.pw, self.dh,
             self.dw, -1 if self.S is None else int(self.S)]
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


# ------------------------------------------------------------------ kernels

def _library():
    lib = cuda_build.load("deform_conv")
    if lib.dcn_im2col_forward.argtypes is None:
        vp, meta = ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)
        lib.dcn_im2col_forward.argtypes = [vp, vp, vp, vp, meta,
                                           ctypes.c_int, vp]
        lib.dcn_col2im_backward.argtypes = [vp, vp, vp, vp, vp, vp, vp, meta,
                                            ctypes.c_int, vp]
        lib.dcn_im2col_forward.restype = ctypes.c_int
        lib.dcn_col2im_backward.restype = ctypes.c_int
    return lib


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
            raise ValueError(f"{what}: x and the columns must be "
                             f"contiguous, got strides {tuple(t.stride())}")
    return dev


def _launch(what: str, fn, dev, args) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def dcn_im2col(x, offset, mask, kernel_size: IntPair = 3,
               stride: IntPair = 1, padding: IntPair = 1,
               dilation: IntPair = 1,
               shift_bound: Optional[int] = None) -> torch.Tensor:
    """The column matrix of ``dcn_im2col_plain``. On CUDA tensors it
    launches the kernel (x contiguous, offset and mask read in place at
    any strides) or raises; on CPU tensors it is the plain version."""
    if x.device.type == "cpu":
        return dcn_im2col_plain(x, offset, mask, kernel_size, stride,
                                padding, dilation, shift_bound)
    if x.device.type != "cuda":
        raise ValueError(f"dcn_im2col: unsupported device {x.device}")
    dev = _check_card("dcn_im2col", (x, offset, mask), (x,))
    geo = _Geometry(x, offset, kernel_size, stride, padding, dilation,
                    shift_bound)
    if tuple(mask.shape) != tuple(offset.shape[:5]):
        raise ValueError(f"dcn_im2col: mask shape {tuple(mask.shape)}")
    cols = torch.empty(geo.B * geo.Q, geo.K * geo.Cin, device=dev,
                       dtype=torch.float32)
    _launch("dcn_im2col", _library().dcn_im2col_forward, dev,
            (x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
             cols.data_ptr(), geo.meta(offset, mask), _META))
    dcn_im2col.launches += 1
    return cols


dcn_im2col.launches = 0


def dcn_col2im(grad_cols, x, offset, mask, kernel_size: IntPair = 3,
               stride: IntPair = 1, padding: IntPair = 1,
               dilation: IntPair = 1, shift_bound: Optional[int] = None):
    """(grad x, grad offset, grad mask) of ``dcn_col2im_plain``. On CUDA
    tensors it launches the kernel (grad x summed by fp32 atomics, in any
    order) or raises; on CPU tensors it is the plain version."""
    if x.device.type == "cpu":
        return dcn_col2im_plain(grad_cols, x, offset, mask, kernel_size,
                                stride, padding, dilation, shift_bound)
    if x.device.type != "cuda":
        raise ValueError(f"dcn_col2im: unsupported device {x.device}")
    dev = _check_card("dcn_col2im", (grad_cols, x, offset, mask),
                      (grad_cols, x))
    geo = _Geometry(x, offset, kernel_size, stride, padding, dilation,
                    shift_bound)
    if tuple(mask.shape) != tuple(offset.shape[:5]) or tuple(
            grad_cols.shape) != (geo.B * geo.Q, geo.K * geo.Cin):
        raise ValueError("dcn_col2im: mask or grad-columns shape "
                         f"{tuple(mask.shape)}, {tuple(grad_cols.shape)}")
    gx = torch.zeros_like(x)
    goff = torch.empty(offset.shape, device=dev, dtype=torch.float32)
    gmask = torch.empty(mask.shape, device=dev, dtype=torch.float32)
    _launch("dcn_col2im", _library().dcn_col2im_backward, dev,
            (grad_cols.data_ptr(), x.data_ptr(), offset.data_ptr(),
             mask.data_ptr(), gx.data_ptr(), goff.data_ptr(),
             gmask.data_ptr(), geo.meta(offset, mask), _META))
    dcn_col2im.launches += 1
    return gx, goff, gmask


dcn_col2im.launches = 0


# -------------------------------------------------------------------- the op

def _weight_rows(weight):
    """OIHW (Cout, Cin, kh, kw) as the (K*Cin, Cout) matrix of the columns'
    layout."""
    Cout, Cin, kh, kw = weight.shape
    return weight.permute(2, 3, 1, 0).reshape(kh * kw * Cin, Cout)


class DeformConv2dFunction(torch.autograd.Function):
    """Modulated deformable conv: columns (``dcn_im2col``) then one
    ``addmm``; the backward by ``dcn_col2im``, two matmuls and the columns
    built again. ``geom``: (stride, padding, dilation, shift_bound)."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, geom):
        stride, padding, dilation, S = geom
        Cout, _, kh, kw = weight.shape
        if x.device.type == "cuda":  # dcn_im2col checks offset and mask
            _check_card("deform_conv2d",
                        [x, weight] + ([] if bias is None else [bias]), ())
        x = x.contiguous()
        cols = dcn_im2col(x, offset, mask, (kh, kw), stride, padding,
                          dilation, S)
        wr = _weight_rows(weight)
        out = cols @ wr if bias is None else torch.addmm(bias, cols, wr)
        ctx.save_for_backward(x, offset, mask, weight)
        ctx.geom, ctx.has_bias = geom, bias is not None
        B, Ho, Wo = offset.shape[:3]
        return out.reshape(B, Ho, Wo, Cout)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        x, offset, mask, weight = ctx.saved_tensors
        stride, padding, dilation, S = ctx.geom
        Cout, _, kh, kw = weight.shape
        g = grad_out.reshape(-1, Cout)
        wr = _weight_rows(weight)
        need = ctx.needs_input_grad
        gx = goff = gmask = gw = gb = None
        if any(need[:3]):
            gx, goff, gmask = dcn_col2im(g @ wr.t(), x, offset, mask,
                                         (kh, kw), stride, padding, dilation,
                                         S)
        if need[3]:
            cols = dcn_im2col(x, offset, mask, (kh, kw), stride, padding,
                              dilation, S)
            gw = (cols.t() @ g).reshape(kh, kw, -1, Cout).permute(3, 2, 0, 1)
        if ctx.has_bias and need[4]:
            gb = g.sum(0)
        return gx, goff, gmask, gw, gb, None


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
    Cout, _, kh, kw = weight.shape
    cols = dcn_im2col_plain(round_to(x, gather_dtype), offset, mask,
                            (kh, kw), stride, padding, dilation, S)
    wr = _weight_rows(weight)
    out = cols @ wr if bias is None else torch.addmm(bias, cols, wr)
    return out.reshape(*offset.shape[:3], Cout)
