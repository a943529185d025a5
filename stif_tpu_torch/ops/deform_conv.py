"""Modulated deformable convolution, DCNv2 (port of
``stif_tpu/ops/deform_conv.py`` with its ``impl="patch"`` semantics).

Per-tap learned (dy, dx) offsets shared by each deformable group's
channels, bilinear sampling with zero padding per corner (a corner outside
the image contributes 0), a sigmoid mask, then one dense contraction with
the conv weight over (K taps x Cin). Plain PyTorch: the JAX package writes
this op in XLA gathers too, not in Pallas. A hand-written kernel for it is a
later step of the port.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

IntPair = Union[int, Tuple[int, int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def split_offset_mask(conv_out: torch.Tensor, deformable_groups: int,
                      kernel_size: IntPair = 3):
    """Split a raw ``conv_offset_mask`` output (B, H, W, 3*G*K) into
    offset (B, H, W, G, K, 2) — ``concat(o1, o2)`` read per group as
    interleaved (dy, dx) pairs per tap — and sigmoid mask (B, H, W, G, K)."""
    kh, kw = _pair(kernel_size)
    K = kh * kw
    G = deformable_groups
    B, H, W, _ = conv_out.shape
    offset = conv_out[..., :2 * G * K].reshape(B, H, W, G, K, 2)
    mask = torch.sigmoid(conv_out[..., 2 * G * K:].reshape(B, H, W, G, K))
    return offset, mask


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  weight: torch.Tensor, bias=None, stride: IntPair = 1,
                  padding: IntPair = 1, dilation: IntPair = 1) -> torch.Tensor:
    """Modulated deformable conv, channels-last.

    x: (B, H, W, Cin); offset: (B, Ho, Wo, G, K, 2) (dy, dx) in pixels;
    mask: (B, Ho, Wo, G, K), already sigmoided; weight: (Cout, Cin, kh, kw)
    OIHW, tap k = i*kw + j; bias: (Cout,) or None. Returns (B, Ho, Wo, Cout).
    """
    B, H, W, Cin = x.shape
    Cout, _, kh, kw = weight.shape
    K = kh * kw
    G = offset.shape[3]
    CpG = Cin // G
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    Ho, Wo = offset.shape[1], offset.shape[2]
    Q = Ho * Wo
    dev, f32 = x.device, torch.float32  # fp32, as in the JAX package

    # base positions: arange*stride - pad + tap*dilation, taps row-major
    ys = torch.arange(Ho, device=dev, dtype=f32) * sh - ph
    xs = torch.arange(Wo, device=dev, dtype=f32) * sw - pw
    ti = (torch.arange(kh, device=dev, dtype=f32) * dh).repeat_interleave(kw)
    tj = (torch.arange(kw, device=dev, dtype=f32) * dw).repeat(kh)
    base_y = (ys[:, None, None] + ti).expand(Ho, Wo, K).reshape(1, Q, 1, K)
    base_x = (xs[None, :, None] + tj).expand(Ho, Wo, K).reshape(1, Q, 1, K)
    off = offset.reshape(B, Q, G, K, 2)
    py = base_y + off[..., 0]  # (B, Q, G, K)
    px = base_x + off[..., 1]

    y0 = torch.floor(py)
    x0 = torch.floor(px)
    ly = py - y0
    lx = px - x0
    y0 = y0.long()
    x0 = x0.long()
    m = mask.reshape(B, Q, G, K)

    xf = x.reshape(B, H * W, G, CpG)
    bi = torch.arange(B, device=dev)[:, None, None, None]
    gi = torch.arange(G, device=dev)[None, None, :, None]

    def corner(yi, xi, w):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        v = xf[bi, idx, gi]  # (B, Q, G, K, CpG)
        return v * (torch.where(valid, w, 0.0) * m)[..., None]

    col = (corner(y0, x0, (1 - ly) * (1 - lx))
           + corner(y0, x0 + 1, (1 - ly) * lx)
           + corner(y0 + 1, x0, ly * (1 - lx))
           + corner(y0 + 1, x0 + 1, ly * lx))
    # (B, Q, G, K, CpG) -> (B*Q, K*Cin) against weight as (K*Cin, Cout)
    col = col.permute(0, 1, 3, 2, 4).reshape(B * Q, K * Cin)
    wr = weight.permute(2, 3, 1, 0).reshape(K * Cin, Cout)
    out = col @ wr
    if bias is not None:
        out = out + bias
    return out.reshape(B, Ho, Wo, Cout)
