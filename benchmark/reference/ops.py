"""Plain PyTorch operations of the benchmark's reference models.

Channels-last (B, H, W, C) tensors, float32, no kernels, no caches. The
models here take their parameters as a state dict of the reference
``.pth`` schema (OIHW conv weights, ``nn.Linear`` weights as (out, in)).
Every constant (coordinate grids, resize matrices) is worked out here from
the shapes; nothing is read from the program under test.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-6


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def conv(P: dict, name: str, x: torch.Tensor, stride: int = 1,
         padding=None) -> torch.Tensor:
    """The conv ``name`` of ``P`` on a channels-last map; ``padding``
    defaults to half the kernel (the reference's 'same' convs)."""
    w = P[f"{name}.weight"]
    b = P.get(f"{name}.bias")
    pad = w.shape[-1] // 2 if padding is None else padding
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride, pad)
    return y.permute(0, 2, 3, 1)


def resblocks(P: dict, prefix: str, x: torch.Tensor, n: int) -> torch.Tensor:
    for i in range(n):
        y = F.relu(conv(P, f"{prefix}.{i}.conv1", x))
        x = x + conv(P, f"{prefix}.{i}.conv2", y)
    return x


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """``F.interpolate`` bilinear (``align_corners=False``) of a
    channels-last map to ``size``."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size),
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    return F.pixel_shuffle(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)


def grid_sample(x: torch.Tensor, grid: torch.Tensor,
                mode: str = "bilinear") -> torch.Tensor:
    """``F.grid_sample`` (zero padding, ``align_corners=False``) of a
    channels-last map at a flat (B, Q, 2) grid of (x, y) points: (B, Q, C)."""
    y = F.grid_sample(x.permute(0, 3, 1, 2), grid[:, :, None, :], mode=mode,
                      padding_mode="zeros", align_corners=False)
    return y[:, :, :, 0].permute(0, 2, 1)


def make_coord(shape) -> np.ndarray:
    """LIIF cell centres over (-1, 1) of an (H, W) grid, (H*W, 2) in (y, x)
    order; float64 rounded once to float32."""
    seqs = [-1.0 + 1.0 / n + (2.0 / n) * np.arange(n, dtype=np.float64)
            for n in shape]
    g = np.stack(np.meshgrid(*seqs, indexing="ij"), -1).astype(np.float32)
    return g.reshape(-1, len(shape))


def base_grid(h: int, w: int) -> np.ndarray:
    """The ``align_corners=True`` lattice ``linspace(-1, 1)`` of an (h, w)
    grid, (h*w, 2) in (x, y) order."""
    gx = np.linspace(-1.0, 1.0, w)
    gy = np.linspace(-1.0, 1.0, h)
    g = np.stack(np.meshgrid(gx, gy, indexing="xy"), -1).astype(np.float32)
    return g.reshape(-1, 2)


def _cubic(x):
    ax = np.abs(x)
    return ((1.5 * ax ** 3 - 2.5 * ax ** 2 + 1.0) * (ax <= 1)
            + (-0.5 * ax ** 3 + 2.5 * ax ** 2 - 4.0 * ax + 2.0)
            * ((ax > 1) & (ax <= 2)))


@lru_cache(maxsize=64)
def matlab_matrix(n_in: int, n_out: int) -> np.ndarray:
    """MATLAB ``imresize`` bicubic (antialiased below scale 1, symmetric
    edges) as a dense (n_out, n_in) float32 matrix, scale n_out / n_in."""
    scale = n_out / n_in
    width = 4.0 / scale if scale < 1 else 4.0
    u = (np.arange(1, n_out + 1, dtype=np.float64) / scale
         + 0.5 * (1 - 1 / scale))
    left = np.floor(u - width / 2)
    taps = int(math.ceil(width)) + 2
    idx = left[:, None] + np.arange(taps)[None, :]
    dist = u[:, None] - idx
    wts = scale * _cubic(dist * scale) if scale < 1 else _cubic(dist)
    wts = wts / wts.sum(1, keepdims=True)
    zeros = (wts == 0).sum(0)
    if zeros[0] != 0:
        idx, wts = idx[:, 1:taps - 1], wts[:, 1:taps - 1]
    if zeros[-1] != 0:  # as the reference's code, a no-op after the first
        idx, wts = idx[:, :taps - 2], wts[:, :taps - 2]
    # symmetric padding: -1 -> 0, n -> n - 1, ...
    src = idx.astype(np.int64) - 1
    src = np.where(src < 0, -src - 1, src)
    src = np.where(src >= n_in, 2 * n_in - 1 - src, src)
    m = np.zeros((n_out, n_in))
    np.add.at(m, (np.repeat(np.arange(n_out), src.shape[1]), src.ravel()),
              wts.ravel())
    return m.astype(np.float32)


def imresize_to(x: torch.Tensor, out_hw) -> torch.Tensor:
    """MATLAB bicubic resize of (..., H, W, C) to ``out_hw``."""
    mh = torch.from_numpy(matlab_matrix(x.shape[-3], int(out_hw[0])))
    mw = torch.from_numpy(matlab_matrix(x.shape[-2], int(out_hw[1])))
    y = torch.einsum("oh,...hwc->...owc", mh.to(x.device), x)
    return torch.einsum("ow,...hwc->...hoc", mw.to(x.device), y)


def deform_conv(P: dict, name: str, x: torch.Tensor, fea: torch.Tensor,
                groups: int, stride: int = 1, padding: int = 1,
                dilation: int = 1) -> torch.Tensor:
    """DCNv2 as the reference's ``DCN_sep``: offsets and mask from the conv
    ``{name}.conv_offset_mask`` of ``fea`` (channels [o1, o2, mask], the
    offsets read as (dy, dx) per group and tap), a bilinear sample of ``x``
    at each tap with every corner outside the map read as 0, times the
    sigmoid mask, then one contraction with ``{name}.weight`` over taps and
    channels, plus the bias."""
    w = P[f"{name}.weight"]
    cout, cin, kh, kw = w.shape
    K, G = kh * kw, groups
    om = conv(P, f"{name}.conv_offset_mask", fea, stride, padding)
    B, Ho, Wo, _ = om.shape
    _, H, W, _ = x.shape
    off = om[..., :2 * G * K].reshape(B, Ho * Wo, G, K, 2)
    mask = torch.sigmoid(om[..., 2 * G * K:].reshape(B, Ho * Wo, G, K))
    dev = x.device
    ty = (torch.arange(kh, device=dev) * dilation).repeat_interleave(kw)
    tx = (torch.arange(kw, device=dev) * dilation).repeat(kh)
    oy = torch.arange(Ho, device=dev) * stride - padding
    ox = torch.arange(Wo, device=dev) * stride - padding
    py = (oy[:, None, None] + ty).expand(Ho, Wo, K).reshape(1, -1, 1, K)
    px = (ox[None, :, None] + tx).expand(Ho, Wo, K).reshape(1, -1, 1, K)
    py = py.float() + off[..., 0]
    px = px.float() + off[..., 1]
    y0, x0 = torch.floor(py), torch.floor(px)
    ly, lx = py - y0, px - x0
    xf = x.reshape(B, H * W, G, cin // G)
    bi = torch.arange(B, device=dev)[:, None, None, None]
    gi = torch.arange(G, device=dev)[None, None, :, None]
    cols = 0
    for cy, wy in ((y0, 1 - ly), (y0 + 1, ly)):
        for cx, wx in ((x0, 1 - lx), (x0 + 1, lx)):
            inside = (cy >= 0) & (cy < H) & (cx >= 0) & (cx < W)
            idx = (cy.clamp(0, H - 1) * W + cx.clamp(0, W - 1)).long()
            weight = wy * wx * inside.to(x.dtype) * mask
            cols = cols + xf[bi, idx, gi] * weight[..., None]
    # (B, Q, G, K, C/G) against (Cout, G, C/G, K)
    wg = w.reshape(cout, G, cin // G, K)
    out = torch.einsum("bqgkc,ogck->bqo", cols, wg) + P[f"{name}.bias"]
    return out.reshape(B, Ho, Wo, cout)


def siren(P: dict, name: str, fields, omega0: float = 30.0) -> torch.Tensor:
    """The SIREN net ``name``: its fields concatenated, then each layer
    ``h W^T + b``, a sine of ``omega0`` times it on all but the last."""
    h = torch.cat(list(fields), -1)
    i = 0
    while f"{name}.net.{i}.linear.weight" in P:
        lin = f"{name}.net.{i}.linear"
        h = torch.sin(omega0 * F.linear(h, P[f"{lin}.weight"],
                                        P[f"{lin}.bias"]))
        i += 1
    return F.linear(h, P[f"{name}.net.{i}.weight"], P[f"{name}.net.{i}.bias"])
