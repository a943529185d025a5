"""Deformable position-sensitive ROI pooling (port of
``stif_tpu/ops/psroi_pool.py``).

The reference's ``dcn_v2_psroi_pooling_cuda_forward``
(``codes/models/modules/DCNv2/src/cuda/dcn_v2_psroi_pooling_cuda.cu:58-146``)
ships with its DCNv2 extension and is dead code for the STIF model family
(only ``DCNv2/test.py`` calls it); the JAX package writes it in XLA gathers
for component coverage, with no Pallas kernel, and here it is plain torch
ops, on any device.

Each (roi, out_channel, ph, pw) bin averages ``sample_per_part ** 2``
bilinear samples inside the bin, shifted by learned per-part (x, y) offsets
scaled by ``trans_std``; the sampled channel is position-sensitive,
``c = (ctop * G + gh) * G + gw``. Samples whose centre falls outside
[-0.5, dim - 0.5] are left out of the average (a masked mean).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def deform_psroi_pool(
    x: torch.Tensor,                 # (B, H, W, C) feature map
    rois: torch.Tensor,              # (R, 5): (batch_idx, x1, y1, x2, y2) px
    trans: Optional[torch.Tensor] = None,  # (R, classes, 2, part, part)
    spatial_scale: float = 1.0,
    pooled_size: int = 7,
    output_dim: Optional[int] = None,
    group_size: int = 1,
    part_size: Optional[int] = None,
    sample_per_part: int = 4,
    trans_std: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (R, P, P, output_dim), count (R, P, P, output_dim))."""
    B, H, W, C = x.shape
    P = pooled_size
    G = group_size
    output_dim = output_dim or C // (G * G)
    part_size = part_size or P
    R = rois.shape[0]
    num_classes = 1 if trans is None else trans.shape[1]
    channels_each_class = output_dim // num_classes
    dev, f32 = x.device, torch.float32

    rois = rois.to(dev, f32)
    batch_idx = rois[:, 0].long()
    x1 = torch.round(rois[:, 1]) * spatial_scale - 0.5
    y1 = torch.round(rois[:, 2]) * spatial_scale - 0.5
    x2 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    y2 = (torch.round(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    roi_w = torch.clamp(x2 - x1, min=0.1)
    roi_h = torch.clamp(y2 - y1, min=0.1)
    bin_w, bin_h = roi_w / P, roi_h / P           # (R,)
    sub_w, sub_h = bin_w / sample_per_part, bin_h / sample_per_part

    p = torch.arange(P, dtype=f32, device=dev)
    hstart = y1[:, None, None] + p[None, :, None] * bin_h[:, None, None]
    wstart = x1[:, None, None] + p[None, None, :] * bin_w[:, None, None]

    part = torch.floor(p / P * part_size).long()  # (P,)
    gp = torch.clamp(torch.floor(p * G / P).long(), 0, G - 1)

    ctop = torch.arange(output_dim, device=dev)
    class_id = ctop // channels_each_class        # (O,)

    if trans is None:
        tx = ty = torch.zeros((R, output_dim, P, P), dtype=f32, device=dev)
    else:
        tr = trans.to(dev, f32)                   # (R, classes, 2, part, part)
        tx = tr[:, class_id, 0][:, :, part][:, :, :, part] * trans_std
        ty = tr[:, class_id, 1][:, :, part][:, :, :, part] * trans_std

    # sample positions: (R, O, P, P, s, s)
    s = torch.arange(sample_per_part, dtype=f32, device=dev)

    def r6(v):  # (R,) -> (R, 1, 1, 1, 1, 1)
        return v[:, None, None, None, None, None]

    ws = (wstart[:, None, :, :, None, None]
          + tx[..., None, None] * r6(roi_w)
          + s[None, None, None, None, None, :] * r6(sub_w))
    hs = (hstart[:, None, :, :, None, None]
          + ty[..., None, None] * r6(roi_h)
          + s[None, None, None, None, :, None] * r6(sub_h))

    valid = (ws >= -0.5) & (ws <= W - 0.5) & (hs >= -0.5) & (hs <= H - 0.5)
    wc = torch.clamp(ws, 0.0, W - 1.0)
    hc = torch.clamp(hs, 0.0, H - 1.0)

    # position-sensitive channel per (O, ph, pw)
    chan = (ctop[:, None, None] * G + gp[None, :, None]) * G + gp[None, None, :]

    # bilinear_interp takes floor / ceil (not floor / floor + 1): at an
    # integer position both corners coincide and the weights still sum to 1
    x1i, x2i = torch.floor(wc).long(), torch.ceil(wc).long()
    y1i, y2i = torch.floor(hc).long(), torch.ceil(hc).long()
    dx, dy = wc - x1i, hc - y1i

    bi = r6(batch_idx)
    ci = chan[None, :, :, :, None, None]

    def sample(yi, xi):
        return x[bi, yi, xi, ci]

    val = ((1 - dx) * (1 - dy) * sample(y1i, x1i)
           + (1 - dx) * dy * sample(y2i, x1i)
           + dx * (1 - dy) * sample(y1i, x2i)
           + dx * dy * sample(y2i, x2i))

    val = torch.where(valid, val, torch.zeros((), dtype=val.dtype,
                                              device=dev))
    cnt = valid.sum(dim=(-1, -2)).to(f32)        # (R, O, P, P)
    total = val.sum(dim=(-1, -2))
    out = torch.where(cnt > 0, total / torch.clamp(cnt, min=1),
                      torch.zeros((), dtype=total.dtype, device=dev))
    # channels-last (R, P, P, O)
    return out.permute(0, 2, 3, 1), cnt.permute(0, 2, 3, 1)
