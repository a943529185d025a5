"""STIF's arbitrary-scale architecture in plain PyTorch: the ``LunaTokis``
train variant (``which_model_G: LIIF_train``) of the STIF code,
``codes/models/modules/Sakuya_arch.py`` (its decoder's nets at ``:303-308``,
the fold at ``:458``), which ``configs/train_adobe_arbitrary.yml`` trains.

The encoder is the flagship's (``reference/stif.py``'s ``encode``), its
parameters under ``encoder.``. The decoder, per query at time t, for an
input pair (widths at nf = 64):

- stage A: the nearest LR cell's features (3nf) and input pixels (6) and
  the relative coordinates (2), 200 -> ``feat_imnet`` -> 128, no time code:
  the HR feature field;
- stage B: that field at the query, nearest, the stage-A inputs and t,
  329 -> ``flow_imnet`` -> 4: two flows in pixels, (x, y) each;
- stage C: each flow added to the ``align_corners=True`` lattice (divided
  by ((WW - 1) / 2, (HH - 1) / 2)), clamped; bilinear samples of the HR
  field and of the LR features and inputs at both grids;
- stage D: [HR 1, LR features 1, inputs 1, HR 2, LR features 2, inputs 2],
  652 -> ``encode_imnet`` -> 27: overlapping 3x3 RGB patches, summed by
  ``F.fold(kernel_size=3, padding=1)`` (input channel c * 9 + i * 3 + j is
  the patch value at offset (i - 1, j - 1)).

Parameters are a state dict of the port's schema; ``arch`` holds ``nf``,
``groups``, ``front_RBs``, ``back_RBs``. Departures from the published
code, none of which changes a query's arithmetic:

- the query times are decoded one at a time, and the query rows of each in
  blocks of ``block``; the fold sums each whole frame at once, so that no
  3x3 neighbourhood crosses a block;
- stage A has no time code, so its field is computed once for all times;
- the matrices run in fp32 with TF32 off unless ``tf32`` asks for it (the
  control's lower precision).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from benchmark.reference import stif
from benchmark.reference.ops import (EPS, base_grid, grid_sample, make_coord,
                                     siren)


@contextlib.contextmanager
def precision(tf32: bool):
    """cuDNN convs and matmuls with TF32 ``tf32`` inside, as before after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def decode(P, feat_t, x, times, out_size, block: int = 1 << 30):
    """Features (B, 3, H, W, nf), inputs (B, 2, H, W, 3), times (nt,) or
    (B, nt) -> (nt, B, HH, WW, 3), ``block`` query rows at a time."""
    B, _, H, W, _ = feat_t.shape
    HH, WW = out_size
    dev = feat_t.device
    feat = feat_t[:, :3].permute(0, 2, 3, 1, 4).reshape(B, H, W, -1)
    inp = x.permute(0, 2, 3, 1, 4).reshape(B, H, W, -1)
    lr = torch.cat([feat, inp], -1)
    cells = torch.from_numpy(make_coord((H, W))).to(dev)
    lr_cells = torch.cat([lr, cells.reshape(1, H, W, 2).expand(B, H, W, 2)],
                         -1)
    coord = torch.from_numpy(make_coord((HH, WW))).to(dev)
    coord = coord.clamp(-1 + EPS, 1 - EPS)
    grid = torch.from_numpy(base_grid(HH, WW)).to(dev)
    norm = torch.tensor([(WW - 1.0) / 2.0, (HH - 1.0) / 2.0], device=dev)
    size = torch.tensor([H, W], dtype=coord.dtype, device=dev)
    t_all = torch.as_tensor(times, dtype=torch.float32, device=dev)
    t_all = t_all.reshape(1, -1).expand(B, -1) if t_all.dim() == 1 else t_all
    Q = HH * WW
    spans = [(a, min(a + block, Q)) for a in range(0, Q, block)]

    def stage_a_inputs(a, b):
        """(B, b - a, 3nf + 8): the nearest LR cell's features and inputs,
        the relative coordinates."""
        c = coord[a:b][None].expand(B, -1, 2)
        near = grid_sample(lr_cells, c.flip(-1), "nearest")
        return torch.cat([near[..., :-2], (c - near[..., -2:]) * size], -1)

    hrfeat = torch.cat([siren(P, "feat_imnet", [stage_a_inputs(a, b)])
                        for a, b in spans], 1).reshape(B, HH, WW, -1)
    out = []
    for i in range(t_all.shape[1]):
        t = t_all[:, i].reshape(B, 1, 1)
        patches = []
        for a, b in spans:
            xy = coord[a:b][None].expand(B, -1, 2).flip(-1)
            flow = siren(P, "flow_imnet", [grid_sample(hrfeat, xy, "nearest"),
                                           stage_a_inputs(a, b),
                                           t.expand(B, b - a, 1)])
            g1 = (grid[a:b][None] + flow[..., 0:2] / norm).clamp(-1 + EPS,
                                                                 1 - EPS)
            g2 = (grid[a:b][None] + flow[..., 2:4] / norm).clamp(-1 + EPS,
                                                                 1 - EPS)
            patches.append(siren(P, "encode_imnet", [
                grid_sample(hrfeat, g1), grid_sample(lr, g1),
                grid_sample(hrfeat, g2), grid_sample(lr, g2)]))
        rgb = F.fold(torch.cat(patches, 1).transpose(1, 2), (HH, WW),
                     kernel_size=3, padding=1)
        out.append(rgb.permute(0, 2, 3, 1))
    return torch.stack(out, 0)


def forward(P, arch, x, times, out_size, block: int = 1 << 30,
            tf32: bool = False):
    """(B, 2, H, W, 3) and query times -> (nt, B, HH, WW, 3)."""
    enc = {k[len("encoder."):]: v for k, v in P.items()
           if k.startswith("encoder.")}
    with precision(tf32):
        return decode(P, stif.encode(enc, arch, x), x, times, out_size,
                      block)
