"""The ablation family: one configurable model, seven presets (port of
``stif_tpu/models/ablations.py``).

The presets differ in the decoder's MLP widths and stage wiring over the
shared encoder:

- ``test3``: 192-channel HR field, 5-layer MLPs, fold-27 patch output,
  train-style stage wiring;
- ``test4`` / ``nomul`` (identical): the minimal decoder: stage A
  [feature, rel, time], flow from the HR field and the time alone, RGB from
  the two warped HR fields;
- ``test5``: the train variant's widths;
- ``single``: test3-style wiring with 4-layer MLPs and a 32-channel output
  field refined to RGB by a 2-conv head;
- ``continuous``: flagship-like wiring without the time code in stages A
  and D, bilinear stage-B resamples, train-order stage-D input;
- ``test2``: the multi-feature decode with a 192-channel HR field.

Every preset has ``decode`` (one pair window, any times and output size)
and ``decode_mulfeat`` (windows (0,1,2), (2,3,4), (4,5,6) of the 2N-1
feature sequence of at least 4 input frames, each at its own time grid).
The first-layer widths depend on the number of input frames ``n_inputs``
wherever a stage reads the input frames: a model that runs
``decode_mulfeat`` is built with the ``n_inputs`` it is fed.

The JAX ablations never ask for the fused SIREN kernel, so the nets here are
built with ``fused=False``; their fields are still handed over as views the
kernel could read.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from stif_tpu_torch.models.luna_tokis_variants import Queries, _Encoder, _prep
from stif_tpu_torch.models.registry import register_model
from stif_tpu_torch.nn.blocks import Conv
from stif_tpu_torch.nn.siren import Siren
from stif_tpu_torch.ops.fold import fold3x3
from stif_tpu_torch.ops.grid_sample import grid_sample


class LunaTokisAblation(nn.Module):
    """Configurable ablation decoder over the shared encoder.

    ``stage_a``: "feat_rel_pe" | "feat_inp_rel".
    ``stage_b``: "hr_pe" | "train" (all nearest: hr, feat0, inp, rel, pe) |
                 "cont" (bilinear: hr, feat0, inp, pe).
    ``stage_d``: "two_hr" ([q1, q2]) | "six" (train order
                 [q1, q3, qi1, q2, q4, qi2]).
    ``encode_out``: output channels; 27 with ``fold`` -> 3-channel
    overlap-add. ``final_rgb``: the ``single`` variant's head, two 3x3 convs
    out -> 16 -> 3 with no activation between, on the decoded field.
    """

    def __init__(self, nf: int = 64, nframes: int = 6, groups: int = 8,
                 front_RBs: int = 5, back_RBs: int = 40, hr_ch: int = 64,
                 stage_a: str = "feat_rel_pe", stage_b: str = "hr_pe",
                 stage_d: str = "two_hr", encode_out: int = 3,
                 fold: bool = False, final_rgb: bool = False,
                 feat_widths: Tuple[int, ...] = (64, 64, 256),
                 flow_widths: Tuple[int, ...] = (64, 64, 256),
                 encode_widths: Tuple[int, ...] = (64, 64, 256, 256),
                 n_inputs: int = 2):
        super().__init__()
        self.hr_ch, self.encode_out = hr_ch, encode_out
        self.stage_a, self.stage_b, self.stage_d = stage_a, stage_b, stage_d
        self.fold, self.final_rgb = fold, final_rgb
        self.encoder = _Encoder(nf, groups, front_RBs, back_RBs)
        nfc, nic = 3 * nf, 3 * n_inputs
        feat_in = nfc + 3 if stage_a == "feat_rel_pe" else nfc + nic + 2
        flow_in = hr_ch + {"hr_pe": 1, "train": nfc + nic + 3,
                           "cont": nfc + nic + 1}[stage_b]
        encode_in = 2 * (hr_ch if stage_d == "two_hr"
                         else hr_ch + nfc + nic)

        def siren(cin, widths, cout):
            return Siren(cin, list(widths), len(widths) - 1, cout,
                         fused=False)

        self.feat_imnet = siren(feat_in, feat_widths, hr_ch)
        self.flow_imnet = siren(flow_in, flow_widths, 4)
        self.encode_imnet = siren(encode_in, encode_widths, encode_out)
        if final_rgb:
            self.final_conv0 = Conv(encode_out, 16, 3, 1, 1)
            self.final_conv1 = Conv(16, 3, 3, 1, 1)

    def gen_feat(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)

    def _decode_window(self, feat, inp_cat, times, HH: int, WW: int):
        """One decode pass over a (HH, WW) query grid from a window field
        ``feat`` (B, H, W, 3nf). Returns (nt, B, HH, WW, C_out)."""
        q = Queries(feat, inp_cat, times, HH, WW)
        nt, B, Q, nfc = q.nt, q.B, q.Q, q.nfc
        base = q.tile_t(q.base)  # [nearest feature, nearest input, rel]

        if self.stage_a == "feat_rel_pe":
            hrfeat_q = self.feat_imnet(
                [base[..., :nfc], base[..., nfc + q.nic:], q.pe])
        else:  # feat_inp_rel: adds the nearest input sample, no time code
            hrfeat_q = self.feat_imnet([base])
        hrfeat = hrfeat_q.reshape(nt * B, HH, WW, -1)

        # stage B: the resample of the HR field at its own cell centres is
        # the identity for a nearest gather
        if self.stage_b == "hr_pe":
            flow_q = self.flow_imnet([hrfeat_q, q.pe])
        elif self.stage_b == "train":
            flow_q = self.flow_imnet([hrfeat_q, base, q.pe])
        else:
            # cont: bilinear resamples, no rel. The bilinear regather of the
            # HR field at the clamped query coordinates differs from the
            # identity (by about 1e-5) at boundary cells: no shortcut here
            q_b = grid_sample(torch.cat([feat, inp_cat], -1), q.cxy)
            q_hr_b = grid_sample(
                hrfeat, q.tile_t(q.cxy).reshape(nt * B, Q, 2)
            ).reshape(nt, B, Q, -1)
            flow_q = self.flow_imnet([q_hr_b, q.tile_t(q_b), q.pe])
        g1, g2 = q.warp_grids(flow_q, HH, WW)
        q_feat1 = grid_sample(hrfeat, g1)
        q_feat2 = grid_sample(hrfeat, g2)
        if self.stage_d == "two_hr":
            out = self.encode_imnet([q_feat1, q_feat2])
        else:  # six, train order: [q1, (q3, qi1), q2, (q4, qi2)]
            lr_c = q.tile_b(torch.cat([feat, inp_cat], -1))
            out = self.encode_imnet([q_feat1, grid_sample(lr_c, g1),
                                     q_feat2, grid_sample(lr_c, g2)])
        out = out.reshape(nt * B, HH, WW, self.encode_out)
        if self.fold:
            out = fold3x3(out)
        elif self.final_rgb:
            out = self.final_conv1(self.final_conv0(out))
        return out.reshape(nt, B, HH, WW, out.shape[-1])

    def decode(self, feat_t, inp, times, out_size=None) -> torch.Tensor:
        """One pair window: the first 3 temporal feature maps."""
        feat, inp_cat, HH, WW = _prep(feat_t, inp, out_size)
        return self._decode_window(feat, inp_cat, times, HH, WW)

    def decode_mulfeat(self, feat_t, inp,
                       window_times: Optional[Sequence[Sequence[float]]] = None,
                       out_size=None) -> torch.Tensor:
        """Decode 3 overlapping pair windows (temporal maps (0,1,2), (2,3,4),
        (4,5,6)) of an input of at least 4 frames, each at its own time grid
        (default [0, .5], [0, .5], [0, .5, 1]: a continuous x2 temporal
        upsample across the window). Returns (sum(nt_i), B, HH, WW, C)."""
        if feat_t.shape[1] < 7:
            raise ValueError("decode_mulfeat needs at least 4 input frames "
                             f"(7 feature maps), got {feat_t.shape[1]} maps")
        if window_times is None:
            window_times = ([0.0, 0.5], [0.0, 0.5], [0.0, 0.5, 1.0])
        outs = []
        for fid in range(3):
            feat, inp_cat, HH, WW = _prep(feat_t[:, 2 * fid:2 * fid + 3], inp,
                                          out_size)
            outs.append(self._decode_window(feat, inp_cat, window_times[fid],
                                            HH, WW))
        return torch.cat(outs, 0)

    def forward(self, x, times, out_size=None,
                mulfeat: bool = False) -> torch.Tensor:
        feat = self.encoder(x)
        if mulfeat:
            return self.decode_mulfeat(feat, x, out_size=out_size)
        return self.decode(feat, x, times, out_size)


_PRESETS = {
    "test3": dict(hr_ch=192, stage_a="feat_inp_rel", stage_b="train",
                  stage_d="six", encode_out=27, fold=True,
                  feat_widths=(64, 64, 64, 64, 256),
                  flow_widths=(64, 64, 64, 64, 256),
                  encode_widths=(64, 64, 64, 256, 256)),
    "test4": dict(hr_ch=64, stage_a="feat_rel_pe", stage_b="hr_pe",
                  stage_d="two_hr", encode_out=3, fold=False,
                  feat_widths=(64, 64, 256), flow_widths=(64, 64, 256),
                  encode_widths=(64, 64, 256, 256)),
    "test5": dict(hr_ch=128, stage_a="feat_inp_rel", stage_b="train",
                  stage_d="six", encode_out=27, fold=True,
                  feat_widths=(64, 64, 64, 256),
                  flow_widths=(64, 64, 64, 256),
                  encode_widths=(64, 64, 64, 256, 256)),
    "single": dict(hr_ch=192, stage_a="feat_inp_rel", stage_b="train",
                   stage_d="six", encode_out=32, fold=False, final_rgb=True,
                   feat_widths=(64, 64, 64, 256),
                   flow_widths=(64, 64, 64, 256),
                   encode_widths=(64, 64, 64, 256, 256)),
    "continuous": dict(hr_ch=64, stage_a="feat_inp_rel", stage_b="cont",
                       stage_d="six", encode_out=3, fold=False,
                       feat_widths=(64, 64, 256), flow_widths=(64, 64, 256),
                       encode_widths=(64, 64, 256, 256)),
    "test2": dict(hr_ch=192, stage_a="feat_rel_pe", stage_b="hr_pe",
                  stage_d="two_hr", encode_out=3, fold=False,
                  feat_widths=(64, 64, 256), flow_widths=(64, 64, 256),
                  encode_widths=(64, 64, 256, 256)),
}
_PRESETS["nomul"] = dict(_PRESETS["test4"])


def make_ablation(preset: str, **overrides) -> LunaTokisAblation:
    cfg = dict(_PRESETS[preset])
    cfg.update(overrides)
    return LunaTokisAblation(**cfg)


for _name in _PRESETS:
    register_model(f"LIIF_{_name}")(functools.partial(make_ablation, _name))
