"""LunaTokis family variants (port of
``stif_tpu/models/luna_tokis_variants.py``).

- ``LunaTokisZSM``: the fixed-x4 Zooming-Slow-Mo model: the shared encoder
  and a pixel-shuffle x4 head over every time step, no continuous decoder.
- ``LunaTokisTrain``: the training variant: ``feat_imnet`` 200 -> 128 (no
  time code in stage A), ``flow_imnet`` 329 -> 4 (every stage-B gather
  nearest, plus relative coordinates and time), ``encode_imnet`` 652 -> 27
  (no time code), assembled by a 3x3 overlap-add fold.
- ``LunaTokisS``: no ``feat_imnet``: the flow comes straight from the
  encoder features (201 -> 4) and RGB from the two warped samples of the
  encoder features and of the bilinear x4 input (396 -> 3).
- ``LunaTokisNoFlow``: one SIREN (201 -> 3) decodes RGB from the stage-A
  features: no flow, no warp.

(Widths at nf = 64 and an input pair.) All share the encoder of
``LunaTokis``, held in an ``encoder`` submodule as in the JAX parameter
trees. A flax SIREN infers its input width at the first call; here it is
fixed at construction from ``nf`` and ``n_inputs``, the number of input
frames N (the input-frame field has 3N channels). ``fused`` is the JAX
package's ``use_pallas`` and defaults to True as in the port's ``LunaTokis``:
the SIREN nets run the fused kernel (forward only: a training loop builds
its model with ``fused=False``), and get their fields as a list of views
that the kernel reads in place, never concatenated here.

``LunaTokisTrain.decode`` marks the flagship's stages (``utils/trace.py``):
``decode`` with ``decode.prep``, ``decode.ab`` (the stage-A gather, stages A
and B), ``decode.cd`` (stages C and D) and ``decode.fold`` (the overlap-add).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from stif_tpu_torch.models.luna_tokis import _times_nb, add_encoder, encode
from stif_tpu_torch.models.registry import register_model
from stif_tpu_torch.nn.blocks import Conv, lrelu
from stif_tpu_torch.nn.siren import Siren
from stif_tpu_torch.ops.constants import vector
from stif_tpu_torch.ops.coords import make_coord_cached
from stif_tpu_torch.ops.fold import fold3x3
from stif_tpu_torch.ops.grid_sample import grid_sample
from stif_tpu_torch.ops.pixel_shuffle import pixel_shuffle
from stif_tpu_torch.ops.resize import resize_bilinear
from stif_tpu_torch.ops.warp import warp_grid
from stif_tpu_torch.utils.trace import mark

_EPS = 1e-6


class _Encoder(nn.Module):
    """The shared LunaTokis encoder (``gen_feat``)."""

    def __init__(self, nf: int = 64, groups: int = 8, front_RBs: int = 5,
                 back_RBs: int = 40):
        super().__init__()
        add_encoder(self, nf, groups, front_RBs, back_RBs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return encode(self, x)


class Queries:
    """What every variant's decoder starts from, for one regular (HH, WW)
    query grid over features ``feat`` (B, H, W, 3nf) and input frames
    ``inp_cat`` (B, H, W, 3N):

    - ``cxy`` (B, Q, 2): the clamped query coordinates, (x, y) order;
    - ``base`` (B, Q, 3nf + 3N + 2): the nearest LR feature, the nearest
      input sample and the relative coordinates, in that column order (one
      fused gather; the nets read column slices of it in place);
    - ``pe`` (nt, B, Q, 1): the query times, contiguous;
    - ``tile_t`` / ``tile_b``: a (B, ...) tensor broadcast over the times as
      a (nt, B, ...) view, or as a (nt*B, ...) gather source.
    """

    def __init__(self, feat: torch.Tensor, inp_cat: torch.Tensor, times,
                 HH: int, WW: int):
        B, H, W, nfc = feat.shape
        dev = feat.device
        self.nfc, self.nic = nfc, inp_cat.shape[-1]
        self.Q = HH * WW
        coord = make_coord_cached((HH, WW), device=dev).clamp(-1 + _EPS,
                                                              1 - _EPS)
        coord = coord[None].expand(B, self.Q, 2)
        self.cxy = coord.flip(-1)
        feat_coord = make_coord_cached((H, W), flatten=False, device=dev)
        feat_coord = feat_coord[None].expand(B, H, W, 2)
        q = grid_sample(torch.cat([feat, inp_cat, feat_coord], -1), self.cxy,
                        mode="nearest")
        rel = (coord - q[..., nfc + self.nic:]) * vector(
            H, W, dtype=coord.dtype, device=dev)
        self.base = torch.cat([q[..., :nfc + self.nic], rel], -1)
        t_nb = _times_nb(times, B, dev)
        self.nt, self.B = t_nb.shape[0], B
        self.pe = t_nb[:, :, None, None].expand(
            self.nt, B, self.Q, 1).contiguous()

    def tile_t(self, v: torch.Tensor) -> torch.Tensor:
        return v.expand(self.nt, *v.shape)

    def tile_b(self, v: torch.Tensor) -> torch.Tensor:
        return self.tile_t(v).reshape(self.nt * self.B, *v.shape[1:])

    def warp_grids(self, flow_q: torch.Tensor, HH: int, WW: int):
        """The two clamped stage-C sample grids (nt*B, Q, 2) of a flow
        (nt, B, Q, 4)."""
        flow = flow_q.reshape(self.nt * self.B, HH, WW, 4)
        return tuple(
            warp_grid(f).clamp(-1 + _EPS, 1 - _EPS).reshape(
                self.nt * self.B, self.Q, 2)
            for f in (flow[..., :2], flow[..., 2:]))


def _prep(feat_t: torch.Tensor, inp: torch.Tensor, out_size):
    """The first 3 temporal feature maps (B, H, W, 3nf), channel order
    t*nf + c, the input frames (B, H, W, 3N), channel order n*3 + c, and
    the query grid's size (default x4)."""
    B, _, H, W, _ = feat_t.shape
    feat = feat_t[:, :3].permute(0, 2, 3, 1, 4).reshape(B, H, W, -1)
    inp_cat = inp.permute(0, 2, 3, 1, 4).reshape(B, H, W, -1)
    HH, WW = out_size if out_size is not None else (4 * H, 4 * W)
    return feat, inp_cat, HH, WW


@register_model("LunaTokisZSM")
class LunaTokisZSM(nn.Module):
    """Fixed-x4 ZSM: (B, N, H, W, 3) -> (B, 2N-1, 4H, 4W, 3)."""

    def __init__(self, nf: int = 64, nframes: int = 3, groups: int = 8,
                 front_RBs: int = 5, back_RBs: int = 40):
        super().__init__()
        self.encoder = _Encoder(nf, groups, front_RBs, back_RBs)
        self.upconv1 = Conv(nf, nf * 4, 3, 1, 1)
        self.upconv2 = Conv(nf, 64 * 4, 3, 1, 1)
        self.HRconv = Conv(64, 64, 3, 1, 1)
        self.conv_last = Conv(64, 3, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.encoder(x)
        B, T, H, W, C = feat.shape
        z = feat.reshape(B * T, H, W, C)
        z = lrelu(pixel_shuffle(self.upconv1(z), 2))
        z = lrelu(pixel_shuffle(self.upconv2(z), 2))
        z = self.conv_last(lrelu(self.HRconv(z)))
        return z.reshape(B, T, 4 * H, 4 * W, 3)


@register_model("LunaTokisTrain")
class LunaTokisTrain(nn.Module):
    """Training variant: the fold-27 patch decoder."""

    def __init__(self, nf: int = 64, nframes: int = 7, groups: int = 8,
                 front_RBs: int = 5, back_RBs: int = 40, fused: bool = True,
                 n_inputs: int = 2):
        super().__init__()
        self.encoder = _Encoder(nf, groups, front_RBs, back_RBs)
        base = 3 * nf + 3 * n_inputs + 2  # LR feature, input, rel coords
        self.feat_imnet = Siren(base, [64, 64, 64, 256], 3, 128, fused=fused)
        self.flow_imnet = Siren(128 + base + 1, [64, 64, 64, 256], 3, 4,
                                fused=fused)
        self.encode_imnet = Siren(2 * (128 + base - 2),
                                  [64, 64, 64, 256, 256], 4, 27, fused=fused)

    def gen_feat(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)

    def decode(self, feat_t, inp, times, out_size=None) -> torch.Tensor:
        dev = feat_t.device
        with mark("decode", dev):
            with mark("decode.prep", dev):
                feat, inp_cat, HH, WW = _prep(feat_t, inp, out_size)
            with mark("decode.ab", dev):
                q = Queries(feat, inp_cat, times, HH, WW)
                nt, B, Q = q.nt, q.B, q.Q
                base = q.tile_t(q.base)
                # stage A (no time code)
                hrfeat = self.feat_imnet([base]).reshape(nt * B, HH, WW, -1)
                # stage B: the HR field at its own cell centres, nearest,
                # then the nearest LR samples, the relative coordinates and
                # the time
                q_feat_b = grid_sample(
                    hrfeat, q.tile_t(q.cxy).reshape(nt * B, Q, 2),
                    mode="nearest").reshape(nt, B, Q, -1)
                flow_q = self.flow_imnet([q_feat_b, base, q.pe])
                del q_feat_b
            with mark("decode.cd", dev):
                g1, g2 = q.warp_grids(flow_q, HH, WW)
                # stage C: the equal-resolution LR sources in one gather per
                # grid
                lr_c = q.tile_b(torch.cat([feat, inp_cat], -1))
                c1 = grid_sample(lr_c, g1)
                c2 = grid_sample(lr_c, g2)
                q_feat1 = grid_sample(hrfeat, g1)
                q_feat2 = grid_sample(hrfeat, g2)
                # stage D (no time code): [q_feat1, q_feat3, q_inp1, q_feat2,
                # q_feat4, q_inp2] -> 27
                patches = self.encode_imnet([q_feat1, c1, q_feat2, c2])
            with mark("decode.fold", dev):
                rgb = fold3x3(patches.reshape(nt * B, HH, WW, 27))
            return rgb.reshape(nt, B, HH, WW, 3)

    def forward(self, x, times, out_size=None) -> torch.Tensor:
        """(B, N, H, W, 3), times (nt,) or (B, nt) -> (nt, B, HH, WW, 3)."""
        return self.decode(self.encoder(x), x, times, out_size)


@register_model("LunaTokisS")
class LunaTokisS(nn.Module):
    """No ``feat_imnet``: flow from the encoder features, RGB from the two
    warped encoder-feature and image samples (no time code in stage D); the
    HR input is the bilinear x4 upsample."""

    def __init__(self, nf: int = 64, nframes: int = 6, groups: int = 8,
                 front_RBs: int = 5, back_RBs: int = 40, fused: bool = True,
                 n_inputs: int = 2):
        super().__init__()
        self.encoder = _Encoder(nf, groups, front_RBs, back_RBs)
        nfc, nic = 3 * nf, 3 * n_inputs
        self.flow_imnet = Siren(nfc + nic + 3, [64, 64, 256], 2, 4,
                                fused=fused)
        self.encode_imnet = Siren(2 * (nfc + nic), [64, 64, 256, 256], 3, 3,
                                  fused=fused)

    def forward(self, x, times, out_size=None) -> torch.Tensor:
        feat, inp_cat, HH, WW = _prep(self.encoder(x), x, out_size)
        q = Queries(feat, inp_cat, times, HH, WW)
        flow_q = self.flow_imnet([q.tile_t(q.base), q.pe])
        g1, g2 = q.warp_grids(flow_q, HH, WW)
        hr_inp = resize_bilinear(inp_cat, scale_factor=4, align_corners=False)
        feat_tl, hr_tl = q.tile_b(feat), q.tile_b(hr_inp)
        q_feat3 = grid_sample(feat_tl, g1)
        q_feat4 = grid_sample(feat_tl, g2)
        q_img1 = grid_sample(hr_tl, g1)
        q_img2 = grid_sample(hr_tl, g2)
        rgb = self.encode_imnet([q_feat3, q_feat4, q_img1, q_img2])
        return rgb.reshape(q.nt, q.B, HH, WW, 3)


@register_model("LunaTokisNoFlow")
class LunaTokisNoFlow(nn.Module):
    """Pure LIIF: a single SIREN decodes RGB over the first 3 feature maps."""

    def __init__(self, nf: int = 64, nframes: int = 6, groups: int = 8,
                 front_RBs: int = 5, back_RBs: int = 40, fused: bool = True,
                 n_inputs: int = 2):
        super().__init__()
        self.encoder = _Encoder(nf, groups, front_RBs, back_RBs)
        self.feat_imnet = Siren(3 * nf + 3 * n_inputs + 3,
                                [64, 64, 256, 256, 256], 4, 3, fused=fused)

    def forward(self, x, times, out_size=None) -> torch.Tensor:
        feat, inp_cat, HH, WW = _prep(self.encoder(x), x, out_size)
        q = Queries(feat, inp_cat, times, HH, WW)
        rgb = self.feat_imnet([q.tile_t(q.base), q.pe])
        return rgb.reshape(q.nt, q.B, HH, WW, 3)
