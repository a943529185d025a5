"""LunaTokis, the continuous space-time SR model (port of
``stif_tpu/models/luna_tokis.py``, serving path).

The module tree follows the reference ``.pth`` schema, so trained weights
load with ``load_state_dict(strict=True)``. Public layouts are the JAX
package's: input (B, N, H, W, 3), features (B, 2N-1, H, W, nf), output
(nt, B, HH, WW, 3).

  encoder (``gen_feat``): conv_first -> front residual blocks -> L2/L3
    strided pyramid -> PCD alignment of the pair -> bidirectional
    deformable ConvLSTM -> recon trunk.
  decoder (``decode``, full (HH, WW) grid):
    stage A: nearest-gather LR features + rel coords + time -> feat_imnet
    stage B: (HR feature, bilinear LR feature, input) -> flow_imnet
    stage C: two warp grids from the flow; bilinear gathers at both
    stage D: encode_imnet -> RGB, plus the rgb_skip blend.
  The query-time axis rides in front of the batch axis: every stage runs
  once for all (time, batch) pairs. The three SIREN nets run through the
  fused kernel (``stif_tpu_torch.ops.siren_fused``).

Not ported yet: the local ensemble, ``test`` (``decoding_test``) mode,
explicit query windows (``decode_zoom``), the chunked decode stages and the
bf16 / split-K / stage-C knobs.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from stif_tpu_torch.nn.blocks import Conv, ResidualTrunk, lrelu
from stif_tpu_torch.nn.convlstm import BiDeformableConvLSTM
from stif_tpu_torch.nn.pcd import PCDAlign
from stif_tpu_torch.nn.siren import Siren
from stif_tpu_torch.ops.coords import make_coord
from stif_tpu_torch.ops.grid_sample import grid_sample
from stif_tpu_torch.ops.pixel_shuffle import pixel_shuffle
from stif_tpu_torch.ops.resize import imresize_to
from stif_tpu_torch.ops.warp import warp_grid

_EPS = 1e-6


def _times_nb(times, B: int, device) -> torch.Tensor:
    """Query times as (nt, B): ``times`` is (nt,), shared by the batch, or
    per-sample (B, nt)."""
    t = torch.as_tensor(times, dtype=torch.float32, device=device)
    if t.dim() == 2:
        return t.t()
    return t.reshape(-1, 1).expand(t.numel(), B)


class LunaTokis(nn.Module):
    def __init__(self, nf: int = 64, nframes: int = 6, groups: int = 8,
                 front_RBs: int = 5, back_RBs: int = 40,
                 rgb_skip: bool = False, rgb_skip_bicubic: bool = False):
        super().__init__()
        self.nf = nf
        self.nframes = nframes
        self.rgb_skip = rgb_skip
        self.rgb_skip_bicubic = rgb_skip_bicubic
        self.conv_first = Conv(3, nf, 3, 1, 1)
        self.feature_extraction = ResidualTrunk(nf, front_RBs)
        self.fea_L2_conv1 = Conv(nf, nf, 3, 2, 1)
        self.fea_L2_conv2 = Conv(nf, nf, 3, 1, 1)
        self.fea_L3_conv1 = Conv(nf, nf, 3, 2, 1)
        self.fea_L3_conv2 = Conv(nf, nf, 3, 1, 1)
        self.pcd_align = PCDAlign(nf, groups)
        self.fusion = Conv(2 * nf, nf, 1, 1, 0)
        self.ConvBLSTM = BiDeformableConvLSTM(nf, groups)
        self.recon_trunk = ResidualTrunk(nf, back_RBs)
        # legacy ZSM x4 pixel-shuffle head (part of the checkpoint schema)
        self.upconv1 = Conv(nf, nf * 4, 3, 1, 1)
        self.upconv2 = Conv(nf, 64 * 4, 3, 1, 1)
        self.HRconv = Conv(64, 64, 3, 1, 1)
        self.conv_last = Conv(64, 3, 3, 1, 1)
        # continuous decoder; input widths for an input pair (N = 2):
        # feat 3nf + 6 + 2 + 1, flow 64 + 3nf + 6 + 1,
        # encode 64 + 64 + 3nf + 3nf + 6 + 6 + 1
        self.feat_imnet = Siren(3 * nf + 9, [64, 64, 256], 2, 64)
        self.flow_imnet = Siren(3 * nf + 71, [64, 64, 256], 2, 4)
        self.encode_imnet = Siren(6 * nf + 141, [64, 64, 256, 256], 3, 3)

    # ---------------------------------------------------------------- encoder

    def gen_feat(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, N, H, W, 3) -> features (B, 2N-1, H, W, nf)."""
        B, N, H, W, C = x.shape
        l1 = lrelu(self.conv_first(x.reshape(B * N, H, W, C)))
        l1 = self.feature_extraction(l1)
        l2 = lrelu(self.fea_L2_conv2(lrelu(self.fea_L2_conv1(l1))))
        l3 = lrelu(self.fea_L3_conv2(lrelu(self.fea_L3_conv1(l2))))
        l1 = l1.reshape(B, N, H, W, -1)
        l2 = l2.reshape(B, N, H // 2, W // 2, -1)
        l3 = l3.reshape(B, N, H // 4, W // 4, -1)

        seq = []
        for idx in range(N - 1):
            fea1 = [l1[:, idx], l2[:, idx], l3[:, idx]]
            fea2 = [l1[:, idx + 1], l2[:, idx + 1], l3[:, idx + 1]]
            fused = self.fusion(self.pcd_align(fea1, fea2))
            if idx == 0:
                seq.append(fea1[0])
            seq.append(fused)
            seq.append(fea2[0])
        feats = self.ConvBLSTM(torch.stack(seq, 1))  # (B, 2N-1, H, W, nf)
        B2, T, Hf, Wf, Cf = feats.shape
        out = self.recon_trunk(feats.reshape(B2 * T, Hf, Wf, Cf))
        return out.reshape(B2, T, Hf, Wf, Cf)

    # ---------------------------------------------------------------- decoder

    def _decode_prep(self, feat_t: torch.Tensor, inp: torch.Tensor):
        """The first 3 temporal feature maps, channel order t*nf + c, and the
        input frames, channel order n*3 + c, both (B, H, W, .)."""
        B, _, H, W, _ = feat_t.shape
        feat = feat_t[:, :3].permute(0, 2, 3, 1, 4).reshape(B, H, W, -1)
        N = inp.shape[1]
        inp_cat = inp.permute(0, 2, 3, 1, 4).reshape(B, H, W, N * 3)
        return feat, inp_cat

    def _skip_source(self, inp_cat: torch.Tensor, out_size):
        """(B, HH, WW, 6) MATLAB-bicubic upsample of the [first, last] input
        frames when ``rgb_skip_bicubic`` applies, else None."""
        if not (self.rgb_skip and self.rgb_skip_bicubic):
            return None
        src = torch.cat([inp_cat[..., :3], inp_cat[..., -3:]], -1)
        return imresize_to(src, out_size)

    def _decode_pass(self, feat, inp_cat, coord, times, HH: int, WW: int,
                     skip_hr=None) -> torch.Tensor:
        """One decode pass over the full (HH, WW) query grid ``coord``
        (B, Q, 2) in (y, x) order. Returns (nt, B, HH, WW, 3)."""
        B, H, W = feat.shape[:3]
        dev = feat.device
        coord_xy = coord.flip(-1)  # grid_sample wants (x, y)
        feat_coord = make_coord((H, W), flatten=False, device=dev)
        feat_coord = feat_coord[None].expand(B, H, W, 2)

        # stage A gathers: every LR field sampled at the same grid, at once
        nfc, nic = feat.shape[-1], inp_cat.shape[-1]
        q_a = grid_sample(torch.cat([feat, inp_cat, feat_coord], -1),
                          coord_xy, mode="nearest")
        q_coord = q_a[..., nfc + nic:]
        rel = (coord - q_coord) * torch.tensor([H, W], dtype=coord.dtype,
                                               device=dev)
        base_a = torch.cat([q_a[..., :nfc + nic], rel], -1)  # (B, Q, 3nf+8)
        # stage B gathers of the time-independent LR fields
        lr_cat = torch.cat([feat, inp_cat], -1)
        q_b = grid_sample(lr_cat, coord_xy, mode="bilinear")
        q_feat0_b, q_inp_b = q_b[..., :nfc], q_b[..., nfc:]

        t_nb = _times_nb(times, B, dev)
        nt = t_nb.shape[0]
        Q = HH * WW

        def tile_t(v):  # (B, ...) -> (nt, B, ...), a broadcast view
            return v.expand(nt, *v.shape)

        pe = t_nb[:, :, None, None].expand(nt, B, Q, 1).contiguous()

        # stage A: HR feature field (nt, B, Q, 64)
        hrfeat_q = self.feat_imnet([tile_t(base_a), pe])
        # stage B: on the full grid the nearest re-sample of the HR field at
        # its own cell centres is the identity, so it is skipped
        flow_q = self.flow_imnet([hrfeat_q, tile_t(q_feat0_b),
                                  tile_t(q_inp_b), pe])
        flow = flow_q.reshape(nt * B, HH, WW, 4)
        # stage C: warp grids, then one gather per grid of the
        # equal-resolution LR sources and one of the HR feature field
        g1 = warp_grid(flow[..., :2]).clamp(-1 + _EPS, 1 - _EPS)
        g2 = warp_grid(flow[..., 2:]).clamp(-1 + _EPS, 1 - _EPS)
        g1 = g1.reshape(nt * B, Q, 2)
        g2 = g2.reshape(nt * B, Q, 2)
        lr_c = tile_t(lr_cat).reshape(nt * B, H, W, -1)
        hrfeat = hrfeat_q.reshape(nt * B, HH, WW, -1)
        c1 = grid_sample(lr_c, g1)
        c2 = grid_sample(lr_c, g2)
        q_feat1 = grid_sample(hrfeat, g1)
        q_feat2 = grid_sample(hrfeat, g2)
        q_img1, q_img2 = c1[..., nfc:], c2[..., nfc:]
        pe = pe.reshape(nt * B, Q, 1)
        # stage D: RGB
        rgb = self.encode_imnet([q_feat1, q_feat2, c1[..., :nfc],
                                 c2[..., :nfc], q_img1, q_img2, pe])
        if self.rgb_skip:
            if skip_hr is not None:
                s1 = grid_sample(
                    tile_t(skip_hr[..., :3]).reshape(nt * B, HH, WW, 3), g1)
                s2 = grid_sample(
                    tile_t(skip_hr[..., 3:]).reshape(nt * B, HH, WW, 3), g2)
            else:
                s1, s2 = q_img1[..., :3], q_img2[..., -3:]
            rgb = rgb + (1.0 - pe) * s1 + pe * s2
        return rgb.reshape(nt, B, HH, WW, 3)

    def decode(self, feat_t: torch.Tensor, inp: torch.Tensor, times,
               out_size=None) -> torch.Tensor:
        """Continuous decode of the full (HH, WW) grid (default (4H, 4W)) at
        query times (nt,) or (B, nt) in [0, 1]. Returns (nt, B, HH, WW, 3)."""
        feat, inp_cat = self._decode_prep(feat_t, inp)
        B, H, W = feat.shape[:3]
        HH, WW = out_size if out_size is not None else (4 * H, 4 * W)
        coord = make_coord((HH, WW), device=feat.device)
        coord = coord.clamp(-1 + _EPS, 1 - _EPS)[None].expand(B, HH * WW, 2)
        skip_hr = self._skip_source(inp_cat, (HH, WW))
        return self._decode_pass(feat, inp_cat, coord, times, HH, WW,
                                 skip_hr=skip_hr)

    def decode_pixelshuffle(self, feat_t: torch.Tensor) -> torch.Tensor:
        """Legacy ZSM fixed-x4 head over every time step:
        (B, T, H, W, nf) -> (B, T, 4H, 4W, 3)."""
        B, T, H, W, C = feat_t.shape
        x = feat_t.reshape(B * T, H, W, C)
        x = lrelu(pixel_shuffle(self.upconv1(x), 2))
        x = lrelu(pixel_shuffle(self.upconv2(x), 2))
        x = self.conv_last(lrelu(self.HRconv(x)))
        return x.reshape(B, T, 4 * H, 4 * W, 3)

    def forward(self, x: torch.Tensor, times, out_size=None) -> torch.Tensor:
        """(B, N, H, W, 3), times (nt,) or (B, nt) -> (nt, B, HH, WW, 3)."""
        return self.decode(self.gen_feat(x), x, times, out_size=out_size)
