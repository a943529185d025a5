"""LunaTokis, the continuous space-time SR model (port of
``stif_tpu/models/luna_tokis.py``, serving path).

The module tree follows the reference ``.pth`` schema, so trained weights
load with ``load_state_dict(strict=True)``. Public layouts are the JAX
package's: input (B, N, H, W, 3), features (B, 2N-1, H, W, nf), output
(nt, B, HH, WW, 3).

  encoder (``gen_feat``): conv_first -> front residual blocks -> L2/L3
    strided pyramid -> PCD alignment of the pair -> bidirectional
    deformable ConvLSTM -> recon trunk.
  decoder (``decode``: the full (HH, WW) grid, or an explicit window):
    stage A: nearest-gather LR features + rel coords + time -> feat_imnet
    stage B: (HR feature, bilinear LR feature, input) -> flow_imnet
    stage C: two warp grids from the flow; bilinear gathers at both
    stage D: encode_imnet -> RGB, plus the rgb_skip blend.
  The query-time axis rides in front of the batch axis: every stage runs
  once for all (time, batch) pairs. The three SIREN nets run through the
  fused kernel (``stif_tpu_torch.ops.siren_fused``) unless ``mlp_dtype``
  or ``fused=False`` says otherwise.
  ``decode_chunk_ab`` / ``decode_chunk_cd`` are the same stages per query
  chunk, for frames too large to decode whole
  (``stif_tpu_torch.runtime.chunked``).

Not ported: ``lstm_unroll`` and ``lstm_fuse_dirs`` (ways to run the same
math on a TPU) and the mesh.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from stif_tpu_torch.models.registry import register_model
from stif_tpu_torch.nn.blocks import Conv, ResidualTrunk, lrelu, remat
from stif_tpu_torch.nn.convlstm import BiDeformableConvLSTM
from stif_tpu_torch.nn.pcd import PCDAlign
from stif_tpu_torch.nn.siren import Siren
from stif_tpu_torch.ops.coords import make_coord, make_coord_demo
from stif_tpu_torch.ops.grid_sample import grid_sample
from stif_tpu_torch.ops.pixel_shuffle import pixel_shuffle
from stif_tpu_torch.ops.resize import imresize_to, resize_bilinear
from stif_tpu_torch.ops.warp import warp_grid

_EPS = 1e-6


def _times_nb(times, B: int, device) -> torch.Tensor:
    """Query times as (nt, B): ``times`` is (nt,), shared by the batch, or
    per-sample (B, nt)."""
    t = torch.as_tensor(times, dtype=torch.float32, device=device)
    if t.dim() == 2:
        return t.t()
    return t.reshape(-1, 1).expand(t.numel(), B)


def add_encoder(m: nn.Module, nf: int, groups: int, front_RBs: int,
                back_RBs: int, gather_dtype=None) -> None:
    """Give ``m`` the encoder's submodules under the reference schema's
    names. ``LunaTokis`` holds them itself; the variants hold them in an
    ``encoder`` submodule, as the JAX trees do."""
    m.conv_first = Conv(3, nf, 3, 1, 1)
    m.feature_extraction = ResidualTrunk(nf, front_RBs)
    m.fea_L2_conv1 = Conv(nf, nf, 3, 2, 1)
    m.fea_L2_conv2 = Conv(nf, nf, 3, 1, 1)
    m.fea_L3_conv1 = Conv(nf, nf, 3, 2, 1)
    m.fea_L3_conv2 = Conv(nf, nf, 3, 1, 1)
    m.pcd_align = PCDAlign(nf, groups, gather_dtype)
    m.fusion = Conv(2 * nf, nf, 1, 1, 0)
    m.ConvBLSTM = BiDeformableConvLSTM(nf, groups, gather_dtype)
    m.recon_trunk = ResidualTrunk(nf, back_RBs)


def encode(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The encoder (``gen_feat``) over the submodules ``add_encoder`` gave
    ``m``: x (B, N, H, W, 3) -> features (B, 2N-1, H, W, nf)."""
    B, N, H, W, C = x.shape
    l1 = lrelu(m.conv_first(x.reshape(B * N, H, W, C)))
    l1 = m.feature_extraction(l1)
    l2 = lrelu(m.fea_L2_conv2(lrelu(m.fea_L2_conv1(l1))))
    l3 = lrelu(m.fea_L3_conv2(lrelu(m.fea_L3_conv1(l2))))
    l1 = l1.reshape(B, N, H, W, -1)
    l2 = l2.reshape(B, N, H // 2, W // 2, -1)
    l3 = l3.reshape(B, N, H // 4, W // 4, -1)

    seq = []
    for idx in range(N - 1):
        fea1 = [l1[:, idx], l2[:, idx], l3[:, idx]]
        fea2 = [l1[:, idx + 1], l2[:, idx + 1], l3[:, idx + 1]]
        fused = m.fusion(m.pcd_align(fea1, fea2))
        if idx == 0:
            seq.append(fea1[0])
        seq.append(fused)
        seq.append(fea2[0])
    feats = m.ConvBLSTM(torch.stack(seq, 1))  # (B, 2N-1, H, W, nf)
    B2, T, Hf, Wf, Cf = feats.shape
    out = m.recon_trunk(feats.reshape(B2 * T, Hf, Wf, Cf))
    return out.reshape(B2, T, Hf, Wf, Cf)


@register_model("LunaTokis")
class LunaTokis(nn.Module):
    """Constructor knobs beyond the architecture (all default to the fp32
    reference semantics; none changes the parameter schema):

    - ``rgb_skip``: stage D predicts a residual over the time-blended warped
      input samples; ``rgb_skip_bicubic``: the skip term is gathered from a
      MATLAB-bicubic pre-upsample of the input frames (full-grid decodes).
    - ``fused``: the SIREN nets run the fused kernel (the JAX package's
      ``use_pallas``); False runs the plain version.
    - ``gather_dtype`` (e.g. ``torch.bfloat16``): the source of the DCN
      gathers and of the decoder's bilinear gathers is rounded to it;
      interpolation stays fp32.
    - ``mlp_dtype``: the SIREN nets' ``compute_dtype``; takes them off the
      fused kernel.
    - ``encode_splitk``: split-K first layer of ``encode_imnet``
      (``Siren.split_first``); an error together with ``fused``.
    - ``stagec_dedup``: gather the time-independent stage-C LR source once
      with the time axis folded into the queries; bit-identical.
    - ``stagec_nearest``: the wide LR feature component of stage C by a
      nearest gather; an approximation, and it skips the dedup fold.
    - ``stagec_dtype`` (e.g. ``torch.float8_e4m3fn``): overrides
      ``gather_dtype`` for the decoder's bilinear gathers.

    The nearest gathers ignore both dtypes, and the stage-C knobs do not
    apply in test mode (``hr_inp`` at HR resolution).
    """

    def __init__(self, nf: int = 64, nframes: int = 6, groups: int = 8,
                 front_RBs: int = 5, back_RBs: int = 40,
                 rgb_skip: bool = False, rgb_skip_bicubic: bool = False,
                 fused: bool = True, gather_dtype=None, mlp_dtype=None,
                 encode_splitk: bool = False, stagec_dedup: bool = False,
                 stagec_nearest: bool = False, stagec_dtype=None):
        super().__init__()
        self.nf = nf
        self.nframes = nframes
        self.rgb_skip = rgb_skip
        self.rgb_skip_bicubic = rgb_skip_bicubic
        self.gather_dtype = gather_dtype
        self.stagec_dedup = stagec_dedup
        self.stagec_nearest = stagec_nearest
        self.stagec_dtype = stagec_dtype
        add_encoder(self, nf, groups, front_RBs, back_RBs, gather_dtype)
        # legacy ZSM x4 pixel-shuffle head (part of the checkpoint schema)
        self.upconv1 = Conv(nf, nf * 4, 3, 1, 1)
        self.upconv2 = Conv(nf, 64 * 4, 3, 1, 1)
        self.HRconv = Conv(64, 64, 3, 1, 1)
        self.conv_last = Conv(64, 3, 3, 1, 1)
        # continuous decoder; input widths for an input pair (N = 2):
        # feat 3nf + 6 + 2 + 1, flow 64 + 3nf + 6 + 1,
        # encode 64 + 64 + 3nf + 3nf + 6 + 6 + 1
        kw = dict(fused=fused, compute_dtype=mlp_dtype)
        self.feat_imnet = Siren(3 * nf + 9, [64, 64, 256], 2, 64, **kw)
        self.flow_imnet = Siren(3 * nf + 71, [64, 64, 256], 2, 4, **kw)
        self.encode_imnet = Siren(6 * nf + 141, [64, 64, 256, 256], 3, 3,
                                  split_first=encode_splitk, **kw)

    # ---------------------------------------------------------------- encoder

    def gen_feat(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, N, H, W, 3) -> features (B, 2N-1, H, W, nf)."""
        return encode(self, x)

    # ---------------------------------------------------------------- decoder

    def _gs_b(self, v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """The decoder's bilinear gather (stages B and C): the source is
        rounded to ``stagec_dtype``, else ``gather_dtype``, when one is set;
        the interpolation stays fp32."""
        return grid_sample(v, g, mode="bilinear",
                           source_dtype=self.stagec_dtype or self.gather_dtype)

    def _decode_prep(self, feat_t: torch.Tensor, inp: torch.Tensor,
                     hr_inp_upsample: bool = False):
        """The first 3 temporal feature maps, channel order t*nf + c, the
        input frames, channel order n*3 + c, both (B, H, W, .), and the
        decoder's input-frame source ``hr_inp``: the input frames, or their
        bilinear x4 upsample (``align_corners=False``) in test mode."""
        B, _, H, W, _ = feat_t.shape
        feat = feat_t[:, :3].permute(0, 2, 3, 1, 4).reshape(B, H, W, -1)
        N = inp.shape[1]
        inp_cat = inp.permute(0, 2, 3, 1, 4).reshape(B, H, W, N * 3)
        hr_inp = (resize_bilinear(inp_cat, scale_factor=4, align_corners=False)
                  if hr_inp_upsample else inp_cat)
        return feat, inp_cat, hr_inp

    def _skip_source(self, inp_cat: torch.Tensor, out_size,
                     full_grid: bool = True):
        """(B, HH, WW, 6) MATLAB-bicubic upsample of the [first, last] input
        frames when ``rgb_skip_bicubic`` applies (full-grid decodes only: an
        explicit query window falls back to the LR skip), else None."""
        if not (self.rgb_skip and self.rgb_skip_bicubic and full_grid):
            return None
        src = torch.cat([inp_cat[..., :3], inp_cat[..., -3:]], -1)
        return imresize_to(src, out_size)

    def _rgb(self, fields, pe, q_img1, q_img2, skip_hr, g1, g2, tile_t):
        """Stage D: ``encode_imnet`` on the gathered fields, all
        (nt*B, Q, .), plus the time-blended skip term under ``rgb_skip``."""
        rgb = self.encode_imnet(list(fields) + [q_img1, q_img2, pe])
        if self.rgb_skip:
            if skip_hr is not None:
                s1 = self._gs_b(tile_t(skip_hr[..., :3]), g1)
                s2 = self._gs_b(tile_t(skip_hr[..., 3:]), g2)
            else:
                s1, s2 = q_img1[..., :3], q_img2[..., -3:]
            rgb = rgb + (1.0 - pe) * s1 + pe * s2
        return rgb

    def _decode_pass(self, feat, inp_cat, hr_inp, coord_q, coord_ref, times,
                     HH: int, WW: int, identity_b: bool = False,
                     skip_hr=None):
        """One decode pass over a regular (HH, WW) query window.

        ``coord_q``: (B, Q, 2) (y, x) gather coordinates, possibly shifted
        (local ensemble) and clamped; ``coord_ref``: (B, Q, 2) unshifted
        query coordinates, the reference of the relative coordinates;
        ``identity_b``: the window is the full grid, where stage B's nearest
        re-sample of the HR field at its own cell centres is the identity
        and is skipped; ``skip_hr``: optional (B, HH, WW, 6) bicubic skip
        source. Returns (rgb (nt, B, HH, WW, 3), area (B, Q)).

        The SIREN nets get their fields as views (broadcasts over the time
        axis, column slices of a fused gather), never concatenated here.
        """
        B, H, W = feat.shape[:3]
        dev = feat.device
        coord_xy = coord_q.flip(-1)  # grid_sample wants (x, y)
        feat_coord = make_coord((H, W), flatten=False, device=dev)
        feat_coord = feat_coord[None].expand(B, H, W, 2)

        # stage A gathers: every LR field sampled at the same grid, at once
        nfc, nic = feat.shape[-1], inp_cat.shape[-1]
        q_a = grid_sample(torch.cat([feat, inp_cat, feat_coord], -1),
                          coord_xy, mode="nearest")
        q_coord = q_a[..., nfc + nic:]
        rel = (coord_ref - q_coord) * torch.tensor(
            [H, W], dtype=coord_ref.dtype, device=dev)
        area = (rel[..., 0] * rel[..., 1]).abs() + 1e-9
        base_a = torch.cat([q_a[..., :nfc + nic], rel], -1)  # (B, Q, 3nf+8)

        # stage B gathers of the time-independent fields, one fused gather
        # when hr_inp is at LR resolution (the non-test path)
        same_res = hr_inp.shape[1:3] == feat.shape[1:3]
        if same_res:
            q_b = self._gs_b(torch.cat([feat, hr_inp], -1), coord_xy)
            q_feat0_b, q_inp_b = q_b[..., :nfc], q_b[..., nfc:]
        else:
            q_inp_b = self._gs_b(hr_inp, coord_xy)
            q_feat0_b = self._gs_b(feat, coord_xy)

        t_nb = _times_nb(times, B, dev)
        nt = t_nb.shape[0]
        Q = HH * WW

        def tile_t(v):  # (B, ...) -> (nt, B, ...), a broadcast view
            return v.expand(nt, *v.shape)

        def tile_b(v):  # (B, h, w, C) -> (nt*B, h, w, C), a gather source
            return tile_t(v).reshape(nt * B, *v.shape[1:])

        pe = t_nb[:, :, None, None].expand(nt, B, Q, 1).contiguous()

        # stage A: HR feature field (nt, B, Q, 64)
        hrfeat_q = self.feat_imnet([tile_t(base_a), pe])
        hrfeat = hrfeat_q.reshape(nt * B, HH, WW, -1)
        # stage B: flow
        if identity_b:
            q_feat_b = hrfeat_q
        else:
            q_feat_b = grid_sample(
                hrfeat, tile_t(coord_xy).reshape(nt * B, Q, 2),
                mode="nearest").reshape(nt, B, Q, -1)
        flow_q = self.flow_imnet([q_feat_b, tile_t(q_feat0_b),
                                  tile_t(q_inp_b), pe])
        flow = flow_q.reshape(nt * B, HH, WW, 4)
        # stage C: warp grids, then the gathers at both
        g1 = warp_grid(flow[..., :2]).clamp(-1 + _EPS, 1 - _EPS)
        g2 = warp_grid(flow[..., 2:]).clamp(-1 + _EPS, 1 - _EPS)
        g1 = g1.reshape(nt * B, Q, 2)
        g2 = g2.reshape(nt * B, Q, 2)
        pe = pe.reshape(nt * B, Q, 1)
        # the wide LR gathers come first, while the HR gathers' results do
        # not exist yet: a gather holds its result twice for a moment
        if same_res and not self.stagec_nearest:
            # equal-resolution LR sources fuse into one gather per grid
            lr_cat = torch.cat([feat, hr_inp], -1)
            if self.stagec_dedup:
                # the source does not depend on time: fold nt into the query
                # axis and gather once from the (B, ...) map
                def fold_q(g):   # (nt*B, Q, 2) -> (B, nt*Q, 2)
                    return (g.reshape(nt, B, Q, 2).transpose(0, 1)
                            .reshape(B, nt * Q, 2))

                def unfold_q(c):  # (B, nt*Q, C) -> (nt*B, Q, C)
                    return (c.reshape(B, nt, Q, -1).transpose(0, 1)
                            .reshape(nt * B, Q, -1))

                c1 = unfold_q(self._gs_b(lr_cat, fold_q(g1)))
                c2 = unfold_q(self._gs_b(lr_cat, fold_q(g2)))
            else:
                lr_c = tile_b(lr_cat)
                c1 = self._gs_b(lr_c, g1)
                c2 = self._gs_b(lr_c, g2)
            q_feat3, q_img1 = c1[..., :nfc], c1[..., nfc:]
            q_feat4, q_img2 = c2[..., :nfc], c2[..., nfc:]
        else:
            feat_tl, hr_inp_tl = tile_b(feat), tile_b(hr_inp)
            q_img1 = self._gs_b(hr_inp_tl, g1)
            q_img2 = self._gs_b(hr_inp_tl, g2)
            if same_res:
                # stagec_nearest: the wide feature component by a nearest
                # gather (no dedup fold, no source dtype); the 6-channel
                # inputs stay bilinear
                q_feat3 = grid_sample(feat_tl, g1, mode="nearest")
                q_feat4 = grid_sample(feat_tl, g2, mode="nearest")
            else:
                # hr_inp at HR resolution (test mode): the stage-C knobs
                # do not apply
                q_feat3 = self._gs_b(feat_tl, g1)
                q_feat4 = self._gs_b(feat_tl, g2)
        q_feat1 = self._gs_b(hrfeat, g1)
        q_feat2 = self._gs_b(hrfeat, g2)
        rgb = self._rgb([q_feat1, q_feat2, q_feat3, q_feat4], pe, q_img1,
                        q_img2, skip_hr, g1, g2, tile_b)
        return rgb.reshape(nt, B, HH, WW, 3), area

    def decode(self, feat_t: torch.Tensor, inp: torch.Tensor, times,
               out_size=None, hr_inp_upsample: bool = False,
               local_ensemble: bool = False, coords=None) -> torch.Tensor:
        """Continuous decode at query times (nt,) or (B, nt) in [0, 1].
        Returns (nt, B, HH, WW, 3).

        ``out_size``: the (HH, WW) grid, default (4H, 4W).
        ``hr_inp_upsample`` (test mode) feeds the decoder the bilinear x4
        upsample of the input frames. ``local_ensemble`` blends four decode
        passes at queries shifted by (+-rx, +-ry), weighted by the area of
        the diagonally opposite pass. ``coords`` is an explicit (Q, 2) (y, x)
        query window of shape ``out_size`` (see ``decode_zoom``).
        """
        feat, inp_cat, hr_inp = self._decode_prep(feat_t, inp, hr_inp_upsample)
        B, H, W = feat.shape[:3]
        if coords is None:
            HH, WW = out_size if out_size is not None else (4 * H, 4 * W)
            coord = make_coord((HH, WW), device=feat.device)
            coord = coord.clamp(-1 + _EPS, 1 - _EPS)
        else:
            HH, WW = out_size
            coord = torch.as_tensor(coords, dtype=torch.float32,
                                    device=feat.device)
        coord = coord[None].expand(B, HH * WW, 2)
        skip_hr = self._skip_source(inp_cat, (HH, WW), coords is None)

        if not local_ensemble:
            # with grad on, the pass is recomputed in the backward instead
            # of storing its gathered fields and SIREN activations (the JAX
            # package's ``nn.remat(pass_fn)``); the same maths either way
            rgb, _ = remat(self._decode_pass, feat, inp_cat, hr_inp, coord,
                           coord, times, HH, WW, identity_b=coords is None,
                           skip_hr=skip_hr)
            return rgb

        rx = 2.0 / H / 2.0
        ry = 2.0 / W / 2.0
        preds, areas = [], []
        for vx in (-1, 1):
            for vy in (-1, 1):
                shift = torch.tensor([vx * rx + _EPS, vy * ry + _EPS],
                                     dtype=coord.dtype, device=coord.device)
                coord_s = (coord + shift).clamp(-1 + _EPS, 1 - _EPS)
                rgb, area = self._decode_pass(feat, inp_cat, hr_inp, coord_s,
                                              coord, times, HH, WW,
                                              skip_hr=skip_hr)
                preds.append(rgb)
                areas.append(area)
        tot = areas[0] + areas[1] + areas[2] + areas[3]
        out = 0.0
        # each pass is weighted by the area of the diagonally opposite one
        for p, a in zip(preds, areas[::-1]):
            out = out + p * (a / tot).reshape(1, B, HH, WW, 1)
        return out

    # ------------------------------------------------- chunked decode stages
    #
    # Memory-bounded full-grid decoding for large frames: stages A+B run per
    # query chunk (self-contained: on the full grid stage B needs no
    # re-sample of the HR field), the full HR feature field is assembled
    # once, then stages C+D run per chunk, gathering from the full field.
    # Driven by ``stif_tpu_torch.runtime.chunked.ChunkedDecoder``.

    def decode_chunk_ab(self, feat, inp_cat, hr_inp, coord_chunk, times):
        """Stages A+B for one query chunk of the full grid.

        feat (B, H, W, 3nf), inp_cat (B, H, W, N*3), hr_inp, coord_chunk
        (B, Cq, 2) (y, x) -> (hrfeat (nt*B, Cq, 64), flow (nt*B, Cq, 4))."""
        B, H, W = feat.shape[:3]
        dev = feat.device
        cxy = coord_chunk.flip(-1)
        feat_coord = make_coord((H, W), flatten=False, device=dev)
        feat_coord = feat_coord[None].expand(B, H, W, 2)
        q_feat_a = grid_sample(feat, cxy, mode="nearest")
        q_inp_a = grid_sample(inp_cat, cxy, mode="nearest")
        q_coord = grid_sample(feat_coord, cxy, mode="nearest")
        rel = (coord_chunk - q_coord) * torch.tensor(
            [H, W], dtype=coord_chunk.dtype, device=dev)
        base_a = torch.cat([q_feat_a, q_inp_a, rel], -1)
        # these two gathers take gather_dtype only, as in the JAX package
        q_inp_b = grid_sample(hr_inp, cxy, source_dtype=self.gather_dtype)
        q_feat0_b = grid_sample(feat, cxy, source_dtype=self.gather_dtype)

        t_nb = _times_nb(times, B, dev)
        nt = t_nb.shape[0]
        Cq = coord_chunk.shape[1]

        def tile_t(v):
            return v.expand(nt, *v.shape)

        pe = t_nb[:, :, None, None].expand(nt, B, Cq, 1).contiguous()
        hrfeat = self.feat_imnet([tile_t(base_a), pe])
        flow = self.flow_imnet([hrfeat, tile_t(q_feat0_b), tile_t(q_inp_b),
                                pe])
        return hrfeat.reshape(nt * B, Cq, -1), flow.reshape(nt * B, Cq, -1)

    def decode_chunk_cd(self, hrfeat_full, feat, hr_inp, flow_chunk,
                        base_grid_chunk, times, out_size, skip_hr=None):
        """Stages C+D for one query chunk, gathering from the full HR field.

        hrfeat_full (nt*B, HH, WW, 64); flow_chunk (nt*B, Cq, 4);
        base_grid_chunk (Cq, 2): the ``align_corners=True`` lattice values
        (x, y) of this chunk's pixels on the full (HH, WW) canvas; skip_hr:
        optional (B, HH, WW, 6) bicubic skip source. Returns (nt*B, Cq, 3)."""
        HH, WW = out_size
        B = feat.shape[0]
        ntB, Cq = flow_chunk.shape[:2]
        nt = ntB // B

        def tile_b(v):  # (B, h, w, C) -> (nt*B, h, w, C)
            return v.expand(nt, *v.shape).reshape(ntB, *v.shape[1:])

        norm = torch.tensor([(WW - 1.0) / 2.0, (HH - 1.0) / 2.0],
                            dtype=flow_chunk.dtype, device=flow_chunk.device)
        g1 = base_grid_chunk[None] + flow_chunk[..., 0:2] / norm
        g2 = base_grid_chunk[None] + flow_chunk[..., 2:4] / norm
        g1 = g1.clamp(-1 + _EPS, 1 - _EPS)
        g2 = g2.clamp(-1 + _EPS, 1 - _EPS)
        feat_tl, hr_inp_tl = tile_b(feat), tile_b(hr_inp)
        q_img1 = self._gs_b(hr_inp_tl, g1)
        q_img2 = self._gs_b(hr_inp_tl, g2)
        if self.stagec_nearest and hr_inp.shape[1:3] == feat.shape[1:3]:
            # the same approximation, under the same condition, as the
            # full-grid pass
            q_feat3 = grid_sample(feat_tl, g1, mode="nearest")
            q_feat4 = grid_sample(feat_tl, g2, mode="nearest")
        else:
            q_feat3 = self._gs_b(feat_tl, g1)
            q_feat4 = self._gs_b(feat_tl, g2)
        q_feat1 = self._gs_b(hrfeat_full, g1)
        q_feat2 = self._gs_b(hrfeat_full, g2)
        t_nb = _times_nb(times, B, feat.device)
        pe = (t_nb[:, :, None, None].expand(nt, B, Cq, 1).contiguous()
              .reshape(ntB, Cq, 1))
        return self._rgb([q_feat1, q_feat2, q_feat3, q_feat4], pe, q_img1,
                         q_img2, skip_hr, g1, g2, tile_b)

    def decode_zoom(self, feat_t, inp, times, out_size, window, center,
                    hr_inp_upsample: bool = False) -> torch.Tensor:
        """Interactive zoom: render only a ``window``-shaped crop of the
        virtual (HH, WW) = ``out_size`` canvas, centred at normalised
        ``center`` (y, x). Returns (nt, B, window[0], window[1], 3)."""
        coords = make_coord_demo(out_size, window, center,
                                 device=feat_t.device)
        return self.decode(feat_t, inp, times, out_size=window,
                           hr_inp_upsample=hr_inp_upsample,
                           coords=coords.clamp(-1 + _EPS, 1 - _EPS))

    def decode_pixelshuffle(self, feat_t: torch.Tensor) -> torch.Tensor:
        """Legacy ZSM fixed-x4 head over every time step:
        (B, T, H, W, nf) -> (B, T, 4H, 4W, 3)."""
        B, T, H, W, C = feat_t.shape
        x = feat_t.reshape(B * T, H, W, C)
        x = lrelu(pixel_shuffle(self.upconv1(x), 2))
        x = lrelu(pixel_shuffle(self.upconv2(x), 2))
        x = self.conv_last(lrelu(self.HRconv(x)))
        return x.reshape(B, T, 4 * H, 4 * W, 3)

    def forward(self, x: torch.Tensor, times, out_size=None,
                test: bool = False,
                local_ensemble: bool = False) -> torch.Tensor:
        """(B, N, H, W, 3), times (nt,) or (B, nt) -> (nt, B, HH, WW, 3)."""
        return self.decode(self.gen_feat(x), x, times, out_size=out_size,
                           hr_inp_upsample=test,
                           local_ensemble=local_ensemble)

    def full_init(self, x: torch.Tensor, times):
        """The forward plus the legacy pixel-shuffle head: ``(out, legacy)``.
        The JAX package needs this entry to create every parameter of the
        checkpoint schema; here they exist from construction."""
        feat = self.gen_feat(x)
        return self.decode(feat, x, times), self.decode_pixelshuffle(feat)
