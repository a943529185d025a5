"""LunaTokis, the continuous space-time SR model (port of
``stif_tpu/models/luna_tokis.py``, serving path).

The module tree follows the reference ``.pth`` schema, so trained weights
load with ``load_state_dict(strict=True)``. Public layouts are the JAX
package's: input (B, N, H, W, 3), features (B, 2N-1, H, W, nf), output
(nt, B, HH, WW, 3).

  encoder (``gen_feat``): conv_first -> front residual blocks -> L2/L3
    strided pyramid -> PCD alignment of the pair -> bidirectional
    deformable ConvLSTM -> recon trunk.
  decoder (``decode``): ``decode_prep`` builds a decode's gather sources
    once (``Sources``); a ``Queries`` is one set of queries on the (HH, WW)
    HR field: the whole grid, rows of it (a chunk), the local ensemble's
    shifted set or a zoom window. ``decode_ab`` and ``decode_cd`` run the
    stages over a query set, the one copy of them that every path calls:
    stage A: nearest-gather LR features + rel coords + time -> feat_imnet
    stage B: (HR feature, bilinear LR feature, input) -> flow_imnet
    stage C: two warp grids from the flow; bilinear gathers at both
    stage D: encode_imnet -> RGB, plus the rgb_skip blend.
  The full-grid decode runs A+B and C+D over the whole grid; the chunked
  decoder (``stif_tpu_torch.runtime.chunked``), for frames too large to
  decode whole, runs A+B over every chunk of rows, assembles the HR field,
  then C+D over every chunk. ``Sources`` and ``Queries`` serve the
  variants and ablations too. The query-time axis rides in front of the
  batch axis: every stage runs once for all (time, batch) pairs. The three
  SIREN nets run through the fused kernel
  (``stif_tpu_torch.ops.siren_fused``) unless ``mlp_dtype`` or
  ``fused=False`` says otherwise.

Stage marks (``utils/trace.py``, with grad disabled): ``encode`` with
``encode.front`` (the convs before the alignment), ``encode.pcd`` (each
pair's alignment and fusion), ``encode.convlstm``, ``encode.trunk``;
``decode`` with ``decode.prep`` (the gather sources, the bicubic skip
source, the query grid), ``decode.ab`` (stages A and B) and ``decode.cd``
(stages C and D), the latter two in the chunk passes too.

Not ported: ``lstm_unroll`` and ``lstm_fuse_dirs`` (ways to run the same
math on a TPU) and the mesh.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from stif_tpu_torch.models.registry import register_model
from stif_tpu_torch.nn.blocks import Conv, ResidualTrunk, lrelu, remat
from stif_tpu_torch.nn.convlstm import BiDeformableConvLSTM
from stif_tpu_torch.nn.pcd import PCDAlign
from stif_tpu_torch.nn.siren import Siren
from stif_tpu_torch.ops.constants import vector
from stif_tpu_torch.ops.coords import make_coord_cached, make_coord_demo
from stif_tpu_torch.ops.grid_sample import grid_sample
from stif_tpu_torch.ops.pixel_shuffle import pixel_shuffle
from stif_tpu_torch.ops.resize import imresize_to, resize_bilinear
from stif_tpu_torch.ops.warp import _base_grid, lattice_plus_flow
from stif_tpu_torch.utils.trace import mark

_EPS = 1e-6


def _times_nb(times, B: int, device) -> torch.Tensor:
    """Query times as (nt, B): ``times`` is (nt,), shared by the batch, or
    per-sample (B, nt)."""
    t = torch.as_tensor(times, dtype=torch.float32, device=device)
    if t.dim() == 2:
        return t.t()
    return t.reshape(-1, 1).expand(t.numel(), B)


class Sources(NamedTuple):
    """A decode's gather sources, each (B, h, w, C), built once per decode
    (stage ``decode.prep``) and read by every pass and chunk."""

    feat: torch.Tensor     # the first 3 temporal maps, channel t*nf + c
    inp_cat: torch.Tensor  # the input frames, channel n*3 + c
    # stages B-D's input frames: inp_cat, or (test mode) its bilinear x4
    # upsample (``align_corners=False``)
    hr_inp: torch.Tensor
    # [feat, inp_cat, LR cell centres]: stage A's one nearest gather
    gather_a: torch.Tensor
    # [feat, hr_inp] when hr_inp is at LR resolution: stages B and C's one
    # bilinear gather per grid
    gather_bc: Optional[torch.Tensor] = None


def decode_prep(feat_t: torch.Tensor, inp: torch.Tensor, out_size=None,
                hr_inp_upsample: bool = False):
    """``(Sources, (HH, WW))`` of features (B, T, H, W, nf) and the model
    input (B, N, H, W, 3): the sources, and the query grid's size (default
    x4)."""
    B, _, H, W, _ = feat_t.shape
    feat = feat_t[:, :3].permute(0, 2, 3, 1, 4).reshape(B, H, W, -1)
    inp_cat = inp.permute(0, 2, 3, 1, 4).reshape(B, H, W, -1)
    hr_inp = (resize_bilinear(inp_cat, scale_factor=4, align_corners=False)
              if hr_inp_upsample else inp_cat)
    centres = make_coord_cached((H, W), flatten=False, device=feat.device)
    gather_a = torch.cat([feat, inp_cat, centres[None].expand(B, H, W, 2)],
                         -1)
    gather_bc = (torch.cat([feat, hr_inp], -1)
                 if hr_inp.shape[1:3] == feat.shape[1:3] else None)
    size = (4 * H, 4 * W) if out_size is None else tuple(out_size)
    return Sources(feat, inp_cat, hr_inp, gather_a, gather_bc), size


class Queries:
    """One set of Q queries on an (HH, WW) = ``size`` HR field, over the
    sources ``s``, at query times (nt,) or (B, nt):

    - ``coord`` (Q, 2) or (B, Q, 2): the clamped (y, x) gather coordinates,
      default the whole grid's cell centres; the rows of a chunk, shifted
      ones (the local ensemble, with ``ref``, the unshifted reference of
      the relative coordinates) or a zoom window otherwise;
    - ``lattice`` (Q, 2): the queries' rows of the field's
      ``align_corners=True`` lattice (``ops/warp.py``), (x, y), from which
      stage C's grids start; default the whole grid's, for a query set of
      the whole grid;
    - ``centres``: the queries are the field's own cell centres at their
      rows (the grid or rows of it), where stage B's nearest re-sample of
      the HR field is the identity and is skipped.

    The constructor launches nothing but the default coordinates' clamp;
    each tensor below is computed when a stage first reads it:

    - ``cxy`` (B, Q, 2): the gather coordinates in (x, y) order;
    - ``base`` (B, Q, 3nf + 3N + 2): the nearest LR feature, the nearest
      input sample and the relative coordinates, in that column order (one
      fused gather of ``Sources.gather_a``; the nets read column slices of
      it in place); ``area`` (B, Q): the local ensemble's weight;
    - ``pe`` (nt, B, Q, 1): the query times, contiguous;
    - ``tile_t`` / ``tile_b``: a (B, ...) tensor broadcast over the times
      as a (nt, B, ...) view, or as a (nt*B, ...) gather source;
    - ``warp_grids``: stage C's two clamped grids of a flow.
    """

    def __init__(self, s: Sources, times, size, coord=None, lattice=None,
                 ref=None, centres: bool = True):
        dev = s.feat.device
        if coord is None:
            coord = make_coord_cached(size, device=dev).clamp(-1 + _EPS,
                                                              1 - _EPS)
        if lattice is None:
            lattice = _base_grid(*size, dev).reshape(-1, 2)
        self.s, self.size, self.centres = s, tuple(size), centres
        self.coord, self.lattice = coord, lattice
        self.ref = coord if ref is None else ref
        self.nfc, self.nic = s.feat.shape[-1], s.inp_cat.shape[-1]
        self.B, self.Q = s.feat.shape[0], coord.shape[-2]
        self.t_nb = _times_nb(times, self.B, dev)
        self.nt = self.t_nb.shape[0]

    @functools.cached_property
    def cxy(self) -> torch.Tensor:
        return self.coord.expand(self.B, self.Q, 2).flip(-1)

    @functools.cached_property
    def base(self) -> torch.Tensor:
        src = self.s.gather_a
        H, W = src.shape[1:3]
        k = src.shape[-1] - 2
        q = grid_sample(src, self.cxy, mode="nearest")
        rel = (self.ref - q[..., k:]) * vector(H, W, dtype=q.dtype,
                                               device=q.device)
        return torch.cat([q[..., :k], rel], -1)

    @functools.cached_property
    def area(self) -> torch.Tensor:
        rel = self.base[..., -2:]
        return (rel[..., 0] * rel[..., 1]).abs() + 1e-9

    @functools.cached_property
    def pe(self) -> torch.Tensor:
        return self.t_nb[:, :, None, None].expand(
            self.nt, self.B, self.Q, 1).contiguous()

    def tile_t(self, v: torch.Tensor) -> torch.Tensor:
        return v.expand(self.nt, *v.shape)

    def tile_b(self, v: torch.Tensor) -> torch.Tensor:
        return self.tile_t(v).reshape(self.nt * self.B, *v.shape[1:])

    def warp_grids(self, flow: torch.Tensor):
        """The two clamped stage-C sample grids (nt*B, Q, 2), (x, y), of a
        flow (nt, B, Q, 4) or (nt*B, Q, 4): ``warp_grid``'s arithmetic at
        the queries' rows of the lattice, normalised by the field's size."""
        flow = flow.reshape(self.nt * self.B, self.Q, 4)
        HH, WW = self.size
        return tuple(
            lattice_plus_flow(self.lattice, flow[..., k:k + 2], HH,
                              WW).clamp(-1 + _EPS, 1 - _EPS)
            for k in (0, 2))


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
    with mark("encode", x.device):
        B, N, H, W, C = x.shape
        l1, l2, l3 = pyramid(m, x)
        seq = []
        for idx in range(N - 1):
            fea1 = [l1[:, idx], l2[:, idx], l3[:, idx]]
            fea2 = [l1[:, idx + 1], l2[:, idx + 1], l3[:, idx + 1]]
            with mark("encode.pcd", x.device):
                fused = m.fusion(m.pcd_align(fea1, fea2))
            if idx == 0:
                seq.append(fea1[0])
            seq.append(fused)
            seq.append(fea2[0])
        with mark("encode.convlstm", x.device):
            feats = m.ConvBLSTM(torch.stack(seq, 1))  # (B, 2N-1, H, W, nf)
        B2, T, Hf, Wf, Cf = feats.shape
        with mark("encode.trunk", x.device):
            out = m.recon_trunk(feats.reshape(B2 * T, Hf, Wf, Cf))
        return out.reshape(B2, T, Hf, Wf, Cf)


def pyramid(m: nn.Module, x: torch.Tensor):
    """The encoder's front (stage ``encode.front``): ``conv_first``, the
    front residual blocks and the strided L2 / L3 convs of x (B, N, H, W,
    3): the three levels (B, N, H / 2**k, W / 2**k, nf)."""
    B, N, H, W, C = x.shape
    with mark("encode.front", x.device):
        l1 = lrelu(m.conv_first(x.reshape(B * N, H, W, C)))
        l1 = m.feature_extraction(l1)
        l2 = lrelu(m.fea_L2_conv2(lrelu(m.fea_L2_conv1(l1))))
        l3 = lrelu(m.fea_L3_conv2(lrelu(m.fea_L3_conv1(l2))))
    return (l1.reshape(B, N, H, W, -1), l2.reshape(B, N, H // 2, W // 2, -1),
            l3.reshape(B, N, H // 4, W // 4, -1))


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

    def skip_source(self, inp_cat: torch.Tensor, size):
        """(B, HH, WW, 6) MATLAB-bicubic upsample of the [first, last] input
        frames to the query grid's ``size`` when ``rgb_skip_bicubic``
        applies, else None. Full-grid decodes only: an explicit query
        window falls back to the LR skip."""
        if not (self.rgb_skip and self.rgb_skip_bicubic):
            return None
        src = torch.cat([inp_cat[..., :3], inp_cat[..., -3:]], -1)
        return imresize_to(src, size)

    def decode_ab(self, q: Queries):
        """Stages A and B over the query set ``q``: the HR feature field and
        the flow at its queries, (nt*B, Q, 64) and (nt*B, Q, 4). A query set
        that is not the field's own cell centres re-samples the field at its
        coordinates, so it must be the whole grid.

        The SIREN nets get their fields as views (broadcasts over the time
        axis, column slices of a fused gather), never concatenated here.
        """
        s = q.s
        with mark("decode.ab", s.feat.device):
            nt, B, Q, nfc = q.nt, q.B, q.Q, q.nfc
            base = q.tile_t(q.base)
            # stage B gathers of the time-independent fields, one fused
            # gather when hr_inp is at LR resolution (the non-test path)
            if s.gather_bc is not None:
                q_b = self._gs_b(s.gather_bc, q.cxy)
                q_feat0_b, q_inp_b = q_b[..., :nfc], q_b[..., nfc:]
            else:
                q_inp_b = self._gs_b(s.hr_inp, q.cxy)
                q_feat0_b = self._gs_b(s.feat, q.cxy)
            # stage A: HR feature field (nt, B, Q, 64)
            hrfeat_q = self.feat_imnet([base, q.pe])
            # the field's view is made before stage B reads hrfeat_q: the
            # backward then sums hrfeat_q's two gradients in one fixed order
            field = hrfeat_q.reshape(nt * B, Q, -1)
            # stage B: flow
            if q.centres:
                q_feat_b = hrfeat_q
            else:
                q_feat_b = grid_sample(
                    field.reshape(nt * B, *q.size, -1),
                    q.tile_t(q.cxy).reshape(nt * B, Q, 2),
                    mode="nearest").reshape(nt, B, Q, -1)
            flow_q = self.flow_imnet([q_feat_b, q.tile_t(q_feat0_b),
                                      q.tile_t(q_inp_b), q.pe])
        return field, flow_q.reshape(nt * B, Q, 4)

    def decode_cd(self, q: Queries, field: torch.Tensor, flow: torch.Tensor,
                  skip_hr=None) -> torch.Tensor:
        """Stages C and D over the query set ``q``: RGB (nt*B, Q, 3) from
        the queries' ``flow`` (nt*B, Q, 4), gathering from the whole HR
        feature ``field`` (nt*B, HH, WW, 64) and the optional bicubic skip
        source ``skip_hr`` (B, HH, WW, 6)."""
        s = q.s
        with mark("decode.cd", s.feat.device):
            nt, B, Q, nfc = q.nt, q.B, q.Q, q.nfc
            # stage C: warp grids, then the gathers at both
            g1, g2 = q.warp_grids(flow)
            pe = q.pe.reshape(nt * B, Q, 1)
            # the wide LR gathers come first, while the HR gathers' results do
            # not exist yet: a gather holds its result twice for a moment
            if s.gather_bc is not None and not self.stagec_nearest:
                # equal-resolution LR sources fuse into one gather per grid
                if self.stagec_dedup:
                    # the source does not depend on time: fold nt into the
                    # query axis and gather once from the (B, ...) map
                    def fold_q(g):   # (nt*B, Q, 2) -> (B, nt*Q, 2)
                        return (g.reshape(nt, B, Q, 2).transpose(0, 1)
                                .reshape(B, nt * Q, 2))

                    def unfold_q(c):  # (B, nt*Q, C) -> (nt*B, Q, C)
                        return (c.reshape(B, nt, Q, -1).transpose(0, 1)
                                .reshape(nt * B, Q, -1))

                    c1 = unfold_q(self._gs_b(s.gather_bc, fold_q(g1)))
                    c2 = unfold_q(self._gs_b(s.gather_bc, fold_q(g2)))
                else:
                    lr_c = q.tile_b(s.gather_bc)
                    c1 = self._gs_b(lr_c, g1)
                    c2 = self._gs_b(lr_c, g2)
                q_feat3, q_img1 = c1[..., :nfc], c1[..., nfc:]
                q_feat4, q_img2 = c2[..., :nfc], c2[..., nfc:]
            else:
                feat_tl, hr_inp_tl = q.tile_b(s.feat), q.tile_b(s.hr_inp)
                q_img1 = self._gs_b(hr_inp_tl, g1)
                q_img2 = self._gs_b(hr_inp_tl, g2)
                if s.gather_bc is not None:
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
            q_feat1 = self._gs_b(field, g1)
            q_feat2 = self._gs_b(field, g2)
            # stage D, plus the time-blended skip term under rgb_skip
            rgb = self.encode_imnet([q_feat1, q_feat2, q_feat3, q_feat4,
                                     q_img1, q_img2, pe])
            if self.rgb_skip:
                if skip_hr is not None:
                    s1 = self._gs_b(q.tile_b(skip_hr[..., :3]), g1)
                    s2 = self._gs_b(q.tile_b(skip_hr[..., 3:]), g2)
                else:
                    s1, s2 = q_img1[..., :3], q_img2[..., -3:]
                rgb = rgb + (1.0 - pe) * s1 + pe * s2
        return rgb

    def _decode_pass(self, s: Sources, times, size, coord, ref=None,
                     centres: bool = True, skip_hr=None):
        """One decode pass of the whole (HH, WW) = ``size`` field at the
        gather coordinates ``coord`` (Q, 2): stages A and B, then C and D
        gathering from the pass's own HR field. Returns (rgb (nt, B, HH,
        WW, 3), area (B, Q))."""
        q = Queries(s, times, size, coord, ref=ref, centres=centres)
        field, flow = self.decode_ab(q)
        rgb = self.decode_cd(q, field.reshape(q.nt * q.B, *q.size, -1), flow,
                             skip_hr)
        return rgb.reshape(q.nt, q.B, *q.size, 3), q.area

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
        with mark("decode", feat_t.device):
            with mark("decode.prep", feat_t.device):
                s, size = decode_prep(feat_t, inp, out_size, hr_inp_upsample)
                B, H, W = s.feat.shape[:3]
                if coords is None:
                    coord = make_coord_cached(size, device=feat_t.device)
                    coord = coord.clamp(-1 + _EPS, 1 - _EPS)
                    skip_hr = self.skip_source(s.inp_cat, size)
                else:
                    coord = torch.as_tensor(coords, dtype=torch.float32,
                                            device=feat_t.device)
                    skip_hr = None

            if not local_ensemble:
                # with grad on, the pass is recomputed in the backward instead
                # of storing its gathered fields and SIREN activations (the JAX
                # package's ``nn.remat(pass_fn)``); the same maths either way
                rgb, _ = remat(self._decode_pass, s, times, size, coord,
                               centres=coords is None, skip_hr=skip_hr)
                return rgb

            rx = 2.0 / H / 2.0
            ry = 2.0 / W / 2.0
            preds, areas = [], []
            for vx in (-1, 1):
                for vy in (-1, 1):
                    shift = vector(vx * rx + _EPS, vy * ry + _EPS,
                                   dtype=coord.dtype, device=coord.device)
                    rgb, area = self._decode_pass(
                        s, times, size, (coord + shift).clamp(-1 + _EPS,
                                                              1 - _EPS),
                        ref=coord, centres=False, skip_hr=skip_hr)
                    preds.append(rgb)
                    areas.append(area)
            HH, WW = size
            tot = areas[0] + areas[1] + areas[2] + areas[3]
            out = 0.0
            # each pass is weighted by the area of the diagonally opposite one
            for p, a in zip(preds, areas[::-1]):
                out = out + p * (a / tot).reshape(1, B, HH, WW, 1)
            return out

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
