"""TMNet, the temporal-modulation space-time SR model (port of
``stif_tpu/models/tmnet.py``).

The Zooming-Slow-Mo skeleton where the PCD alignment gains TMB (temporal
modulation block) branches conditioned on the query time, a 3-frame
"non-linear comparison" refinement with two extra DCN_sep alignments, and a
fixed x4 pixel-shuffle output. Parameters follow the reference schema: the
reference's ``nn.Sequential`` containers (``t_process``, ``f_process``,
``layersAtBOffset``, ``layersCtBOffset``, ``layersFusion``) are
``nn.Sequential`` here too, so their convs are keyed ``t_process.0``,
``t_process.2``, ...

Stage marks (``utils/trace.py``, with grad disabled): ``encode``, up to
the end of the recon trunk, with ``encode.front``, ``encode.pcd`` (each of
the time-modulated alignments and its fusion), ``encode.convlstm`` and
``encode.trunk``; ``head``, the trunk's residual and the pixel-shuffle
upsampling.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from stif_tpu_torch.models.luna_tokis import pyramid
from stif_tpu_torch.models.registry import register_model
from stif_tpu_torch.nn.blocks import Conv, ResidualTrunk, lrelu
from stif_tpu_torch.nn.convlstm import BiDeformableConvLSTM
from stif_tpu_torch.nn.dcn import DCNSep
from stif_tpu_torch.nn.pcd import PCDAlign
from stif_tpu_torch.ops.pixel_shuffle import pixel_shuffle
from stif_tpu_torch.ops.resize import resize_bilinear
from stif_tpu_torch.utils.trace import mark


def _convs(*convs: Conv, last_act: bool) -> nn.Sequential:
    """Convs with LeakyReLU(0.1) between them (and after the last one with
    ``last_act``): conv i is entry 2i of the container."""
    layers = []
    for conv in convs:
        layers += [conv, nn.LeakyReLU(0.1)]
    return nn.Sequential(*(layers if last_act else layers[:-1]))


class TMB(nn.Module):
    """feature * MLP(t): t enters as a (B, 1, 1, 1) one-channel map through
    three bias-free 1x1 convs; the feature branch is two 3x3 convs."""

    def __init__(self, nf: int = 64):
        super().__init__()
        self.t_process = _convs(Conv(1, nf, 1, 1, 0, bias=False),
                                Conv(nf, nf, 1, 1, 0, bias=False),
                                Conv(nf, nf, 1, 1, 0, bias=False),
                                last_act=True)
        self.f_process = _convs(Conv(nf, nf, 3, 1, 1), Conv(nf, nf, 3, 1, 1),
                                last_act=True)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self.f_process(x) * self.t_process(t)


class PCDAlignTM(PCDAlign):
    """PCD alignment with a TMB time modulation added to the last offset
    conv of each level. Without times it is ``PCDAlign``'s own forward."""

    def __init__(self, nf: int = 64, groups: int = 8):
        super().__init__(nf, groups)
        for side in ("A", "B"):
            for lvl in (1, 2, 3):
                setattr(self, f"TMB_{side}_l{lvl}", TMB(nf))

    def forward(self, fea1, fea2, t=None, t_back=None) -> torch.Tensor:
        """fea1, fea2: [L1, L2, L3] NHWC pyramids; t, t_back: (B, 1, 1, 1)
        normalised times for the two directions, or None."""

        def up_to(x, ref):
            return resize_bilinear(x, size=ref.shape[1:3],
                                   align_corners=False)

        outs = []
        for s, side, a, b, tt in (("1", "A", fea1, fea2, t),
                                  ("2", "B", fea2, fea1, t_back)):
            def m(name):
                return getattr(self, f"{name}_{s}")

            def modulated(conv, lvl, pre):
                off = lrelu(conv(pre))
                if tt is None:
                    return off
                return off + getattr(self, f"TMB_{side}_l{lvl}")(pre, tt)

            # L3
            pre = lrelu(m("L3_offset_conv1")(torch.cat([a[2], b[2]], -1)))
            l3_off = modulated(m("L3_offset_conv2"), 3, pre)
            l3_fea = lrelu(m("L3_dcnpack")(a[2], l3_off))
            # L2
            off = lrelu(m("L2_offset_conv1")(torch.cat([a[1], b[1]], -1)))
            pre = lrelu(m("L2_offset_conv2")(
                torch.cat([off, up_to(l3_off, a[1]) * 2], -1)))
            l2_off = modulated(m("L2_offset_conv3"), 2, pre)
            l2_fea = m("L2_dcnpack")(a[1], l2_off)
            l2_fea = lrelu(m("L2_fea_conv")(
                torch.cat([l2_fea, up_to(l3_fea, a[1])], -1)))
            # L1
            off = lrelu(m("L1_offset_conv1")(torch.cat([a[0], b[0]], -1)))
            pre = lrelu(m("L1_offset_conv2")(
                torch.cat([off, up_to(l2_off, a[0]) * 2], -1)))
            l1_off = modulated(m("L1_offset_conv3"), 1, pre)
            l1_fea = m("L1_dcnpack")(a[0], l1_off)
            # the final fea conv has no activation
            outs.append(m("L1_fea_conv")(
                torch.cat([l1_fea, up_to(l2_fea, a[0])], -1)))
        return torch.cat(outs, -1)


@register_model("TMNet")
class TMNet(nn.Module):
    def __init__(self, nf: int = 64, nframes: int = 3, groups: int = 8,
                 front_RBs: int = 5, back_RBs: int = 10):
        super().__init__()
        self.conv_first = Conv(3, nf, 3, 1, 1)
        self.feature_extraction = ResidualTrunk(nf, front_RBs)
        self.fea_L2_conv1 = Conv(nf, nf, 3, 2, 1)
        self.fea_L2_conv2 = Conv(nf, nf, 3, 1, 1)
        self.fea_L3_conv1 = Conv(nf, nf, 3, 2, 1)
        self.fea_L3_conv2 = Conv(nf, nf, 3, 1, 1)
        self.pcd_align = PCDAlignTM(nf, groups)
        self.fusion = Conv(2 * nf, nf, 1, 1, 0)
        self.ConvBLSTM = BiDeformableConvLSTM(nf, groups)
        self.recon_trunk = ResidualTrunk(nf, back_RBs)
        # the last two head convs are 64 wide whatever nf is
        self.upconv1 = Conv(nf, nf * 4, 3, 1, 1)
        self.upconv2 = Conv(nf, 64 * 4, 3, 1, 1)
        self.HRconv = Conv(64, 64, 3, 1, 1)
        self.conv_last = Conv(64, 3, 3, 1, 1)
        # non-linear comparison refinement
        self.layersAtBOffset = _convs(Conv(2 * nf, nf), Conv(nf, nf),
                                      last_act=False)
        self.layersAtB = DCNSep(nf, nf, deformable_groups=groups)
        self.layersCtBOffset = _convs(Conv(2 * nf, nf), Conv(nf, nf),
                                      last_act=False)
        self.layersCtB = DCNSep(nf, nf, deformable_groups=groups)
        self.layersFusion = _convs(Conv(3 * nf, 3 * nf, 1, 1, 0),
                                   Conv(3 * nf, 3 * nf, 1, 1, 0),
                                   Conv(3 * nf, 3 * nf, 1, 1, 0),
                                   Conv(3 * nf, nf, 1, 1, 0), last_act=False)

    def forward(self, x: torch.Tensor, t=None) -> torch.Tensor:
        """x: (B, N, H, W, 3); t: (B, t_N) query times in [0, 1], or None
        (one aligned frame between each pair, as in ZSM). Returns
        (B, N + (N-1) * t_N, 4H, 4W, 3)."""
        B, N, H, W, C = x.shape
        if t is not None:
            t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
            # normalised to [-1, 1]; the backward direction sees 1 - t
            t_n = t / 0.5 - 1.0
            t_back_n = (1.0 - t) / 0.5 - 1.0

        dev = x.device
        with mark("encode", dev):
            l1, l2, l3 = pyramid(self, x)
            seq = []
            for idx in range(N - 1):
                fea1 = [l1[:, idx], l2[:, idx], l3[:, idx]]
                fea2 = [l1[:, idx + 1], l2[:, idx + 1], l3[:, idx + 1]]
                if idx == 0:
                    seq.append(fea1[0])
                if t is None:
                    with mark("encode.pcd", dev):
                        seq.append(self.fusion(self.pcd_align(fea1, fea2)))
                else:
                    for i in range(t.shape[1]):
                        with mark("encode.pcd", dev):
                            aligned = self.pcd_align(
                                fea1, fea2, t_n[:, i].reshape(B, 1, 1, 1),
                                t_back_n[:, i].reshape(B, 1, 1, 1))
                            seq.append(self.fusion(aligned))
                seq.append(fea2[0])
            dnc_feats = torch.stack(seq, 1)  # (B, T, H, W, nf)
            T = dnc_feats.shape[1]

            # non-linear comparison: align frames i-1 and i+1 (clamped at
            # both ends) to frame i, fuse, add as a residual
            refined = []
            for i in range(T):
                fea0 = dnc_feats[:, max(i - 1, 0)]
                fea1 = dnc_feats[:, i]
                fea2 = dnc_feats[:, min(i + 1, T - 1)]
                fea0_al = lrelu(self.layersAtB(
                    fea0, self.layersAtBOffset(torch.cat([fea0, fea1], -1))))
                fea2_al = lrelu(self.layersCtB(
                    fea2, self.layersCtBOffset(torch.cat([fea2, fea1], -1))))
                refined.append(self.layersFusion(
                    torch.cat([fea0_al, fea1, fea2_al], -1)))
            with mark("encode.convlstm", dev):
                feats = self.ConvBLSTM(dnc_feats + torch.stack(refined, 1))
            with mark("encode.trunk", dev):
                out = self.recon_trunk(feats.reshape(B * T, H, W, -1))

        with mark("head", dev):
            out = out + dnc_feats.reshape(B * T, H, W, -1)
            out = lrelu(pixel_shuffle(self.upconv1(out), 2))
            out = lrelu(pixel_shuffle(self.upconv2(out), 2))
            out = self.conv_last(lrelu(self.HRconv(out)))
        return out.reshape(B, T, 4 * H, 4 * W, 3)
