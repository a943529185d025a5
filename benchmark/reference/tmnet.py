"""TMNet (Xu et al., CVPR 2021) in plain PyTorch: the Zooming Slow-Mo
encoder whose PCD alignment gains TMB time modulation (a feature branch of
two 3x3 convs times a 1x1-conv MLP of the query time), the three-frame
refinement by two more DCNs, the bidirectional deformable ConvLSTM, the
recon trunk and the fixed x4 pixel-shuffle head. Parameters are a state dict
of the reference schema; ``arch`` holds ``nf``, ``groups``, ``front_RBs``,
``back_RBs``.
"""

from __future__ import annotations

import torch

from benchmark.reference.ops import (conv, deform_conv, lrelu, pixel_shuffle,
                                     resblocks)
from benchmark.reference.stif import conv_blstm, front, pcd_align


def _seq(P, name, x, n, last_act):
    """Convs ``{name}.0``, ``.2``, ... with LeakyReLU(0.1) between them."""
    for i in range(n):
        x = conv(P, f"{name}.{2 * i}", x)
        if i < n - 1 or last_act:
            x = lrelu(x)
    return x


def forward(P, arch, x, t):
    """x (B, N, H, W, 3), t (B, tN) query times -> (B, N + (N-1) tN, 4H,
    4W, 3)."""
    B, N, H, W, _ = x.shape
    G = arch["groups"]
    f = front(P, arch, x)
    seq = []
    for idx in range(N - 1):
        if idx == 0:
            seq.append(f[0][0])
        for i in range(t.shape[1]):
            tt = {"A": (t[:, i] / 0.5 - 1.0).reshape(B, 1, 1, 1),
                  "B": ((1.0 - t[:, i]) / 0.5 - 1.0).reshape(B, 1, 1, 1)}

            def modulate(side, lvl, pre, tt=tt):
                name = f"pcd_align.TMB_{side}_l{lvl}"
                feat = _seq(P, f"{name}.f_process", pre, 2, True)
                return feat * _seq(P, f"{name}.t_process", tt[side], 3, True)

            al = pcd_align(P, "pcd_align", f[idx], f[idx + 1], G, modulate)
            seq.append(conv(P, "fusion", al))
        seq.append(f[idx + 1][0])
    dnc = torch.stack(seq, 1)
    T = dnc.shape[1]
    refined = []
    for i in range(T):
        a, b, c = dnc[:, max(i - 1, 0)], dnc[:, i], dnc[:, min(i + 1, T - 1)]
        a_al = lrelu(deform_conv(
            P, "layersAtB", a,
            _seq(P, "layersAtBOffset", torch.cat([a, b], -1), 2, False), G))
        c_al = lrelu(deform_conv(
            P, "layersCtB", c,
            _seq(P, "layersCtBOffset", torch.cat([c, b], -1), 2, False), G))
        refined.append(_seq(P, "layersFusion", torch.cat([a_al, b, c_al], -1),
                            4, False))
    feats = conv_blstm(P, dnc + torch.stack(refined, 1), G)
    out = resblocks(P, "recon_trunk", feats.reshape(B * T, H, W, -1),
                    arch["back_RBs"])
    out = out + dnc.reshape(B * T, H, W, -1)
    out = lrelu(pixel_shuffle(conv(P, "upconv1", out), 2))
    out = lrelu(pixel_shuffle(conv(P, "upconv2", out), 2))
    out = conv(P, "conv_last", lrelu(conv(P, "HRconv", out)))
    return out.reshape(B, T, 4 * H, 4 * W, 3)
