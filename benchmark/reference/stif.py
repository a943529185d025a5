"""STIF's ``LunaTokis`` (the LIIF model of ``which_model_G: LIIF``) in plain
PyTorch: the encoder (front residual blocks, L2/L3 pyramid, PCD alignment
with DCNv2, the bidirectional deformable ConvLSTM, the recon trunk) and the
continuous decoder (nearest and bilinear gathers, the three SIREN nets, the
warp, the MATLAB-bicubic ``rgb_skip``), for an input pair. Parameters are a
state dict of the reference ``.pth`` schema; ``arch`` holds ``nf``,
``groups``, ``front_RBs``, ``back_RBs``.

``forward`` decodes the full grid one query time and one block of rows at a
time, so that a 720p window at eight times fits beside nothing else; every
row's arithmetic is the same at any block size.
"""

from __future__ import annotations

import torch

from benchmark.reference.ops import (EPS, base_grid, conv, deform_conv,
                                     grid_sample, imresize_to, lrelu,
                                     make_coord, resblocks, resize_bilinear,
                                     siren)


def pcd_align(P, pre, fea1, fea2, groups, modulate=None):
    """PCD alignment of two [L1, L2, L3] pyramids in both directions, the
    two aligned L1 maps concatenated. ``modulate(side, level, x)`` (TMNet's
    time modulation of the last offset conv's input ``x``) is added to the
    last offset conv of each level when given."""
    outs = []
    for s, side, a, b in (("1", "A", fea1, fea2), ("2", "B", fea2, fea1)):
        def c(name, x):
            return conv(P, f"{pre}.{name}_{s}", x)

        def dcn(name, x, off):
            return deform_conv(P, f"{pre}.{name}_{s}", x, off, groups)

        def last(name, lvl, x):
            off = lrelu(c(name, x))
            return off if modulate is None else off + modulate(side, lvl, x)

        def up(x, ref):
            return resize_bilinear(x, ref.shape[1:3])

        x = lrelu(c("L3_offset_conv1", torch.cat([a[2], b[2]], -1)))
        l3_off = last("L3_offset_conv2", 3, x)
        l3_fea = lrelu(dcn("L3_dcnpack", a[2], l3_off))
        off = lrelu(c("L2_offset_conv1", torch.cat([a[1], b[1]], -1)))
        x = lrelu(c("L2_offset_conv2",
                    torch.cat([off, up(l3_off, a[1]) * 2], -1)))
        l2_off = last("L2_offset_conv3", 2, x)
        l2_fea = dcn("L2_dcnpack", a[1], l2_off)
        l2_fea = lrelu(c("L2_fea_conv",
                         torch.cat([l2_fea, up(l3_fea, a[1])], -1)))
        off = lrelu(c("L1_offset_conv1", torch.cat([a[0], b[0]], -1)))
        x = lrelu(c("L1_offset_conv2",
                    torch.cat([off, up(l2_off, a[0]) * 2], -1)))
        l1_off = last("L1_offset_conv3", 1, x)
        l1_fea = dcn("L1_dcnpack", a[0], l1_off)
        outs.append(c("L1_fea_conv", torch.cat([l1_fea, up(l2_fea, a[0])],
                                              -1)))
    return torch.cat(outs, -1)


def pyramid(P, pre, l1):
    l2 = lrelu(conv(P, f"{pre}fea_L2_conv2",
                    lrelu(conv(P, f"{pre}fea_L2_conv1", l1, 2))))
    l3 = lrelu(conv(P, f"{pre}fea_L3_conv2",
                    lrelu(conv(P, f"{pre}fea_L3_conv1", l2, 2))))
    return l2, l3


def easy_pcd(P, pre, f1, f2, groups):
    """Pyramids of two single-level maps, aligned, fused by a 1x1 conv."""
    l2a, l3a = pyramid(P, f"{pre}.", f1)
    l2b, l3b = pyramid(P, f"{pre}.", f2)
    al = pcd_align(P, f"{pre}.pcd_align", [f1, l2a, l3a], [f2, l2b, l3b],
                   groups)
    return conv(P, f"{pre}.fusion", al)


def conv_blstm(P, x, groups):
    """The bidirectional deformable ConvLSTM over (B, T, H, W, nf): the
    reversed sequence through the same net, the two concatenated and merged
    by a 1x1 conv."""
    pre = "ConvBLSTM.forward_net"

    def run(seq):
        B, T, H, W, C = seq.shape
        h = seq.new_zeros(B, H, W, C)
        c = seq.new_zeros(B, H, W, C)
        hs = []
        for t in range(T):
            xt = seq[:, t]
            ha = easy_pcd(P, f"{pre}.pcd_h", xt, h, groups)
            ca = easy_pcd(P, f"{pre}.pcd_c", xt, c, groups)
            g = conv(P, f"{pre}.cell_list.0.conv", torch.cat([xt, ha], -1))
            gi, gf, go, gg = torch.chunk(g, 4, -1)
            c = torch.sigmoid(gf) * ca + torch.sigmoid(gi) * torch.tanh(gg)
            h = torch.sigmoid(go) * torch.tanh(c)
            hs.append(h)
        return torch.stack(hs, 1)

    fwd = run(x)
    rev = run(x.flip(1)).flip(1)
    B, T, H, W, C = fwd.shape
    merged = torch.cat([fwd, rev], -1).reshape(B * T, H, W, 2 * C)
    return conv(P, "ConvBLSTM.conv_1x1", merged).reshape(B, T, H, W, C)


def front(P, arch, x):
    """conv_first, the front trunk and the pyramid of (B, N, H, W, 3):
    per frame [L1, L2, L3] lists."""
    B, N, H, W, _ = x.shape
    l1 = lrelu(conv(P, "conv_first", x.reshape(B * N, H, W, 3)))
    l1 = resblocks(P, "feature_extraction", l1, arch["front_RBs"])
    l2, l3 = pyramid(P, "", l1)
    return [[v.reshape(B, N, *v.shape[1:])[:, i] for v in (l1, l2, l3)]
            for i in range(N)]


def encode(P, arch, x):
    """(B, 2, H, W, 3) -> features (B, 3, H, W, nf)."""
    f = front(P, arch, x)
    fused = conv(P, "fusion", pcd_align(P, "pcd_align", f[0], f[1],
                                        arch["groups"]))
    seq = torch.stack([f[0][0], fused, f[1][0]], 1)
    feats = conv_blstm(P, seq, arch["groups"])
    B, T, H, W, C = feats.shape
    out = resblocks(P, "recon_trunk", feats.reshape(B * T, H, W, C),
                    arch["back_RBs"])
    return out.reshape(B, T, H, W, C)


def _stage_ab(P, feat, inp, pe, coord):
    """Stages A+B over the query rows ``coord`` (B, Q, 2) (y, x) at the
    times ``pe`` (B, Q, 1): the HR feature rows (feat_imnet on the nearest
    LR cell's features, inputs and relative coordinates) and the flow rows
    (flow_imnet on those and the bilinear LR features and inputs)."""
    B, H, W, _ = feat.shape
    xy = coord.flip(-1)
    lr = torch.cat([feat, inp], -1)
    cells = torch.from_numpy(make_coord((H, W))).to(feat.device)
    cells = cells.reshape(1, H, W, 2).expand(B, H, W, 2)
    near = grid_sample(torch.cat([lr, cells], -1), xy, "nearest")
    rel = (coord - near[..., -2:]) * torch.tensor(
        [H, W], dtype=coord.dtype, device=coord.device)
    hr = siren(P, "feat_imnet", [near[..., :-2], rel, pe])
    flow = siren(P, "flow_imnet", [hr, grid_sample(lr, xy), pe])
    return hr, flow


def _stage_cd(P, feat, inp, hrfeat, skip, pe, flow, grid, HH, WW):
    """Stages C+D over query rows with flow ``flow`` (B, Q, 4) at lattice
    points ``grid`` (Q, 2): two warp grids, the bilinear gathers of the LR
    features and inputs and of the full HR field ``hrfeat`` at both,
    encode_imnet, plus the time-blended bicubic skip term."""
    norm = torch.tensor([(WW - 1.0) / 2.0, (HH - 1.0) / 2.0],
                        device=flow.device)
    g1 = (grid[None] + flow[..., 0:2] / norm).clamp(-1 + EPS, 1 - EPS)
    g2 = (grid[None] + flow[..., 2:4] / norm).clamp(-1 + EPS, 1 - EPS)
    lr = torch.cat([feat, inp], -1)
    nfc = feat.shape[-1]
    c1, c2 = grid_sample(lr, g1), grid_sample(lr, g2)
    q1, q2 = grid_sample(hrfeat, g1), grid_sample(hrfeat, g2)
    rgb = siren(P, "encode_imnet", [q1, q2, c1[..., :nfc], c2[..., :nfc],
                                    c1[..., nfc:], c2[..., nfc:], pe])
    s1 = grid_sample(skip[..., :3], g1)
    s2 = grid_sample(skip[..., 3:], g2)
    return rgb + (1.0 - pe) * s1 + pe * s2


def decode(P, feat_t, x, times, out_size, block: int = 1 << 30):
    """The full-grid decode of ``LunaTokis`` with ``rgb_skip`` bicubic:
    features (B, 3, H, W, nf), inputs (B, 2, H, W, 3), times (nt,) or (B,
    nt) -> (nt, B, HH, WW, 3), ``block`` query rows at a time."""
    B, _, H, W, _ = feat_t.shape
    HH, WW = out_size
    dev = feat_t.device
    feat = feat_t[:, :3].permute(0, 2, 3, 1, 4).reshape(B, H, W, -1)
    inp = x.permute(0, 2, 3, 1, 4).reshape(B, H, W, 6)
    skip = imresize_to(torch.cat([inp[..., :3], inp[..., 3:]], -1), (HH, WW))
    coord = torch.from_numpy(make_coord((HH, WW))).to(dev)
    coord = coord.clamp(-1 + EPS, 1 - EPS)
    grid = torch.from_numpy(base_grid(HH, WW)).to(dev)
    t_all = torch.as_tensor(times, dtype=torch.float32, device=dev)
    t_all = t_all.reshape(1, -1).expand(B, -1) if t_all.dim() == 1 else t_all
    Q = HH * WW
    spans = [(a, min(a + block, Q)) for a in range(0, Q, block)]
    out = []
    for i in range(t_all.shape[1]):
        t = t_all[:, i].reshape(B, 1, 1)
        hr, flow = [], []
        for a, b in spans:
            h, f = _stage_ab(P, feat, inp, t.expand(B, b - a, 1),
                             coord[a:b][None].expand(B, -1, 2))
            hr.append(h)
            flow.append(f)
        hrfeat = torch.cat(hr, 1).reshape(B, HH, WW, -1)
        flow = torch.cat(flow, 1)
        rows = [_stage_cd(P, feat, inp, hrfeat, skip, t.expand(B, b - a, 1),
                          flow[:, a:b], grid[a:b], HH, WW)
                for a, b in spans]
        out.append(torch.cat(rows, 1).reshape(B, HH, WW, 3))
    return torch.stack(out, 0)


def forward(P, arch, x, times, out_size, block: int = 1 << 30):
    """(B, 2, H, W, 3) and query times -> (nt, B, HH, WW, 3)."""
    return decode(P, encode(P, arch, x), x, times, out_size, block)
