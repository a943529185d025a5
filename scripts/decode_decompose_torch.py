#!/usr/bin/env python
"""Time each decode sub-stage at the bench shape (counterpart of
``tools/decode_decompose.py``): LR 96x160 -> x4, nt 8, B 1, Q = 245,760
queries per time, the deployed model (fp32, the SIREN nets through the
fused kernel), each stage as the full-grid decode
(``LunaTokis._decode_pass``) runs it:

  stageA_nearest  one nearest gather of the 200-channel LR field stack
  stageB_bilinear one bilinear gather of (feat, input) at LR resolution
  feat_imnet      the SIREN 201 -> 64 over nt x Q rows (the HR field)
  flow_imnet      the SIREN 263 -> 4 over nt x Q rows
  warp_grids      flow -> two clamped warp grids
  stageC_hr       two bilinear gathers from the HR field (8, 384, 640, 64)
  stageC_lr       two bilinear gathers from the 198-channel LR stack
  encode_imnet    the SIREN 525 -> 3 over nt x Q rows
  stageD_skip     the bicubic skip source, its two gathers and the blend
  decode_full     the whole ``model.decode``, to check the sum

The fields come from a seeded generator on the device; the warp grids are
near-identity (the regular grid plus about a pixel of jitter), as trained
flows are: gather locality is part of what is measured.

    python scripts/decode_decompose_torch.py [--iters 5]

Prints a header line (card, sizes, clock), then one JSON line per case
``{"case": ..., "ms": ...}``, then the sum of the stages. On the card each
time is the mean of ``--iters`` runs by CUDA events after a warm-up; with
``--device cpu`` it is host wall time.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    import torch

    from stif_tpu_torch.ops.coords import make_coord
    from stif_tpu_torch.ops.grid_sample import grid_sample
    from stif_tpu_torch.ops.resize import imresize_to
    from stif_tpu_torch.ops.warp import warp_grid
    from stif_tpu_torch.runtime import bench
    from stif_tpu_torch.runtime.pipeline import resolve_device

    ap = argparse.ArgumentParser()
    bench.add_workload_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    kw = bench.workload_kwargs(args)
    model = bench.build(device, kw["weights"], bench.Knobs(), **kw["arch"])
    H, W = kw["lr_hw"]
    nt, B = kw["n_times"], 1
    HH, WW = H * bench.SCALE, W * bench.SCALE
    Q, NTB, nf3 = HH * WW, kw["n_times"] * B, 3 * model.nf
    print(json.dumps({
        "tool": "decode_decompose_torch", "device": bench.device_info(device),
        "card": bench.card_line() if cuda else None, "lr_hw": [H, W],
        "n_times": nt, "queries": Q,
        "clock": "cuda events, mean of --iters" if cuda
        else "host wall, mean of --iters"}), flush=True)

    gen = torch.Generator(device).manual_seed(args.seed)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    def timed(name, fn):
        with torch.inference_mode():
            fn()
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                for _ in range(args.iters):
                    fn()
                end.record()
                torch.cuda.synchronize(device)
                ms = start.elapsed_time(end) / args.iters
            else:
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    fn()
                ms = 1e3 * (time.perf_counter() - t0) / args.iters
        print(json.dumps({"case": name, "ms": round(ms, 3)}), flush=True)
        return ms

    def tile_t(v):  # (B, ...) -> (nt, B, ...), a broadcast view
        return v.expand(nt, *v.shape)

    def tile_b(v):  # (B, h, w, C) -> (nt*B, h, w, C)
        return tile_t(v).reshape(NTB, *v.shape[1:])

    feat = rand(B, H, W, nf3)
    inp_cat = rand(B, H, W, 6)
    coord = make_coord((HH, WW), device=device).clamp(-1 + 1e-6, 1 - 1e-6)
    coord_xy = coord.flip(-1)[None].expand(B, Q, 2)
    feat_coord = make_coord((H, W), flatten=False, device=device)[None]
    pe = rand(nt, B, Q, 1)
    jitter = (rand(NTB, Q, 2) - 0.5) * (2.0 / H)
    base = coord_xy[:1].expand(NTB, Q, 2)
    g1 = (base + jitter).clamp(-1 + 1e-6, 1 - 1e-6)
    g2 = (base - jitter).clamp(-1 + 1e-6, 1 - 1e-6)
    total = 0.0

    total += timed("stageA_nearest", lambda: grid_sample(
        torch.cat([feat, inp_cat, feat_coord.expand(B, H, W, 2)], -1),
        coord_xy, mode="nearest"))
    total += timed("stageB_bilinear", lambda: model._gs_b(
        torch.cat([feat, inp_cat], -1), coord_xy))
    base_a = rand(B, Q, nf3 + 8)
    total += timed("feat_imnet", lambda: model.feat_imnet(
        [tile_t(base_a), pe]))
    q_b = rand(B, Q, nf3 + 6)
    q_feat_b = rand(nt, B, Q, 64)
    total += timed("flow_imnet", lambda: model.flow_imnet(
        [q_feat_b, tile_t(q_b[..., :nf3]), tile_t(q_b[..., nf3:]), pe]))
    del base_a, q_b, q_feat_b
    flow = (rand(NTB, HH, WW, 4) - 0.5) * 0.05
    total += timed("warp_grids", lambda: (
        warp_grid(flow[..., :2]).clamp(-1 + 1e-6, 1 - 1e-6),
        warp_grid(flow[..., 2:]).clamp(-1 + 1e-6, 1 - 1e-6)))
    del flow
    hrfeat = rand(NTB, HH, WW, 64)
    total += timed("stageC_hr", lambda: (model._gs_b(hrfeat, g1),
                                         model._gs_b(hrfeat, g2)))
    del hrfeat
    lr_c = tile_b(torch.cat([feat, inp_cat], -1))
    total += timed("stageC_lr", lambda: (model._gs_b(lr_c, g1),
                                         model._gs_b(lr_c, g2)))
    del lr_c
    q1, q2 = rand(NTB, Q, 64), rand(NTB, Q, 64)
    c1, c2 = rand(NTB, Q, nf3 + 6), rand(NTB, Q, nf3 + 6)
    pe_q = pe.reshape(NTB, Q, 1)
    total += timed("encode_imnet", lambda: model.encode_imnet(
        [q1, q2, c1[..., :nf3], c2[..., :nf3], c1[..., nf3:], c2[..., nf3:],
         pe_q]))
    del q1, q2, c1, c2
    rgb = rand(NTB, Q, 3)

    def skip():
        src = torch.cat([inp_cat[..., :3], inp_cat[..., -3:]], -1)
        skip_hr = imresize_to(src, (HH, WW))
        s1 = model._gs_b(tile_b(skip_hr[..., :3]), g1)
        s2 = model._gs_b(tile_b(skip_hr[..., 3:]), g2)
        return rgb + (1.0 - pe_q) * s1 + pe_q * s2

    total += timed("stageD_skip", skip)
    del rgb, g1, g2
    x = rand(B, 2, H, W, 3)
    t = torch.tensor(bench.times_for(nt), device=device)
    with torch.inference_mode():
        feat_t = model.gen_feat(x)
    full = timed("decode_full", lambda: model.decode(feat_t, x, t))
    print(json.dumps({"case": "sum_of_stages", "ms": round(total, 3),
                      "of_decode_full": round(total / full, 3)}), flush=True)


if __name__ == "__main__":
    main()
