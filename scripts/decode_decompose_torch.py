#!/usr/bin/env python
"""Time each decode sub-stage at the bench shape (counterpart of
``tools/decode_decompose.py``): LR 96x160 -> x4, nt 8, B 1, Q = 245,760
queries per time, the deployed model (fp32, the SIREN nets through the
fused kernel). Each stage runs as ``LunaTokis.decode_ab`` /
``decode_cd`` run it, through the model's own pieces: the sources of
``decode_prep``, one ``Queries`` of the whole grid, the model's gathers,
nets and ``skip_source``, on the fields of one decode of a seeded pair:

  stageA_nearest  the query set's stage-A gather (``Queries.base``)
  stageB_bilinear the one bilinear gather of (feat, input) at LR resolution
  feat_imnet      the SIREN 201 -> 64 over nt x Q rows (the HR field)
  flow_imnet      the SIREN 263 -> 4 over nt x Q rows
  warp_grids      flow -> two clamped warp grids (``Queries.warp_grids``)
  stageC_hr       two bilinear gathers from the HR field (8, 384, 640, 64)
  stageC_lr       the LR source tiled over the times and its two bilinear
                  gathers (198 channels)
  encode_imnet    the SIREN 525 -> 3 over nt x Q rows
  stageD_skip     the bicubic skip source, its two gathers and the blend
  decode_full     the whole ``model.decode``, to check the sum

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

    from stif_tpu_torch.models.luna_tokis import Queries, decode_prep
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
    gen = torch.Generator(device).manual_seed(args.seed)
    x = torch.rand(B, 2, H, W, 3, generator=gen, device=device)
    t = torch.tensor(bench.times_for(nt), device=device)
    with torch.inference_mode():
        feat_t = model.gen_feat(x)
        s, size = decode_prep(feat_t, x)
        q = Queries(s, t, size)
        field, flow = model.decode_ab(q)
    (HH, WW), Q, NTB, nfc = size, q.Q, nt * B, q.nfc
    print(json.dumps({
        "tool": "decode_decompose_torch", "device": bench.device_info(device),
        "card": bench.card_line() if cuda else None, "lr_hw": [H, W],
        "n_times": nt, "queries": Q,
        "clock": "cuda events, mean of --iters" if cuda
        else "host wall, mean of --iters"}), flush=True)

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

    gs = model._gs_b
    hr = field.reshape(NTB, HH, WW, -1)
    pe = q.pe.reshape(NTB, Q, 1)

    def stage_c_lr():
        lr_c = q.tile_b(s.gather_bc)
        return gs(lr_c, g1), gs(lr_c, g2)

    with torch.inference_mode():
        q_b = gs(s.gather_bc, q.cxy)
        g1, g2 = q.warp_grids(flow)
        q1, q2 = gs(hr, g1), gs(hr, g2)
        c1, c2 = stage_c_lr()
        fields = [q1, q2, c1[..., :nfc], c2[..., :nfc], c1[..., nfc:],
                  c2[..., nfc:], pe]
        rgb = model.encode_imnet(fields)

    def skip():
        skip_hr = model.skip_source(s.inp_cat, size)
        s1 = gs(q.tile_b(skip_hr[..., :3]), g1)
        s2 = gs(q.tile_b(skip_hr[..., 3:]), g2)
        return rgb + (1.0 - pe) * s1 + pe * s2

    total = 0.0
    total += timed("stageA_nearest", lambda: Queries(s, t, size).base)
    total += timed("stageB_bilinear", lambda: gs(s.gather_bc, q.cxy))
    total += timed("feat_imnet", lambda: model.feat_imnet(
        [q.tile_t(q.base), q.pe]))
    total += timed("flow_imnet", lambda: model.flow_imnet(
        [field.reshape(nt, B, Q, -1), q.tile_t(q_b[..., :nfc]),
         q.tile_t(q_b[..., nfc:]), q.pe]))
    total += timed("warp_grids", lambda: q.warp_grids(flow))
    total += timed("stageC_hr", lambda: (gs(hr, g1), gs(hr, g2)))
    total += timed("stageC_lr", stage_c_lr)
    total += timed("encode_imnet", lambda: model.encode_imnet(fields))
    total += timed("stageD_skip", skip)
    full = timed("decode_full", lambda: model.decode(feat_t, x, t))
    print(json.dumps({"case": "sum_of_stages", "ms": round(total, 3),
                      "of_decode_full": round(total / full, 3)}), flush=True)


if __name__ == "__main__":
    main()
