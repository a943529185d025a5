#!/usr/bin/env python
"""Measure the learned DCN offset ranges of a checkpoint (counterpart of
``tools/offset_stats.py``).

Decides whether ``impl='dense'`` is exact for a given ``shift_bound``: runs
the encoder on a clip rendered by ``data/synthetic.py``, captures every
``conv_offset_mask`` output with forward hooks, splits it into per-tap
offsets, and reports ``dcn_shift_stats`` (the largest |shift| a dense DCN
needs, the tap included, plus 1) per DCN call and overall, with a quantile
of it and the spread of each (pixel, group)'s taps (the statistic that
sizes the JAX package's windowed gather).

    python scripts/offset_stats_torch.py [--weights weights/trained_best_G.pth]
        [--size 64] [--device cuda]

The model is the deployed ``LunaTokis`` (nf 64, groups 8, 5 + 40 blocks).
Prints one JSON document. Runs on CUDA unless ``--device cpu`` is given.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

CLIP_SEED = 990_100  # the JAX tool's clip: far from the training seeds


def site_stats(name: str, offset, quantile: float) -> dict:
    """One DCN call's statistics from its offsets (B, H, W, G, K, 2)."""
    from stif_tpu_torch.ops.deform_conv import dcn_shift_stats

    off = offset.detach().cpu().numpy()
    kh = int(round(off.shape[-2] ** 0.5))
    ti = (np.arange(kh) - kh // 2).repeat(kh).astype(np.float32)
    tj = np.tile(np.arange(kh) - kh // 2, kh).astype(np.float32)
    py, px = off[..., 0] + ti, off[..., 1] + tj
    d = np.maximum(np.abs(py), np.abs(px))
    spread = np.maximum(py.max(-1) - py.min(-1), px.max(-1) - px.min(-1))
    return {
        "site": f"{name}_H{off.shape[1]}xW{off.shape[2]}",
        "max_shift": round(float(dcn_shift_stats(offset.detach().cpu(), kh)),
                           2),
        f"q{quantile}": round(float(np.quantile(d, quantile)) + 1.0, 2),
        "tap_spread_max": round(float(spread.max()), 2),
        "tap_spread_q999": round(float(np.quantile(spread, 0.999)), 2),
        "tap_spread_q99": round(float(np.quantile(spread, 0.99)), 2),
        "tap_spread_med": round(float(np.median(spread)), 2),
    }


def capture_offsets(model, x):
    """Run ``gen_feat`` on ``x`` and return [(call name, offsets)] of every
    DCN call, in call order."""
    import torch

    from stif_tpu_torch.nn.dcn import DCNSep
    from stif_tpu_torch.ops.deform_conv import split_offset_mask

    calls, handles = [], []
    for name, mod in model.named_modules():
        if isinstance(mod, DCNSep):
            def hook(conv, args, out, name=name, dcn=mod):
                offset, _ = split_offset_mask(out, dcn.deformable_groups,
                                              dcn.kernel_size)
                calls.append((f"call{len(calls):02d}_{name}", offset))
            handles.append(mod.conv_offset_mask.register_forward_hook(hook))
    try:
        with torch.inference_mode():
            model.gen_feat(x)
    finally:
        for h in handles:
            h.remove()
    return calls


def main(argv=None) -> dict:
    import torch

    from stif_tpu_torch.data.native import host_imresize
    from stif_tpu_torch.data.synthetic import render_sequence
    from stif_tpu_torch.runtime import bench
    from stif_tpu_torch.runtime.pipeline import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", default=str(bench.WEIGHTS),
                    help="a reference-schema .pth")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=64, help="LR clip size")
    ap.add_argument("--quantile", type=float, default=0.9999)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    model = bench.build(device, args.weights, bench.Knobs())
    g = args.size * 4
    hr = render_sequence(CLIP_SEED, 9, (g, g))
    lr = host_imresize(np.stack([hr[0], hr[8]]), 0.25)
    x = torch.from_numpy(np.ascontiguousarray(lr[None], np.float32)).to(device)
    rows = [site_stats(name, off, args.quantile)
            for name, off in capture_offsets(model, x)]
    gmax = max(r["max_shift"] for r in rows)
    out = {
        "weights": args.weights,
        "device": bench.device_info(device),
        "n_dcn_calls": len(rows),
        "global_max_shift": round(gmax, 2),
        "dense_ok_bound": int(np.ceil(gmax)),
        "sites": sorted(rows, key=lambda r: -r["max_shift"]),
    }
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
