#!/usr/bin/env python
"""End-to-end quality evaluation of a checkpoint with the PyTorch/CUDA port
(counterpart of ``scripts/eval_model.py``).

Protocol: the Vid4 space-time recipe: LR input = every 2nd frame
MATLAB-bicubic downscaled x4; query times t in {0.5, 0}; Y-channel
MATLAB-convention PSNR / SSIM, plus a bicubic-upsample baseline on the same
frames, the x8 temporal protocol with its frame-hold baseline, and on
request a spatial scale sweep, the x16 protocols and the three synthetic
scene families.

The eval sequences are deterministic procedural scenes
(``stif_tpu_torch.data.synthetic``) rendered to PNG folders.

Usage:
  python scripts/eval_model_torch.py -opt configs/train_synthetic.yml \
      [--pth weights/trained_best_G.pth | --best | --step N] \
      [--gather-dtype bf16] [--scenes 4] [--out EVAL.json] [--device cuda]

Runs on a CUDA GPU and raises when there is none; ``--device cpu`` runs on
the CPU. The weights come from a reference-schema ``.pth`` (``--pth``), the
keep-best weights of a training run (``--best``, ``best.json`` in
``path.models``), or a training checkpoint in ``path.models`` (``--step``,
the latest without it). ``--wide`` adds the natural-photo families when
bundled photographs are found.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def build_eval_set(root: str, n_scenes: int = 4, n_frames: int = 12,
                   size=(144, 192), seed0: int = 990_000) -> str:
    """Render deterministic eval scenes to <root>/scene<k>/*.png (idempotent).
    Seeds are far outside the training sampler's (seed, index) range."""
    from stif_tpu_torch.data.synthetic import render_eval_folders

    return render_eval_folders(root, n_scenes=n_scenes, n_frames=n_frames,
                               size=size, seed0=seed0)


def _clips(gt_root: str, multiple: int, folders=None):
    """The clips of ``gt_root`` (every folder, or ``folders``), cropped to
    multiples of ``multiple``."""
    from stif_tpu_torch.runtime.eval import _crop, _load_frames

    for name in folders or sorted(os.listdir(gt_root)):
        folder = os.path.join(gt_root, name)
        if os.path.isdir(folder):
            yield _crop(_load_frames(folder), multiple)


def _bicubic_round_trip(gt: np.ndarray, downscale: float) -> np.ndarray:
    """MATLAB-bicubic downscale of a clip and back up to its size."""
    from stif_tpu_torch.data.datasets import host_imresize

    return host_imresize(host_imresize(gt, downscale),
                          float(round(1 / downscale)))


def frame_hold_x8_baseline(gt_root: str, downscale: float = 0.25) -> dict:
    """x8-temporal naive baseline: hold the nearest input frame (i or i+8),
    bicubic-upsampled x4: per-time-index Y-PSNR, the number the model's
    temporal interpolation must beat at mid times."""
    from stif_tpu_torch.runtime.eval import _metric_pair

    per_time = [[] for _ in range(8)]
    for gt in _clips(gt_root, int(round(1 / downscale))):
        up = _bicubic_round_trip(gt, downscale)
        for i in range(0, gt.shape[0] - 8, 8):
            for ti in range(8):
                src = i if ti <= 4 else i + 8
                per_time[ti].append(_metric_pair(
                    np.clip(up[src], 0, 1), gt[i + ti], True)[0])
    pt = [float(np.mean(v)) for v in per_time if v]
    return {"per_time_psnr": pt,
            "mean_psnr": float(np.mean([x for v in per_time for x in v]))}


def bicubic_baseline(gt_root: str, downscale: float = 0.25,
                     folders=None) -> dict:
    """PSNR / SSIM of MATLAB-bicubic x4 upsampling of the LR inputs (t = 0)
    and of frame-hold for t = 0.5: what the model must beat."""
    from stif_tpu_torch.runtime.eval import _metric_pair

    res = {"t0_psnr": [], "t0_ssim": [], "t05_psnr": [], "t05_ssim": []}
    m = int(round(1 / downscale))
    for gt in _clips(gt_root, m * 2, folders):
        up = _bicubic_round_trip(gt, downscale)
        for gi in list(range(0, gt.shape[0], 2))[:-1]:
            pred0 = np.clip(up[gi], 0, 1)
            p, s = _metric_pair(pred0, gt[gi], True)
            res["t0_psnr"].append(p)
            res["t0_ssim"].append(s)
            if gi + 1 < gt.shape[0]:  # t = 0.5: hold the nearest input frame
                p, s = _metric_pair(pred0, gt[gi + 1], True)
                res["t05_psnr"].append(p)
                res["t05_ssim"].append(s)
    return {k: float(np.mean(v)) for k, v in res.items()}


def eval_scale_sweep(net, gt_root, scales=(2, 3, 8), device=None) -> dict:
    """Arbitrary spatial scale: LR = MATLAB-bicubic 1/s of GT, the same
    weights decode x s back to the GT resolution, Y-PSNR / SSIM at t in
    {0, 0.5} (every-2nd-frame input pairs), against the bicubic x s
    baseline."""
    from stif_tpu_torch.runtime import InferencePipeline
    from stif_tpu_torch.data.datasets import host_imresize
    from stif_tpu_torch.runtime.eval import _metric_pair

    out = {}
    for s in scales:
        pipe = InferencePipeline(net, scale=int(s), bucket=4, device=device)
        acc = {"t0_psnr": [], "t0_ssim": [], "t05_psnr": [], "t05_ssim": [],
               "bi_t0_psnr": [], "bi_t0_ssim": []}
        for gt in _clips(gt_root, 2 * s):
            lr = host_imresize(gt, 1.0 / s)
            up = host_imresize(lr, float(s))
            for gi in list(range(0, gt.shape[0], 2))[:-1]:
                pred = pipe.render_window(np.stack([lr[gi], lr[gi + 2]]),
                                          [0.0, 0.5])
                p0, s0 = _metric_pair(np.clip(pred[0], 0, 1), gt[gi], True)
                acc["t0_psnr"].append(p0)
                acc["t0_ssim"].append(s0)
                if gi + 1 < gt.shape[0]:
                    p5, s5 = _metric_pair(np.clip(pred[1], 0, 1), gt[gi + 1],
                                          True)
                    acc["t05_psnr"].append(p5)
                    acc["t05_ssim"].append(s5)
                bp, bs_ = _metric_pair(np.clip(up[gi], 0, 1), gt[gi], True)
                acc["bi_t0_psnr"].append(bp)
                acc["bi_t0_ssim"].append(bs_)
        out[f"x{s}"] = {k: round(float(np.mean(v)), 3)
                        for k, v in acc.items() if v}
    return out


def load_weights(net, args, opt) -> None:
    """Load into ``net``, strictly: ``--pth``, else ``--best``, else the
    training checkpoint ``--step`` (the latest without it) in
    ``path.models``. Sets ``args.weights_src`` and ``args.ckpt_step``."""
    from stif_tpu_torch.convert import load_pth
    from stif_tpu_torch.train.checkpoints import CheckpointManager
    from stif_tpu_torch.train.validation import load_best_params

    ckpt_dir = (opt.get("path") or {}).get("models")
    if not (args.pth or ckpt_dir):
        raise ValueError("no weights: pass --pth, or a config whose "
                         "path.models holds a training run")
    if args.pth:
        load_pth(net, args.pth)
        args.ckpt_step = args.step or -1
        args.weights_src = args.pth
        print(f"loaded weights from {args.pth}")
        return
    if args.best:
        params, best = load_best_params(ckpt_dir)
        args.ckpt_step = int(best["step"])
        args.weights_src = best["path"]
        print(f"loaded keep-best step {args.ckpt_step} "
              f"(dev score {best['score']}) from {ckpt_dir}")
    else:
        ck = CheckpointManager(ckpt_dir).restore(args.step)
        params = ck["params"]
        args.ckpt_step = int(ck["step"])
        args.weights_src = ckpt_dir
        print(f"restored step {args.ckpt_step} from {ckpt_dir}")
    net.load_state_dict(params, strict=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-opt", required=True)
    ap.add_argument("--step", type=int, default=None,
                    help="restore this training checkpoint (default: latest)")
    ap.add_argument("--best", action="store_true",
                    help="load the keep-best weights (best.json) instead of "
                         "the latest full checkpoint")
    ap.add_argument("--pth", default=None,
                    help="load weights from a reference-schema .pth export")
    ap.add_argument("--gather-dtype", default=None, choices=[None, "bf16"])
    ap.add_argument("--mlp-dtype", default=None, choices=[None, "bf16"])
    ap.add_argument("--stagec-nearest", action="store_true",
                    help="quality-gate knob: nearest gather for the wide "
                         "stage-C feat component (LunaTokis.stagec_nearest)")
    ap.add_argument("--stagec-dedup", action="store_true",
                    help="quality-gate knob: time-axis dedup of the stage-C "
                         "LR gather (bit-exact; memory-shape change only)")
    ap.add_argument("--stagec-dtype", default=None,
                    choices=[None, "fp8", "bf16"],
                    help="quality-gate knob: storage dtype for decoder "
                         "bilinear-gather sources (fp32 interpolation)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--scenes", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--eval-root", default="runs/eval_data")
    ap.add_argument("--scale-sweep", default="2,3,8",
                    help="comma list of extra spatial scales ('' disables)")
    ap.add_argument("--x16", action="store_true",
                    help="also run the x16 adobe_4x/liif4x protocols")
    ap.add_argument("--self-ensemble", action="store_true",
                    help="x8 geometric self-ensemble (8x decode compute)")
    ap.add_argument("--local-ensemble", action="store_true",
                    help="decode with the local ensemble (4 shifted "
                         "area-weighted passes)")
    ap.add_argument("--test-mode", action="store_true",
                    help="decode in test mode (hr-input upsample)")
    ap.add_argument("--wide", action="store_true",
                    help="also evaluate the widened 3-family suite "
                         "(default/occlusion/lighting, 4 scenes each) with "
                         "per-family mean/std and bicubic baselines")
    args = ap.parse_args(argv)

    from stif_tpu_torch.models.factory import define_g
    from stif_tpu_torch.runtime import InferencePipeline
    from stif_tpu_torch.runtime.eval import (eval_space_time_sr,
                                             eval_temporal_x8)
    from stif_tpu_torch.utils.config import parse_options
    from stif_tpu_torch.utils.provenance import stamp

    opt = parse_options(args.opt, is_train=False)
    if args.gather_dtype == "bf16":
        opt["network_G"]["gather_dtype"] = "bf16"
    if args.mlp_dtype == "bf16":
        opt["network_G"]["mlp_dtype"] = "bf16"
    if args.stagec_nearest:
        opt["network_G"]["stagec_nearest"] = True
    if args.stagec_dedup:
        opt["network_G"]["stagec_dedup"] = True
    if args.stagec_dtype:
        opt["network_G"]["stagec_dtype"] = args.stagec_dtype
    net = define_g(opt)
    load_weights(net, args, opt)

    gt_root = build_eval_set(args.eval_root, n_scenes=args.scenes)
    baseline = bicubic_baseline(gt_root)

    pipe = InferencePipeline(net, scale=4, bucket=8, device=args.device,
                             test_mode=args.test_mode,
                             local_ensemble=args.local_ensemble,
                             self_ensemble=args.self_ensemble)
    t0 = time.time()
    res = eval_space_time_sr(pipe, gt_root, times=(0.5, 0.0))
    wall = time.time() - t0

    res_x8 = eval_temporal_x8(pipe, gt_root)
    hold = frame_hold_x8_baseline(gt_root)

    scale_sweep = None
    if args.scale_sweep:
        scales = [int(s) for s in args.scale_sweep.split(",") if s]
        scale_sweep = eval_scale_sweep(net, gt_root, scales=scales,
                                       device=args.device)

    x16 = None
    if args.x16:
        from stif_tpu_torch.runtime.eval import (eval_adobe_4x,
                                                 eval_adobe_liif4x)
        from stif_tpu_torch.utils.metrics import calculate_psnr

        pipe16 = InferencePipeline(net, scale=16, bucket=4,
                                   device=args.device)
        r4 = eval_adobe_4x(pipe16, gt_root)
        rl = eval_adobe_liif4x(pipe16, gt_root)
        # bicubic x16 baseline under the adobe_4x crop / metric conventions
        bi = []
        for gt in _clips(gt_root, 64):
            up = _bicubic_round_trip(gt, 1 / 16)
            for i in range(0, gt.shape[0] - 4, 4):
                bi.append(calculate_psnr(np.clip(up[i], 0, 1) * 255,
                                         gt[i] * 255))
        x16 = {
            "adobe_4x_mean_psnr_rgb": round(r4.mean_psnr, 3),
            "adobe_4x_mean_ssim_rgb": round(r4.mean_ssim, 4),
            "adobe_liif4x_mean_psnr_y": round(rl.mean_psnr, 3),
            "adobe_liif4x_mean_ssim_y": round(rl.mean_ssim, 4),
            "bicubic_x16_t0_psnr_rgb": round(float(np.mean(bi)), 3),
        }

    wide = None
    if args.wide:
        from stif_tpu_torch.data.natural import (build_natural_eval_set,
                                                 build_natural_eval_set_v2)
        from stif_tpu_torch.data.synthetic import render_eval_suite

        suite_root = render_eval_suite("runs/eval_suite")
        # natural-photo families, when bundled photos are found: v1 the
        # integer pan, v2 layered subpixel motion with occluding layers
        fams = ("default", "occlusion", "lighting")
        if build_natural_eval_set(suite_root):
            fams += ("natural",)
        if build_natural_eval_set_v2(suite_root):
            fams += ("naturalv2",)
        wide = {}
        for fam in fams:
            # prefix match, but 'natural' must not take 'naturalv2_*'
            folders = sorted(
                d for d in os.listdir(suite_root)
                if d.startswith(fam)
                and not (fam == "natural" and d.startswith("naturalv2"))
                and os.path.isdir(os.path.join(suite_root, d)))
            r = eval_space_time_sr(pipe, suite_root, folders=folders,
                                   times=(0.5, 0.0))
            bi = bicubic_baseline(suite_root, folders=folders)
            wide[fam] = {
                "scenes_psnr_y": {k: round(v, 3) for k, v in r.psnr.items()},
                "mean_psnr_y": round(r.mean_psnr, 3),
                "std_psnr_y": round(float(np.std(list(r.psnr.values()))), 3),
                "mean_ssim_y": round(r.mean_ssim, 4),
                "psnr_y_by_time": {f"t{t}": round(v, 3)
                                   for t, v in r.psnr_by_time.items()},
                "ssim_y_by_time": {f"t{t}": round(v, 4)
                                   for t, v in r.ssim_by_time.items()},
                "baseline_bicubic": {k: round(v, 3) for k, v in bi.items()},
            }

    rec = {
        "protocol": "vid4_space_time_x4 (myutils.test_metric_full)",
        "provenance": stamp(weights=args.weights_src, step=args.ckpt_step,
                            config=args.opt),
        "checkpoint_step": args.ckpt_step,
        "gather_dtype": args.gather_dtype or "fp32",
        "mlp_dtype": args.mlp_dtype or "fp32",
        "stagec": {"nearest": args.stagec_nearest,
                   "dedup": args.stagec_dedup,
                   "dtype": args.stagec_dtype or "inherit"},
        "decode_mode": ("localensemble" if args.local_ensemble else
                        "test" if args.test_mode else "decoding")
                       + ("+self_ensemble" if args.self_ensemble else ""),
        "rgb_skip": ("bicubic" if getattr(net, "rgb_skip_bicubic", False)
                     else bool(getattr(net, "rgb_skip", False))),
        "psnr_y": {k: round(v, 3) for k, v in res.psnr.items()},
        "ssim_y": {k: round(v, 4) for k, v in res.ssim.items()},
        "mean_psnr_y": round(res.mean_psnr, 3),
        "mean_ssim_y": round(res.mean_ssim, 4),
        "psnr_y_by_time": {f"t{t}": round(v, 3)
                           for t, v in res.psnr_by_time.items()},
        "ssim_y_by_time": {f"t{t}": round(v, 4)
                           for t, v in res.ssim_by_time.items()},
        "avg_window_time_s": round(res.avg_time_s, 3),
        "wall_s": round(wall, 1),
        "baseline_bicubic": {k: round(v, 3) for k, v in baseline.items()},
        "x8_temporal": {
            "mean_psnr_y": round(res_x8.mean_psnr, 3),
            "per_time_psnr_y": [round(v, 2) for v in res_x8.per_time_psnr],
            "baseline_frame_hold": {
                "mean_psnr_y": round(hold["mean_psnr"], 3),
                "per_time_psnr_y": [round(v, 2)
                                    for v in hold["per_time_psnr"]],
            },
        },
    }
    if scale_sweep:
        rec["scale_sweep"] = scale_sweep
    if x16:
        rec["x16_protocols"] = x16
    if wide:
        rec["wide_suite"] = wide
    print(json.dumps(rec, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=2)
    return rec


if __name__ == "__main__":
    main()
