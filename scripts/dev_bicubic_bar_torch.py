#!/usr/bin/env python
"""The dev split's bicubic t = 0 bar (counterpart of
``tools/dev_bicubic_bar.py``).

Renders (or reuses) the dev scenes the in-training ``Validator`` probes
(``stif_tpu_torch/train/validation.py``: seed 880,000, 3 scenes of 12
frames at 144x192) and records once the Y-PSNR of MATLAB-bicubic x4 down
and up at t = 0, the bar a model must clear. Host only: the native frame
ops (``data/native.py``).

    python scripts/dev_bicubic_bar_torch.py [--root runs/val_data]

Writes ``<root>/BICUBIC_BAR.json`` and prints its line.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main(argv=None) -> dict:
    from stif_tpu_torch.data.native import host_imresize
    from stif_tpu_torch.data.synthetic import render_eval_folders
    from stif_tpu_torch.runtime.eval import _load_frames
    from stif_tpu_torch.utils.metrics import bgr2ycbcr, calculate_psnr

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="runs/val_data")
    args = ap.parse_args(argv)

    root = render_eval_folders(args.root, n_scenes=3, n_frames=12,
                               size=(144, 192), seed0=880_000)
    vals = []
    for d in sorted(os.listdir(root)):
        folder = os.path.join(root, d)
        if not os.path.isdir(folder):
            continue
        gt = _load_frames(folder)
        # the x4 space-time protocol feeds every 2nd frame at 1/4 scale;
        # t = 0 reconstructions are compared with the even GT frames
        for i in range(0, gt.shape[0] - 1, 2):
            up = host_imresize(host_imresize(gt[i], 0.25), 4.0)
            p = bgr2ycbcr(np.clip(up, 0, 1)[..., ::-1].astype(np.float32))
            r = bgr2ycbcr(gt[i][..., ::-1].astype(np.float32))
            vals.append(calculate_psnr(p * 255, r * 255))
    rec = {"t0_psnr_y": round(float(np.mean(vals)), 4),
           "n_frames": len(vals),
           "protocol": "dev split seed 880k, x4 bicubic down+up, Y-PSNR"}
    with open(os.path.join(root, "BICUBIC_BAR.json"), "w") as f:
        json.dump(rec, f, indent=2)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
