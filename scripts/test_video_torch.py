#!/usr/bin/env python
"""Video inference script of the PyTorch/CUDA port (counterpart of
``scripts/test_video.py``).

Reads a directory of frame folders, applies the x2 MATLAB-bicubic LR
degradation, renders ``--times`` intermediate frames per adjacent pair at
``--scale`` and writes HR / bicubic-baseline / LR outputs under
``<output>/<folder>/{HR,bicubic,LR}``.

Usage:
  python scripts/test_video_torch.py --input video_sequences/ --output output/ \
      [--checkpoint latest_G.pth | --params params_N.pth] [--times 8] \
      [--scale 4] [--device cuda]

Runs on a CUDA GPU and raises when there is none; ``--device cpu`` runs on
the CPU. The model is ``LunaTokis()`` as ``scripts/test_video.py`` builds it
(nf 64, 5 + 40 residual blocks, the reference's absolute-RGB head), the form
a reference ``latest_G.pth`` was trained in. Like its counterpart it has no
flag for the ``rgb_skip`` head, which shares the parameter schema.
``--params`` reads weights written by the port's trainer
(``train/checkpoints.py``: a ``params_<step>.pth`` / ``ema_params_<step>.pth``
state dict, or the params of a ``checkpoint_<step>.pth``), where the JAX
script reads an orbax directory.
"""

import argparse
import os
import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", default="output")
    weights = ap.add_mutually_exclusive_group()
    weights.add_argument("--checkpoint", default=None,
                         help="reference-schema .pth weights")
    weights.add_argument("--params", default=None,
                         help="weights written by the port's trainer")
    ap.add_argument("--times", type=int, default=8)
    ap.add_argument("--scale", type=int, default=4)
    ap.add_argument("--folders", nargs="*", default=None)
    ap.add_argument("--no-degrade", action="store_true",
                    help="inputs are already LR; skip the x2 downscale")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    import cv2
    import torch

    from stif_tpu_torch.convert import load_pth
    from stif_tpu_torch.models import LunaTokis
    from stif_tpu_torch.ops import imresize
    from stif_tpu_torch.runtime import InferencePipeline
    from stif_tpu_torch.utils.metrics import tensor2img

    model = LunaTokis()
    if args.checkpoint:
        load_pth(model, args.checkpoint)
    elif args.params:
        from stif_tpu_torch.train.checkpoints import load_params

        state = load_params(args.params)
        # a full checkpoint holds the params beside the optimizer state
        model.load_state_dict(state.get("params", state), strict=True)
    else:
        print("WARNING: no weights given — running with random init")
    pipe = InferencePipeline(model, scale=args.scale, device=args.device)

    folders = args.folders or sorted(
        d for d in os.listdir(args.input)
        if osp.isdir(osp.join(args.input, d))
    )
    times = [i / args.times for i in range(args.times)]
    for folder in folders:
        fdir = osp.join(args.input, folder)
        names = sorted(os.listdir(fdir))
        out_hr = osp.join(args.output, folder, "HR")
        out_bic = osp.join(args.output, folder, "bicubic")
        out_lr = osp.join(args.output, folder, "LR")
        for d in (out_hr, out_bic, out_lr):
            os.makedirs(d, exist_ok=True)

        idx = 0
        for i in range(len(names) - 1):
            imgs = []
            for name in (names[i], names[i + 1]):
                img = cv2.imread(osp.join(fdir, name), cv2.IMREAD_UNCHANGED)
                img = img.astype(np.float32) / 255.0
                if not args.no_degrade:
                    img = imresize(torch.from_numpy(img), 0.5).numpy()
                imgs.append(img[..., [2, 1, 0]])  # BGR -> RGB
            frames = np.stack(imgs)
            cv2.imwrite(osp.join(out_lr, names[i]),
                        tensor2img(frames[0][..., ::-1]))
            out = pipe.render_window(frames, times)
            h, w = frames.shape[1:3]
            for ti in range(out.shape[0]):
                cv2.imwrite(osp.join(out_hr, f"{idx}.jpg"),
                            tensor2img(out[ti][..., ::-1]))
                bic = cv2.resize(tensor2img(frames[0][..., ::-1]),
                                 (w * args.scale, h * args.scale),
                                 interpolation=cv2.INTER_CUBIC)
                cv2.imwrite(osp.join(out_bic, f"{idx}.jpg"), bic)
                idx += 1
            print(f"{folder}: pair {i} -> {out.shape[0]} frames")


if __name__ == "__main__":
    main()
