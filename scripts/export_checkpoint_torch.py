#!/usr/bin/env python
"""Export weights trained by the port as a reference-schema ``.pth``
(counterpart of ``tools/export_torch_checkpoint.py``).

The reference's deployed inference loads ``latest_G.pth`` with
``strict=True``; this tool writes the state dict of the config's generator
with exactly that module-name schema from a training run of
``scripts/train_torch.py``: the checkpoint ``--step`` in the config's
``path.models`` (the latest without it), or the keep-best weights
(``--best``, ``best.json``). The file loads with ``strict=True`` into the
port's model and into the reference's.

    python scripts/export_checkpoint_torch.py -opt CONFIG.yml [--step N |
        --best] --out latest_G.pth
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))


def main(argv=None) -> str:
    import torch

    from stif_tpu_torch.models.factory import define_g
    from stif_tpu_torch.utils.config import parse_options

    sys.path.insert(0, HERE)
    from eval_model_torch import load_weights  # noqa: E402

    ap = argparse.ArgumentParser()
    ap.add_argument("-opt", required=True)
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--best", action="store_true",
                    help="export the keep-best weights (best.json) instead "
                         "of the latest full checkpoint")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    args.pth = None

    opt = parse_options(args.opt, is_train=False)
    net = define_g(opt)
    load_weights(net, args, opt)
    tensors = {k: v.detach().cpu().contiguous()
               for k, v in net.state_dict().items()}
    torch.save(tensors, args.out)
    n = sum(v.numel() for v in tensors.values())
    print(f"wrote {args.out}: {len(tensors)} tensors, {n:,} params "
          f"(checkpoint step {args.ckpt_step})")
    return args.out


if __name__ == "__main__":
    main()
