#!/usr/bin/env python
"""Where the bench's b1 window spends its time, on the card (counterpart of
``tools/profile_bench.py``).

    python scripts/profile_bench_torch.py [--out PROFILE.json] [--eager]

Streams the bench's b1 workload (``stif_tpu_torch/runtime/bench.py``: LR
96x160 pairs, 8 times, x4, the deployed model and trained weights, the
``BENCH_*`` knobs), then captures one streamed window with
``torch.profiler`` (a Chrome trace under ``runs/profile_torch/``) and
prints ONE JSON line (``stif_tpu_torch/runtime/profile.py``): the window's
device time by model stage from the stage marks (``stages``: the encoder's
front, PCD alignment, ConvLSTM and trunk, the decoder's prep, stages A+B
and C+D), the device time by the host span that launched it, the top
device ops, the idle share of an unprofiled window, the longest idle gaps
with what the host was doing in each, and the host-blocking calls per
window. On the card the captured window replays the bucket's CUDA graph,
marks included; ``--eager`` profiles an eager window. ``--out`` also
writes the line to a file.

Runs on CUDA unless ``--device cpu`` is given (the device fields are then
None), and raises without a GPU.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> dict:
    from stif_tpu_torch.runtime import bench, profile
    from stif_tpu_torch.runtime.pipeline import resolve_device

    ap = argparse.ArgumentParser()
    bench.add_workload_args(ap)
    bench.add_eager_arg(ap)
    ap.add_argument("--trace", default=str(profile.TRACE),
                    help="where the Chrome trace goes")
    ap.add_argument("--out", default=None, help="also write the line here")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rec = profile.run(device, bench.Knobs.from_env(), trace=args.trace,
                      compiled=False if args.eager else None,
                      **bench.workload_kwargs(args))
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return rec


if __name__ == "__main__":
    main()
