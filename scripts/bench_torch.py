#!/usr/bin/env python
"""Headline throughput benchmark of the PyTorch/CUDA port (counterpart of
``bench.py``): LR 96x160 pairs -> 8 frames at x4 with the deployed
``LunaTokis`` and its trained weights, streamed at batch 1
(double-buffered) and in batches of ``BENCH_PAIR_BATCH`` pairs.

    python scripts/bench_torch.py [--repeats 3] [--weights PATH | none]

Prints ONE JSON line: ``{"metric": "frames_per_sec", "value": N, "unit":
"frames/s", "vs_baseline": N, ...}`` with every field of ``bench.py``'s
line, the card's name and power limit, ``mfu`` against the named fp32
peak, SIREN and DCN launches per b1 window, peak memory per mode, and the
per-run values of ``--repeats`` alternating b1 / batched runs (each value
is their median). The knobs are ``bench.py``'s ``BENCH_*`` variables; the
port's defaults run fp32 through the fused SIREN kernel
(``stif_tpu_torch/runtime/bench.py``).

Runs on CUDA unless ``--device cpu`` is given, and raises without a GPU.
Any failure, in any mode, ends the run with a non-zero exit code and no
line: nothing is retried or swallowed. The small-size flags (``--lr-h``,
``--lr-w``, ``--nf``, ``--front-rbs``, ``--back-rbs``, ``--n-times``,
``--iters``) exist for runs on the CPU.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> dict:
    from stif_tpu_torch.runtime import bench
    from stif_tpu_torch.runtime.pipeline import resolve_device

    ap = argparse.ArgumentParser()
    bench.add_workload_args(ap)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rec = bench.run(device, bench.Knobs.from_env(), repeats=args.repeats,
                    **bench.workload_kwargs(args))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
