"""The control readings of ``liif-train-x4t8-720p``, as ``control.py``
reads the other serving cells: the reference in TF32 (the nearest
precision below the configuration's fp32 with TF32 off) against the fp32
reference, over the cell's sample of windows (the pool's first), at the
cell's own sizes, with the weights its entry makes. The benchmark's runs
never run this; its readings set the upper end of each limit (``PERF.md``).

    python benchmark/control_liif_train.py --seeds <n> [<n> ...]

Prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness, run as bench_run  # noqa: E402
from benchmark.traffic import generate  # noqa: E402

CELL = "liif-train-x4t8-720p"


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    w, config, traffic, cell = bench_run.cell_files(harness.manifest(ROOT),
                                                    CELL)
    entry = harness.load_module(harness.BENCH / "entries"
                                / f"{cell['entry']}.py")
    for seed in args.seeds:
        t = time.perf_counter()
        r = harness.Run(name=CELL, config=config, traffic=traffic, cell=cell,
                        seed=seed, seconds=0.0, trace=False,
                        device=torch.device("cuda", 0), root=ROOT, started=t)
        _, state = entry.weights_of(r)
        worst = [0.0, 0.0]
        for window in generate.windows(traffic, seed, r.device)[
                :cell["check"]["sample"]]:
            low = entry.reference(state, r, window, tf32=True)
            gaps = harness.frame_gaps(low.cpu().numpy(),
                                      entry.reference(state, r, window))
            worst = [max(a, b) for a, b in zip(worst, gaps)]
        print(json.dumps({"workload": CELL, "seed": seed,
                          "seconds": time.perf_counter() - t,
                          "control": "tf32", "max_abs_err": worst[0],
                          "rms_err": worst[1]}), flush=True)
        del state
        harness.free(r.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
