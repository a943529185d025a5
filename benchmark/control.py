"""The control readings of a cell: the reference put in the program's place
in the nearest precision below the configuration's (TF32 for the fp32 with
TF32 off that every configuration states), and for the train cell the
half-batch fault planted in it, compared with the fp32 reference by the
cell's own comparison at the cell's own sizes. The benchmark's runs never
run this; its readings set the upper end of each limit (``PERF.md``).

    python benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

Prints one JSON line per seed and reading.
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

from benchmark import harness, run as bench_run, weights  # noqa: E402
from benchmark.traffic import generate  # noqa: E402


def state_of(r: harness.Run):
    """The cell's weights as a run makes them, from the model's schema."""
    from stif_tpu_torch.models.factory import define_g

    net = define_g({"network_G": r.config["network_G"]})
    shapes = {k: v.shape for k, v in net.state_dict().items()}
    return weights.make(r.config["weights"], shapes, r.seed, r.root, r.device)


def serving(r: harness.Run, entry) -> list:
    """(max_abs_err, rms_err) of the TF32 reference against the fp32 one
    over the cell's sample of windows (the pool's first)."""
    state = state_of(r)
    pool = generate.windows(r.traffic, r.seed, r.device)
    worst = [0.0, 0.0]
    for w in pool[:r.cell["check"]["sample"]]:
        harness.fp32(tf32=True)
        low = entry.reference(state, r, w).cpu().numpy()
        harness.fp32()
        gaps = harness.frame_gaps(low, entry.reference(state, r, w))
        worst = [max(a, b) for a, b in zip(worst, gaps)]
    return [{"control": "tf32", "max_abs_err": worst[0],
             "rms_err": worst[1]}]


def training(r: harness.Run, entry) -> list:
    """The train cell's numbers for the TF32 reference and for the
    half-batch fault, each against the fp32 reference."""
    state = state_of(r)
    ema0 = weights.lagging(state, r.traffic["ema_lag"], r.seed, r.device)
    pool = generate.train_batches(r.traffic, r.config["train_batch_size"],
                                  r.seed, r.device)
    harness.fp32()
    ref = entry.reference(state, ema0, r, pool)
    out = []
    for name, tf32, half in (("tf32", True, False),
                             ("half_batch", False, True)):
        harness.fp32(tf32=tf32)
        low = entry.reference(state, ema0, r, pool, half_batch=half)
        harness.fp32()
        nums = entry.readings(
            {k: v.cpu() for k, v in low["grad"].items()},
            {k: v.cpu() for k, v in low["params"].items()},
            {k: v.cpu() for k, v in low["ema"].items()},
            low["loss"], state, ema0, ref)
        out.append({"control": name, **dict(nums)})
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    man = harness.manifest(ROOT)
    w, config, traffic, cell = bench_run.cell_files(man, args.workload)
    entry = harness.load_module(harness.BENCH / "entries"
                                / f"{cell['entry']}.py")
    for seed in args.seeds:
        t = time.perf_counter()
        r = harness.Run(name=w["name"], config=config, traffic=traffic,
                        cell=cell, seed=seed, seconds=0.0, trace=False,
                        device=torch.device("cuda", 0), root=ROOT,
                        started=t)
        read = training if cell["entry"] == "train_step" else serving
        for rec in read(r, entry):
            print(json.dumps({"workload": w["name"], "seed": seed,
                              "seconds": time.perf_counter() - t, **rec}),
                  flush=True)
        harness.free(r.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
