"""The benchmark of ``stif_tpu_torch`` on the card: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Reads the cell from ``BENCHMARK.json`` and its files by name (see
``benchmark/harness.py``), runs the cell's entry on the card, and prints
the result as the last line of standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``,
and last ``checks``, the compared numbers beside their limits, which also
end standard error. Exits 2, printing no result, without enough CUDA
devices; 3 when a JAX module was loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"not read ({e.__class__.__name__})"


def cell_files(man: dict, name: str, overrides=None) -> tuple:
    """(workload, config, traffic, cell) of cell ``name``, each found by its
    name; ``overrides`` ({'config': {...}, ...}) updates the loaded files
    (the CPU tests' small sizes)."""
    w = harness.workload(man, name)
    files = {"config": harness.BENCH / "configs" / f"{w['config']}.json",
             "traffic": harness.BENCH / "traffic" / f"{w['traffic']}.json",
             "cell": harness.BENCH / "cells" / f"{name}.json"}
    out = {k: harness.load_json(p) for k, p in files.items()}
    for k, v in (overrides or {}).items():
        out[k] = {**out[k], **v}
    return w, out["config"], out["traffic"], out["cell"]


def result(man, w, outcome: harness.Outcome, trace: bool, card: str,
           started: float) -> dict:
    metrics = {}
    if trace and card != "cpu":  # a CPU run gives no device metric
        for m in harness.per_layer(man, w["name"]):
            reader = harness.load_module(harness.reader_path(m["name"]))
            value = reader.read(outcome, card)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    elif not trace:
        measured = dict(outcome.e2e, setup_s=outcome.setup_end - started)
        for m in harness.end_to_end(man, w["name"]):
            metrics[m["name"]] = {"value": measured[m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu" if card != "cpu" else "cpu", "kind": card,
              "count": w["chips"],
              "memory_peak_bytes": outcome.memory_peak_bytes}
    line = {"correct": harness.correct(outcome.checks),
            "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device}
    if trace and outcome.slice is not None:
        device["busy_s"] = outcome.slice["busy_s"]
        device["window_s"] = outcome.slice["wall_s"]
        line["breakdown"] = {"device_ops": outcome.slice["device_ops"],
                             "idle_gaps": outcome.slice["idle_gaps"]}
    line["checks"] = {n: {"value": v, "limit": lim}
                      for n, v, lim in outcome.checks}
    return line


def main(argv=None, device=None, overrides=None,
         started: float = STARTED) -> int:
    """One run. ``device`` None asks for the card and refuses to run
    without one; the CPU tests pass a device (and ``overrides``)."""
    args = parse(argv)
    man = harness.manifest(ROOT)
    w, config, traffic, cell = cell_files(man, args.workload, overrides)
    if device is None:
        import torch

        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < w["chips"]):
            print(f"{w['name']} needs {w['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count()}: no result",
                  file=sys.stderr)
            return 2
        from benchmark.roofline.peaks import peak

        device = torch.device("cuda", 0)
        card = torch.cuda.get_device_name(0)
        peak(card)  # a card the table lacks raises here
        print(f"card: {power_limit()}", file=sys.stderr)
    else:
        card = "cpu"
    os.environ.setdefault("USE_FLAX", "0")
    # the port builds its kernels into its own fixed stif_tpu_torch/_build;
    # any other kernel cache stays at a fixed path inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    entry = harness.load_module(harness.BENCH / "entries"
                                / f"{cell['entry']}.py")
    outcome = entry.run(harness.Run(
        name=w["name"], config=config, traffic=traffic, cell=cell,
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device=device, root=ROOT, started=started))
    found = harness.forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {', '.join(found)}; "
              "no result", file=sys.stderr)
        return 3
    line = result(man, w, outcome, bool(args.trace), card, started)
    print(json.dumps({"notes": outcome.notes}, default=str), file=sys.stderr)
    for name, v in line["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
