"""What every cell's run shares: the manifest and the files found by name in
it, the run's context, the card's check, the stream's clocks, and the
result line.

A cell (``workloads`` in ``BENCHMARK.json``) names a configuration and a
traffic mix. The harness finds, by name:

- ``benchmark/configs/<config>.json``: the model, its widths, its weights;
- ``benchmark/traffic/<traffic>.json``: the mix, read by
  ``benchmark/traffic/generate.py``;
- ``benchmark/cells/<cell>.json``: the entry that drives the program
  (``benchmark/entries/<entry>.py``), the traced slice's length and the
  limits of the comparison that decides ``correct``;
- ``benchmark/metrics/<metric>.py``: the per-layer metric's reader; where
  there is none, that of the name with its last ``.<part>`` taken off, so
  ``mfu.py`` reads ``mfu.serve`` and ``mfu.train`` alike.

An entry's ``run(r)`` returns an ``Outcome``; the harness turns it into the
result line. Nothing here imports the program or JAX.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
# compared by whole top-level names: the port's name begins with these
FORBIDDEN = ("jax", "jaxlib", "flax", "stif_tpu")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_module(path: Path):
    """A benchmark file loaded by its path: its name may hold dots and
    dashes."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(metric: str) -> Path:
    """The reader of per-layer metric ``metric``: ``metrics/<metric>.py``,
    else the same with the name's last ``.<part>`` taken off, and so on."""
    name = metric
    while True:
        path = BENCH / "metrics" / f"{name}.py"
        if path.is_file() or "." not in name:
            return path
        name = name.rsplit(".", 1)[0]


def end_to_end(man: dict, cell: str) -> List[dict]:
    return [m for m in man["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer(man: dict, cell: str) -> List[dict]:
    return [m for m in man["per_layer"]
            if cell in m.get("workloads", [cell])]


def forbidden_modules() -> List[str]:
    """The modules loaded whose top-level name is JAX's, flax's or the JAX
    package's."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Run:
    """What an entry is handed: the cell's files, the seed, the window's
    length, whether to trace, the device, the checkout and the clock's
    reading at process start (``time.perf_counter``)."""

    name: str
    config: dict
    traffic: dict
    cell: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    root: Path
    started: float

    @property
    def arch(self) -> dict:
        """The widths and depths the reference and the work functions
        read: nf, groups, front_RBs, back_RBs."""
        net = self.config["network_G"]
        return {k: net[k] for k in ("nf", "groups", "front_RBs",
                                    "back_RBs")}


@dataclasses.dataclass
class Outcome:
    """An entry's result. ``e2e``: the end-to-end metrics it measured (not
    ``setup_s``); ``setup_end``: the clock at the window's start;
    ``window``: {'seconds', 'shapes'}, 'shapes' a list of [unit, times
    done] over the window; ``slice``: the traced slice's ``trace.analyze``
    with 'shapes', one unit per unit traced (None untraced). A unit is a window's or a step's shapes, as
    ``roofline/model.py`` describes them. ``checks``: (name, value, limit)
    of the comparison, each within its limit when correct."""

    attempted: int
    failed: int
    e2e: Dict[str, float]
    setup_end: float
    window: dict
    memory_peak_bytes: int
    checks: List[Tuple[str, float, float]]
    slice: Optional[dict] = None
    notes: Optional[dict] = None


def fp32(tf32: bool = False) -> None:
    """cuDNN convs and matmuls in fp32 (TF32 off), as every configuration
    states; ``tf32`` turns TF32 on (the control's precision)."""
    import torch

    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32


def sync(device) -> None:
    import torch

    if getattr(device, "type", str(device)) == "cuda":
        torch.cuda.synchronize()


def free(device) -> None:
    """Collect the program's dropped state and give its memory back."""
    import torch

    gc.collect()
    if getattr(device, "type", str(device)) == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def peak_bytes(device) -> int:
    import torch

    if getattr(device, "type", str(device)) != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated())


class Reservoir:
    """``k`` items drawn uniformly from a stream, seeded (reservoir
    sampling): the windows whose frames are compared after the run."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(np.random.SeedSequence(
            [int(seed), 7]))
        self.items: Dict[int, object] = {}
        self.seen = 0

    def offer(self, key: int, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items[key] = item
            return
        j = int(self.rng.integers(self.seen))
        if j < self.k:
            del self.items[sorted(self.items)[j]]
            self.items[key] = item


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def frame_gaps(program: np.ndarray, reference) -> Tuple[float, float]:
    """The largest absolute and the RMS difference of two frame stacks."""
    ref = reference.detach().cpu().numpy().astype(np.float64)
    d = program.astype(np.float64) - ref
    return float(np.abs(d).max()), float(np.sqrt(np.mean(d * d)))


def leaf_gap(program: Dict[str, object], reference: Dict[str, object],
             keep) -> Tuple[float, str]:
    """The worst leaf's gap between the program's and the reference's
    norms, |a - b| / max(b, the median leaf's b), over the leaves
    ``keep``; (gap, leaf)."""
    ref = {k: float(reference[k].double().norm()) for k in keep}
    med = float(np.median(list(ref.values())))
    worst = (0.0, "")
    for k in keep:
        p = float(program[k].double().norm())
        gap = abs(p - ref[k]) / max(ref[k], med, 1e-30)
        worst = max(worst, (gap, k))
    return worst


def correct(checks) -> bool:
    return bool(checks) and all(
        math.isfinite(v) and v <= lim for _, v, lim in checks)


def kernel_s(sliced: dict, *names: str) -> float:
    """Device seconds in the slice of the kernels whose name holds one of
    ``names``."""
    return sum(s for k, s in sliced["kernels"].items()
               if any(n in k for n in names))


def runtime_s(sliced: dict, name: str) -> float:
    """Host seconds in the slice in CUDA runtime calls named ``name``
    (any version suffix)."""
    return sum(s for k, s in sliced["runtime"].items()
               if k == name or k.startswith(name + "_"))


def roofline(sliced: dict, work_of, card: str, *kernels: str):
    """100 x the roofline bound of the work ``work_of(unit)`` of the slice's
    units over the device time of ``kernels``; None where the slice ran
    none of them or its units hold no such work."""
    from benchmark.roofline.peaks import bound_s

    spent = kernel_s(sliced, *kernels)
    works = [work_of(u) for u in sliced["shapes"]]
    flops = sum(w["flops"] for w in works)
    nbytes = sum(w["bytes"] for w in works)
    if spent <= 0 or flops + nbytes <= 0:
        return None
    return 100.0 * bound_s(flops, nbytes, card) / spent


def mfu(outcome: Outcome, card: str):
    """100 x the window's FLOPs (``roofline/model.py``, from its units'
    shapes) per second over the card's TF32 peak."""
    from benchmark.roofline import model
    from benchmark.roofline.peaks import peak

    w = outcome.window
    flops = sum(n * model.flops(u) for u, n in w["shapes"])
    return 100.0 * flops / w["seconds"] / peak(card)["flops"]


def tally(units) -> list:
    """[[unit, times it occurs], ...] of a sequence of units, in their
    first order."""
    out = []
    for u in units:
        for pair in out:
            if pair[0] == u:
                pair[1] += 1
                break
        else:
            out.append([u, 1])
    return out
