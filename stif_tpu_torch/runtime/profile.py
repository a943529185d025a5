"""Where a streamed b1 window's time goes (counterpart of
``tools/profile_bench.py``).

One ``torch.profiler`` capture of one window of the bench's b1 stream
(``runtime/bench.py``, through ``InferencePipeline.stream``): pairs 0 and 1
are launched and pair 0 fetched before the capture; inside it the range
``window`` is one step of the stream in its steady state, which launches
pair 2 and fetches pair 1; pair 2 is fetched after the range, so that its
device work has ended when the capture stops. The capture is written as a Chrome trace.
The window's ranges are the port's host spans (``utils/trace.py``:
staging, the static-input copy and the replay, the fetch), opened by the
pipeline itself, so a replayed window has them too.

``analyze`` reads the trace's events:

- device time of the window: every kernel, copy and fill whose launch lies
  in the ``window`` range, each attributed to the innermost host span
  open at its launch; their union is the device's busy time;
- the top device ops by time, with their counts;
- the idle gaps between the window's device intervals, longest first, with
  what the host was doing: the share of the gap inside any host op or
  runtime call, the CUDA API call that fills most of it (a replayed
  graph's ``cudaGraphLaunch``, say), the longest stretch in none
  (Python between ops) and the call that ends it, and the op that launched
  the work that ends the gap;
  and the idle time inside the window's device span by gap length;
- the host-blocking calls: ``cudaStreamSynchronize``,
  ``cudaDeviceSynchronize``, ``cudaEventSynchronize`` and the synchronous
  ``cudaMemcpy``, and how many ``cudaMemcpyAsync`` a stream sync follows
  (PyTorch's copy from pageable memory), with the host time they blocked.

The idle share is held against the wall time of an unprofiled window of the
same stream. On the CPU the trace has no device events: the device fields
are None and only the ranges' host time is read.

On a CUDA device the pipeline replays the bucket's captured graph
(``runtime/compiled.py``) unless ``compiled`` is False. Where the time goes
by model stage comes from the stage marks (``stages``: device ms per
window, from the program's table, or the eager one), which a replay runs
as kernels of its graph.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
from torch.profiler import ProfilerActivity, profile, record_function

from stif_tpu_torch.runtime import bench
from stif_tpu_torch.runtime.pipeline import InferencePipeline
from stif_tpu_torch.utils.trace import SPANS, stage_ms

WINDOW = "window"
LABELS = set(SPANS)  # the ranges device work is attributed to
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation") + LAUNCH_CATS
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize", "cudaMemcpy")
GAP_BINS = (("under_50us", 0, 50), ("50us_to_1ms", 50, 1000),
            ("1ms_and_over", 1000, float("inf")))
TRACE = bench.ROOT / "runs" / "profile_torch" / "window_trace.json"


def _end(e) -> float:
    return e["ts"] + e["dur"]


def _innermost(events, ts: float):
    best = None
    for e in events:
        if e["ts"] <= ts <= _end(e) and (best is None or e["dur"] < best["dur"]):
            best = e
    return best


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def analyze(events, wall_ms: Optional[float] = None, top: int = 12,
            n_gaps: int = 5) -> dict:
    """The window's breakdown from Chrome-trace ``events`` (see the module
    docstring). Times in ms; ``wall_ms`` is an unprofiled window's wall
    time, the base of ``idle_share``."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = next(e for e in xs
               if e.get("cat") == "user_annotation" and e["name"] == WINDOW)
    w0, w1 = win["ts"], _end(win)
    host = [e for e in xs if e.get("cat") in HOST_CATS
            and e["tid"] == win["tid"] and w0 <= e["ts"] <= w1]
    ranges = [e for e in host
              if e["cat"] == "user_annotation" and e["name"] in LABELS]
    launch = {e["args"]["correlation"]: e for e in host
              if e["cat"] in LAUNCH_CATS and "correlation" in e.get("args", {})}
    ops = [e for e in host if e["cat"] == "cpu_op"]
    dev = [(e, launch[e["args"]["correlation"]]) for e in xs
           if e.get("cat") in DEVICE_CATS
           and e.get("args", {}).get("correlation") in launch]

    by_range = {label: {"device_ms": 0.0, "launches": 0, "host_ms": 0.0}
                for label in sorted(LABELS)}
    for r in ranges:
        by_range[r["name"]]["host_ms"] += r["dur"] / 1e3
    unranged = {"device_ms": 0.0, "launches": 0}
    by_name = {}
    for e, l in dev:
        r = _innermost(ranges, l["ts"])
        row = by_range[r["name"]] if r is not None else unranged
        row["device_ms"] += e["dur"] / 1e3
        row["launches"] += 1
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3, n + 1)

    rt = sorted((e for e in host if e["cat"] in LAUNCH_CATS),
                key=lambda e: e["ts"])
    blocking = {name: 0 for name in BLOCKING}
    blocked_ms = 0.0
    copies_then_sync = 0
    for i, e in enumerate(rt):
        if e["name"] in blocking:
            blocking[e["name"]] += 1
            blocked_ms += e["dur"] / 1e3
        if (e["name"] == "cudaMemcpyAsync" and i + 1 < len(rt)
                and rt[i + 1]["name"] == "cudaStreamSynchronize"):
            copies_then_sync += 1

    rec = {
        "ranges": {k: {kk: round(v, 3) for kk, v in row.items()}
                   for k, row in by_range.items()},
        "outside_ranges": {k: round(v, 3) for k, v in unranged.items()},
        "blocking": {"calls": blocking,
                     "per_window": sum(blocking.values()),
                     "memcpy_async_then_sync": copies_then_sync,
                     "host_blocked_ms": round(blocked_ms, 3)},
        "top_ops": [{"name": name[:120], "ms": round(ms, 3), "count": n}
                    for name, (ms, n) in sorted(by_name.items(),
                                                key=lambda kv: -kv[1][0])[:top]],
        "device_busy_ms": None, "device_span_ms": None, "idle_share": None,
        "idle_by_gap": None, "gaps": [],
    }
    if not dev:
        return rec
    busy = _merge((e["ts"], _end(e)) for e, _ in dev)
    rec["device_busy_ms"] = round(sum(b - a for a, b in busy) / 1e3, 3)
    rec["device_span_ms"] = round((busy[-1][1] - busy[0][0]) / 1e3, 3)
    if wall_ms:
        rec["idle_share"] = round(1 - rec["device_busy_ms"] / wall_ms, 4)
    starts = sorted(((e["ts"], e, l) for e, l in dev), key=lambda t: t[0])
    gaps = sorted(((b[0] - a[1], a[1], b[0])
                   for a, b in zip(busy, busy[1:])), reverse=True)
    # idle time by gap length: launch-bound dispatch leaves many short gaps,
    # a host stall (numpy work, a sync) a few long ones
    rec["idle_by_gap"] = {
        label: {"ms": round(sum(g[0] for g in gaps if lo <= g[0] < hi) / 1e3,
                            3),
                "gaps": sum(1 for g in gaps if lo <= g[0] < hi)}
        for label, lo, hi in GAP_BINS}
    gaps = gaps[:n_gaps]
    calls = [e for e in host if e["cat"] != "user_annotation"]
    for length, g0, g1 in gaps:
        _, nxt, l = next(s for s in starts if s[0] >= g1)
        inside = _innermost(ranges, g0)
        covered = _merge((max(e["ts"], g0), min(_end(e), g1)) for e in calls
                         if e["ts"] < g1 and _end(e) > g0)
        # the stretches of the gap in no host call: Python between ops
        edges = [g0] + [t for iv in covered for t in iv] + [g1]
        py0, py1 = max(zip(edges[::2], edges[1::2]),
                       key=lambda iv: iv[1] - iv[0])
        after = min((e for e in calls if e["ts"] >= py1),
                    key=lambda e: e["ts"], default=None)
        by = _innermost(ops, l["ts"])
        cuda_call = max(
            (e for e in calls if e["cat"] in LAUNCH_CATS
             and e["ts"] < g1 and _end(e) > g0),
            key=lambda e: min(_end(e), g1) - max(e["ts"], g0), default=None)
        rec["gaps"].append({
            "ms": round(length / 1e3, 3),
            "at_ms": round((g0 - w0) / 1e3, 3),
            "range": inside["name"] if inside else None,
            "host_op_share": round(sum(b - a for a, b in covered) / length, 3),
            "longest_cuda_call": cuda_call["name"][:80] if cuda_call else None,
            "longest_python_ms": round((py1 - py0) / 1e3, 3),
            "call_after_python": after["name"][:80] if after else None,
            "next": nxt["name"][:80],
            "launched_by": by["name"][:80] if by else None})
    return rec


def capture(model, pairs, times, trace=TRACE, compiled=None):
    """Capture one streamed window (see the module docstring; ``compiled``
    as ``InferencePipeline`` takes it). Returns the Chrome trace's events
    (the trace is written to ``trace``) and the device ms per window of
    each marked stage over the profiled stream's three windows."""
    device = next(model.parameters()).device
    pipe = InferencePipeline(bench.Quantized(model), scale=bench.SCALE,
                             bucket=1, device=device, compiled=compiled)
    staged = [pipe.stage(p, times) for p in pairs[:3]]
    list(pipe.stream(staged[:1]))  # warm: constants, and the capture
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    before = stage_ms(pipe.programs, device)
    frames = pipe.stream(staged)
    next(frames)  # launches pairs 0 and 1, fetches pair 0
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            next(frames)  # launches pair 2, fetches pair 1
        list(frames)  # fetches pair 2
    stages = {k: round((v - before.get(k, 0.0)) / len(staged), 3)
              for k, v in stage_ms(pipe.programs, device).items()}
    trace = Path(trace)
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    return json.loads(trace.read_text())["traceEvents"], stages


def run(device, knobs: bench.Knobs, weights=bench.WEIGHTS,
        lr_hw=(bench.LR_H, bench.LR_W), n_times: int = bench.N_TIMES,
        iters: int = bench.ITERS, seed: int = 0, arch=None,
        trace=TRACE, compiled=None) -> dict:
    """The profile line: the unprofiled b1 stream (wall per window), one
    captured window, ``analyze``d, and the stage marks' device ms per
    window (``stages``)."""
    arch = dict(bench.DEPLOYED, **(arch or {}))
    model = bench.build(device, weights, knobs, **arch)
    times = bench.times_for(n_times)
    pairs = bench.draw_pairs(np.random.default_rng(seed), max(3, iters),
                             lr_hw)[:, 0]
    b1 = bench.bench_b1(model, pairs, times, compiled=compiled)
    wall_ms = 1e3 * b1["window_s"]
    events, stages = capture(model, pairs, times, trace, compiled)
    window = analyze(events, wall_ms if device.type == "cuda" else None)
    return {
        "tool": "profile_bench_torch",
        "device": bench.device_info(device),
        "card": bench.card_line() if device.type == "cuda" else None,
        "lr_hw": list(lr_hw), "n_times": n_times, "arch": arch,
        "weights": str(weights) if weights else "seeded (nn/init.py, seed 0)",
        "gather_dtype": knobs.gather_dtype, "mlp_dtype": knobs.mlp_dtype,
        "encode_splitk": knobs.encode_splitk,
        "compiled": b1["programs"] is not None,
        "programs": b1["programs"],
        "b1_fps": round(b1["fps"], 3),
        "wall_ms": round(wall_ms, 3),
        "stages": stages,
        **window,
        "trace": str(trace),
    }
