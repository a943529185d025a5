"""The traced slice of a run: ``torch.profiler`` (CPU and CUDA) around a few
steady windows or steps, written as a Chrome trace under ``TMPDIR`` and
read back into the numbers the per-layer metrics take.

The arithmetic is that of the port's ``runtime/profile.py`` ``analyze``:
the device's busy time is the union of every kernel, copy and fill
interval; an idle gap is a hole in that union, named by the CUDA runtime
call that covers most of it on the host (a replayed graph's
``cudaGraphLaunch``, a ``cudaStreamSynchronize``), or ``host`` where the
host was in no runtime call. Kernels are summed by name, and runtime calls
by name (the host's time in ``cudaGraphLaunch``).
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Callable

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def analyze(events, t0_us: float, t1_us: float) -> dict:
    """The slice [t0_us, t1_us] (the profiler's clock) of Chrome-trace
    ``events``: ``wall_s``, ``busy_s``, ``kernels`` (seconds by name),
    ``runtime`` (host seconds by CUDA call), ``device_ops`` and
    ``idle_gaps`` (the ten largest, [name, seconds])."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and e["ts"] < t1_us and e["ts"] + e["dur"] > t0_us]
    rt = [e for e in xs if e.get("cat") in RUNTIME_CATS
          and t0_us <= e["ts"] <= t1_us]
    clip = [(max(e["ts"], t0_us), min(e["ts"] + e["dur"], t1_us))
            for e in dev]
    busy = _merge(clip)
    kernels, runtime = {}, {}
    for e, (a, b) in zip(dev, clip):
        kernels[e["name"]] = kernels.get(e["name"], 0.0) + (b - a) / 1e6
    for e in rt:
        runtime[e["name"]] = runtime.get(e["name"], 0.0) + e["dur"] / 1e6
    edges = [t0_us] + [t for iv in busy for t in iv] + [t1_us]
    gaps = sorted(((b - a, a, b) for a, b in zip(edges[::2], edges[1::2])
                   if b > a), reverse=True)
    named = {}
    for length, g0, g1 in gaps:
        cover = max(((min(e["ts"] + e["dur"], g1) - max(e["ts"], g0), e)
                     for e in rt if e["ts"] < g1 and e["ts"] + e["dur"] > g0),
                    key=lambda c: c[0], default=(0.0, None))
        name = cover[1]["name"] if cover[0] > length / 2 else "host"
        named[name] = named.get(name, 0.0) + length / 1e6
    return {
        "wall_s": (t1_us - t0_us) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "kernels": kernels,
        "runtime": runtime,
        "device_ops": [[n[:120], s] for n, s in sorted(
            kernels.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[n[:120], s] for n, s in sorted(
            named.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def traced(step: Callable[[], None], n: int) -> dict:
    """Run ``step`` ``n + 1`` times under the profiler and ``analyze`` the
    span of the last ``n``. The first, unmarked, brings every launch in
    flight under the profiler: work queued before it started is not
    traced. In a steady stream the work in flight at the span's two ends
    then balances, so the span holds ``n`` steps' work."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        with record_function("benchmark_slice"):
            for _ in range(n):
                step()
    fd, path = tempfile.mkstemp(prefix="slice_", suffix=".json",
                                dir=os.environ.get("TMPDIR"))
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text())["traceEvents"]
    finally:
        os.unlink(path)
    mark = next(e for e in events if e.get("ph") == "X"
                and e.get("name") == "benchmark_slice")
    return analyze(events, mark["ts"], mark["ts"] + mark["dur"])
