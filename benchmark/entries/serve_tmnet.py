"""Entry: TMNet served one window at a time, its Adobe240 protocol.

The program is ``InferencePipeline(tmnet, bucket).render_window_tmnet``
over the port's ``TMNet`` (``define_g``), compiled as it is by default on a
card: each call uploads a window of LR frames and its query times, replays
the bucket's graph and copies the frames to the host. A closed loop of one
client; the pool of windows is cycled. Latency runs from the call to the
frames in a host array, which the call returns.

Set-up builds the model with weights drawn from the seed, the pool, and
renders two windows (the kernels, the constants, the graph). After the
window the peak memory is read and the program freed; the reference renders
the windows a seeded reservoir kept, at the same padding.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import harness, trace, weights
from benchmark.entries.serve_stream import pad
from benchmark.reference import tmnet as ref_tmnet
from benchmark.traffic import generate


def reference(state, r: harness.Run, window: np.ndarray):
    import torch

    h, w = window.shape[1:3]
    x = torch.from_numpy(pad(window, max(4, r.cell["bucket"])))[None]
    t = torch.tensor([r.traffic["times"]])
    with torch.no_grad():
        out = ref_tmnet.forward(state, r.arch, x.to(r.device),
                                t.to(r.device))
    return out[0, :, :h * 4, :w * 4]


def unit(r: harness.Run, window: np.ndarray) -> dict:
    """One window's shapes, as ``roofline/model.py`` reads a unit."""
    n, h, w = window.shape[:3]
    return {"model": "tmnet", "arch": r.arch, "batch": 1, "frames": n,
            "lr": [h, w], "t_n": len(r.traffic["times"])}


def run(r: harness.Run) -> harness.Outcome:
    from stif_tpu_torch.models.factory import define_g
    from stif_tpu_torch.runtime.pipeline import InferencePipeline

    harness.fp32()
    times = r.traffic["times"]
    net = define_g({"network_G": r.config["network_G"]})
    shapes = {k: v.shape for k, v in net.state_dict().items()}
    state = weights.make(r.config["weights"], shapes, r.seed, r.root,
                         r.device)
    net.load_state_dict(state)
    at = {"model_s": time.perf_counter() - r.started}
    pool = generate.windows(r.traffic, r.seed, r.device)
    at["pool_s"] = time.perf_counter() - r.started
    pipe = InferencePipeline(net, bucket=r.cell["bucket"], device=r.device)
    for w in pool[:2]:
        pipe.render_window_tmnet(w, times)
    harness.sync(r.device)

    keep = harness.Reservoir(r.cell["check"]["sample"], r.seed)
    latency = []
    frames_out = 0
    t0 = time.perf_counter()
    at["warm_s"] = t0 - r.started
    while True:
        i = len(latency)
        a = time.perf_counter()
        frames = pipe.render_window_tmnet(pool[i % len(pool)], times)
        t = time.perf_counter()
        latency.append(t - a)
        frames_out += frames.shape[0]
        keep.offer(i, frames)
        if t - t0 >= r.seconds:
            break
    window_s = t - t0
    done = len(latency)
    sliced = None
    if r.trace:
        n = r.cell["trace_units"]
        nxt = iter(range(done, done + n + 1))
        sliced = trace.traced(lambda: pipe.render_window_tmnet(
            pool[next(nxt) % len(pool)], times), n)
        sliced["shapes"] = [unit(r, pool[(done + 1 + k) % len(pool)])
                            for k in range(n)]
    harness.sync(r.device)
    peak = harness.peak_bytes(r.device)
    programs = pipe.programs.stats() if pipe.programs is not None else None
    del pipe, net
    harness.free(r.device)

    n = done
    worst_abs = worst_rms = 0.0
    for i, frames in sorted(keep.items.items()):
        gap_abs, gap_rms = harness.frame_gaps(
            frames, reference(state, r, pool[i % len(pool)]))
        worst_abs, worst_rms = max(worst_abs, gap_abs), max(worst_rms, gap_rms)
    lim = r.cell["check"]["limits"]
    return harness.Outcome(
        attempted=n, failed=0,
        e2e={"frames_per_s": frames_out / window_s,
             "window_p90_ms": 1e3 * harness.percentile(latency, 90)},
        setup_end=t0,
        window={"seconds": window_s, "shapes": harness.tally(
            unit(r, pool[i % len(pool)]) for i in range(n))},
        memory_peak_bytes=peak,
        checks=[("max_abs_err", worst_abs, lim["max_abs_err"]),
                ("rms_err", worst_rms, lim["rms_err"])],
        slice=sliced,
        notes={"compared_windows": sorted(keep.items), "setup_at": at,
               "programs": programs})
