"""Entry: STIF served as a stream of LR pairs, the deployed use.

The program is ``InferencePipeline(model, scale, bucket)`` over the port's
``LunaTokis`` (``define_g``), compiled as it is by default on a card (one
CUDA graph per bucket), fed lazily through ``stream`` with ``stage(pair,
times)`` as ``render_sequence`` feeds it: a closed loop of one client that
hands the next pair in as soon as the stream asks for it. The pool of
pairs is cycled.

Set-up builds the model, its weights and the pool, then streams two
windows of the pool, which builds the kernels, the bucket's constants and
its graph. The window measures for ``seconds``: each window's latency runs
from its ``stage`` call to the frames in a host array of its own. After the
window (and the traced slice, when asked for) the stream is drained, the
peak memory read and the program freed; then the reference renders the
windows that a seeded reservoir kept, at the same padding, and the frames
are compared.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import harness, trace, weights
from benchmark.reference import stif as ref_stif
from benchmark.traffic import generate


def pad(window: np.ndarray, multiple: int) -> np.ndarray:
    """Zero-pad (N, H, W, 3) at the bottom and right to a multiple."""
    h, w = window.shape[1:3]
    hp, wp = -(-h // multiple) * multiple, -(-w // multiple) * multiple
    return np.pad(window, ((0, 0), (0, hp - h), (0, wp - w), (0, 0)))


def reference(state, r: harness.Run, window: np.ndarray):
    """The reference's frames of one window: (nt, H*s, W*s, 3)."""
    import torch

    mix = r.traffic
    s = mix["scale"]
    h, w = window.shape[1:3]
    x = torch.from_numpy(pad(window, max(4, r.cell["bucket"])))[None]
    x = x.to(r.device)
    out_size = (x.shape[2] * s, x.shape[3] * s)
    with torch.no_grad():
        out = ref_stif.forward(state, r.arch, x,
                               torch.tensor(mix["times"]), out_size,
                               block=r.cell["check"]["rows"])
    return out[:, 0, :h * s, :w * s]


def unit(r: harness.Run, window: np.ndarray) -> dict:
    """One window's shapes, as ``roofline/model.py`` reads a unit: the
    unpadded frames."""
    mix = r.traffic
    h, w = window.shape[1:3]
    s = mix["scale"]
    return {"model": "stif", "arch": r.arch, "batch": 1, "lr": [h, w],
            "nt": len(mix["times"]), "out": [h * s, w * s]}


def run(r: harness.Run) -> harness.Outcome:
    from stif_tpu_torch.models.factory import define_g
    from stif_tpu_torch.runtime.pipeline import InferencePipeline

    harness.fp32()
    mix = r.traffic
    times = mix["times"]
    net = define_g({"network_G": r.config["network_G"]})
    shapes = {k: v.shape for k, v in net.state_dict().items()}
    state = weights.make(r.config["weights"], shapes, r.seed, r.root,
                         r.device)
    net.load_state_dict(state)
    at = {"model_s": time.perf_counter() - r.started}
    pool = generate.windows(mix, r.seed, r.device)
    at["pool_s"] = time.perf_counter() - r.started
    pipe = InferencePipeline(net, scale=mix["scale"],
                             bucket=r.cell["bucket"], device=r.device)
    list(pipe.stream(pipe.stage(w, times) for w in pool[:2]))
    harness.sync(r.device)

    stop, staged_at = [False], []

    def staged():
        i = 0
        while not stop[0]:
            staged_at.append(time.perf_counter())
            yield pipe.stage(pool[i % len(pool)], times)
            i += 1

    keep = harness.Reservoir(r.cell["check"]["sample"], r.seed)
    latency = []
    stream = pipe.stream(staged())
    t0 = time.perf_counter()
    at["warm_s"] = t0 - r.started
    for frames in stream:
        t = time.perf_counter()
        i = len(latency)
        latency.append(t - staged_at[i])
        keep.offer(i, frames)
        if t - t0 >= r.seconds:
            break
    window_s = t - t0
    done = len(latency)
    sliced = None
    if r.trace:
        n = r.cell["trace_units"]
        sliced = trace.traced(lambda: next(stream), n)
        sliced["shapes"] = [unit(r, pool[(done + 1 + k) % len(pool)])
                            for k in range(n)]
    stop[0] = True
    for _ in stream:
        pass
    harness.sync(r.device)
    peak = harness.peak_bytes(r.device)
    programs = pipe.programs.stats() if pipe.programs is not None else None
    del pipe, net, stream
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
        e2e={"frames_per_s": n * len(times) / window_s,
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
