"""Entry: STIF's window decoded in chunks of queries, the path for frames
whose whole query set does not fit at once.

The program is ``InferencePipeline(model, scale, bucket)`` over the port's
``LunaTokis`` (``define_g``), compiled as it is by default on a card: each
window is one ``render_pairs(pair[None], times, chunk_size)`` call, whose
``gen_feat`` replays the pipeline's program of the bucket and whose
``ChunkedDecoder`` replays its own four passes' programs (prep, A+B per
chunk, the skip, C+D per chunk) from a sibling cache; the call returns the
frames in a host array. A closed loop of one client: the next window is
handed in when the last one's frames are back, over the pool cycled.

Set-up builds the model, its weights and the pool, then renders two windows
of the pool, which builds the kernels, the bucket's constants and every
program. The window measures for ``seconds``: each window's latency is its
call. After the window (and the traced slice, when asked for) the peak
memory is read and the program freed; then ``serve_stream.py``'s reference
renders the windows that a seeded reservoir kept, at the same padding, and
the frames are compared. A window's unit is of model ``stif``, so the
flagship's work functions read it. ``notes["programs"]`` holds the lines
of the pipeline's cache and of the decoder's.
"""

from __future__ import annotations

import time

from benchmark import harness, trace, weights
from benchmark.entries.serve_stream import reference, unit
from benchmark.traffic import generate


def run(r: harness.Run) -> harness.Outcome:
    from stif_tpu_torch.models.factory import define_g
    from stif_tpu_torch.runtime.pipeline import InferencePipeline

    harness.fp32()
    mix = r.traffic
    times = mix["times"]
    chunk = r.cell["chunk"]
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

    def render(window):
        return pipe.render_pairs(window[None], times, chunk_size=chunk)[0]

    for w in pool[:2]:
        render(w)
    harness.sync(r.device)

    keep = harness.Reservoir(r.cell["check"]["sample"], r.seed)
    latency = []
    t0 = t = time.perf_counter()
    at["warm_s"] = t0 - r.started
    while t - t0 < r.seconds:
        i = len(latency)
        frames = render(pool[i % len(pool)])
        began, t = t, time.perf_counter()
        latency.append(t - began)
        keep.offer(i, frames)
    window_s = t - t0
    done = len(latency)
    sliced = None
    if r.trace:
        n = r.cell["trace_units"]
        nxt = iter(range(done, done + n + 1))
        sliced = trace.traced(lambda: render(pool[next(nxt) % len(pool)]), n)
        sliced["shapes"] = [unit(r, pool[(done + 1 + k) % len(pool)])
                            for k in range(n)]
    harness.sync(r.device)
    peak = harness.peak_bytes(r.device)
    programs = []
    if pipe.programs is not None:
        programs += pipe.programs.stats()
        programs += pipe._chunked.stats()["programs"] or []
    del pipe, net
    harness.free(r.device)

    worst_abs = worst_rms = 0.0
    for i, frames in sorted(keep.items.items()):
        gap_abs, gap_rms = harness.frame_gaps(
            frames, reference(state, r, pool[i % len(pool)]))
        worst_abs, worst_rms = max(worst_abs, gap_abs), max(worst_rms, gap_rms)
    lim = r.cell["check"]["limits"]
    return harness.Outcome(
        attempted=done, failed=0,
        e2e={"frames_per_s": done * len(times) / window_s,
             "window_p90_ms": 1e3 * harness.percentile(latency, 90)},
        setup_end=t0,
        window={"seconds": window_s, "shapes": harness.tally(
            unit(r, pool[i % len(pool)]) for i in range(done))},
        memory_peak_bytes=peak,
        checks=[("max_abs_err", worst_abs, lim["max_abs_err"]),
                ("rms_err", worst_rms, lim["rms_err"])],
        slice=sliced,
        notes={"compared_windows": sorted(keep.items), "setup_at": at,
               "programs": programs})
