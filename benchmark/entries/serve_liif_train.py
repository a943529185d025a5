"""Entry: STIF's arbitrary-scale architecture (``LIIF_train``, the port's
``LunaTokisTrain``) served as a stream of LR pairs, as ``serve_stream.py``
serves the flagship.

The program is ``InferencePipeline(model, scale, bucket)`` over
``define_g``'s ``LIIF_train``, compiled as it is by default on a card (one
CUDA graph per bucket), fed lazily through ``stream`` with ``stage(pair,
times)``: a closed loop of one client that hands the next pair in as soon
as the stream asks for it, over the pool cycled.

The weights (``weights_of``): the encoder from the configuration's
``encoder_file`` (the flagship's trained ``.pth``, every ``encoder.`` key
found under the flagship's name); the three nets drawn from the seed by
``weights.draw`` with the configuration's ``draw`` spec, independent of the
program's initialiser, and the flow head's four output biases (two flows,
(x, y) each, in HR pixels) then set uniform in +-``flow_px`` from the seed,
so that stage C samples a few pixels off the lattice. Set-up, the window,
the traced slice and the comparison are ``serve_stream.py``'s; the reference is
``reference/liif_train.py``, and a window's unit is of model
``liif_train`` (``roofline/liif_train.py``).
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import harness, trace, weights
from benchmark.entries.serve_stream import pad
from benchmark.reference import liif_train as ref_liif_train
from benchmark.traffic import generate


def weights_of(r: harness.Run):
    """(the model, its state dict on the device): see the module
    docstring."""
    import torch

    from stif_tpu_torch.models.factory import define_g

    net = define_g({"network_G": r.config["network_G"]})
    spec = r.config["weights"]
    shapes = {k: v.shape for k, v in net.state_dict().items()}
    nets = {k: s for k, s in shapes.items() if not k.startswith("encoder.")}
    state = weights.draw(nets, spec["draw"], r.seed, r.device)
    head = [k for k in nets if k.startswith("flow_imnet.")
            and k.endswith(".bias")][-1]
    gen = torch.Generator(device=r.device).manual_seed(int(r.seed) ^ 0xF10)
    state[head] = (torch.rand(nets[head], generator=gen, device=r.device)
                   * 2 - 1) * float(spec["flow_px"])
    trained = weights.load_file(r.root / spec["encoder_file"], r.device)
    for k in shapes:
        if k.startswith("encoder."):
            state[k] = trained[k[len("encoder."):]]
    return net, state


def reference(state, r: harness.Run, window: np.ndarray, tf32=False):
    """The reference's frames of one window: (nt, H*s, W*s, 3)."""
    import torch

    mix = r.traffic
    s = mix["scale"]
    h, w = window.shape[1:3]
    x = torch.from_numpy(pad(window, max(4, r.cell["bucket"])))[None]
    x = x.to(r.device)
    with torch.no_grad():
        out = ref_liif_train.forward(
            state, r.arch, x, torch.tensor(mix["times"]),
            (x.shape[2] * s, x.shape[3] * s), block=r.cell["check"]["rows"],
            tf32=tf32)
    return out[:, 0, :h * s, :w * s]


def unit(r: harness.Run, window: np.ndarray) -> dict:
    """One window's shapes (``roofline/liif_train.py``): the unpadded
    frames."""
    h, w = window.shape[1:3]
    s = r.traffic["scale"]
    return {"model": "liif_train", "arch": r.arch, "batch": 1, "lr": [h, w],
            "nt": len(r.traffic["times"]), "out": [h * s, w * s]}


def run(r: harness.Run) -> harness.Outcome:
    from stif_tpu_torch.runtime.pipeline import InferencePipeline

    harness.fp32()
    mix = r.traffic
    times = mix["times"]
    net, state = weights_of(r)
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
