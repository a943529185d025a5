"""Entry: STIF fine-tuned on one card with the r5 recipe.

The program is the port's ``VideoSRModel(opt)``: ``feed_data`` then
``optimize_parameters`` (one captured CUDA graph per scale bucket: the
forward, the backward through the DCN kernels and the convs, the clip,
Adam and the EMA; the logs fetched to the host), started from the
configuration's weights at update count 0 with its ``train_batch_size``.
The EMA starts from a state that lags the weights, as a resumed run's
does (``weights.lagging``, the mix's ``ema_lag``), so that its updates
move it by more than rounding. The batches cycle the mix's scale plan in
order.

Set-up builds the model and one batch per plan entry, then runs one whole
cycle of the plan through the same object, which captures every bucket's
graph. Its first three steps are the ones the reference follows: after step
1 the optimizer's first moment is kept (the first gradient as Adam got it
is that over 1 - beta1), after step 3 the parameters and the EMA, before
step 4 writes over them. The window then steps the same object for
``seconds``. After it the peak memory is read and the program freed; the
reference runs the three steps from the same weights and EMA on the same
batches, and the losses and the norms of the first gradient, of the three
steps' change and of the EMA's change are compared, by the worst leaf.
"""

from __future__ import annotations

import math
import time

import numpy as np

from benchmark import harness, trace, weights
from benchmark.reference import train as ref_train
from benchmark.traffic import generate

FOLLOWED = 3  # the steps the reference follows


def step_unit(r: harness.Run, scale: int, lq: int) -> dict:
    """One step's shapes at bucket (scale, LQ size), as
    ``roofline/model.py`` reads a unit."""
    g = scale * lq
    return {"model": "stif", "arch": r.arch,
            "batch": r.config["train_batch_size"], "lr": [lq, lq],
            "nt": r.traffic["nt"], "out": [g, g], "train": True}


def _device_batch(batch: dict, device) -> dict:
    import torch

    return {"lqs": torch.from_numpy(batch["LQs"]).to(device),
            "gt": torch.from_numpy(batch["GT"]).to(device),
            "times": torch.from_numpy(batch["times"]).to(device)}


def reference(state, ema0, r: harness.Run, batches,
              half_batch: bool = False):
    """The reference's three steps from ``state`` and EMA ``ema0`` on
    ``batches``."""
    return ref_train.train_steps(
        state, r.arch, r.traffic["train"],
        [_device_batch(b, r.device) for b in batches[:FOLLOWED]],
        block=r.cell["check"]["block"], half_batch=half_batch, ema0=ema0)


def _moved(leaves: dict) -> list:
    """The leaves whose norm is at least a thousandth of the median
    leaf's."""
    norm = {k: float(v.double().norm()) for k, v in leaves.items()}
    med = float(np.median(list(norm.values())))
    return [k for k, v in norm.items() if v >= 1e-3 * med]


def readings(first_grad: dict, params: dict, ema: dict, losses, state,
             ema0, ref) -> list:
    """The compared numbers: the worst step's relative loss gap, and the
    worst leaf's gap of the norms of the first gradient, of the three
    steps' change of the parameters and of the EMA's change. The first two
    over the leaves whose first gradient in the reference is at least a
    thousandth of the median leaf's (a leaf the loss does not reach moves
    by rounding alone); the EMA's over the leaves whose change in the
    reference is."""
    keep = _moved(ref["grad"])
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["loss"]))
    grad_gap, _ = harness.leaf_gap(first_grad, ref["grad"], keep)

    def change(after, before, leaves):
        return {k: after[k].to(before[k].device) - before[k] for k in leaves}

    upd_gap, _ = harness.leaf_gap(change(params, state, keep),
                                  change(ref["params"], state, keep), keep)
    ref_e = change(ref["ema"], ema0, list(ema0))
    moved = _moved(ref_e)
    ema_gap, _ = harness.leaf_gap(change(ema, ema0, moved), ref_e, moved)
    return [("loss_gap", loss_gap), ("grad_gap", grad_gap),
            ("update_gap", upd_gap), ("ema_gap", ema_gap)]


def run(r: harness.Run) -> harness.Outcome:
    import torch
    from stif_tpu_torch.train.video_sr_model import VideoSRModel

    harness.fp32()
    mix = r.traffic
    B = r.config["train_batch_size"]
    vsr = VideoSRModel({"network_G": r.config["network_G"],
                        "train": mix["train"]}, device=r.device)
    vsr.init_params(None, None)
    shapes = {k: v.shape for k, v in vsr.net.state_dict().items()}
    state = weights.make(r.config["weights"], shapes, r.seed, r.root,
                         r.device)
    ema0 = weights.lagging(state, mix["ema_lag"], r.seed, r.device)
    with torch.no_grad():
        vsr.net.load_state_dict(state)
        vsr.ema.load(ema0)
    names = [k for k, p in vsr.net.named_parameters() if p.requires_grad]
    at = {"model_s": time.perf_counter() - r.started}
    pool = generate.train_batches(mix, B, r.seed, r.device)
    at["pool_s"] = time.perf_counter() - r.started
    b1 = float(mix["train"]["beta1"])
    losses, failed = [], 0
    first_grad = params = ema = None
    for j, batch in enumerate(pool):  # one cycle: every bucket captured
        vsr.feed_data(batch)
        log = vsr.optimize_parameters()
        if j < FOLLOWED:
            losses.append(log["loss"])
        if j == 0:
            first_grad = {k: (m / (1 - b1)).cpu()
                          for k, m in zip(names, vsr.optimizer.mu)}
        if j == FOLLOWED - 1:
            params = {k: p.detach().to("cpu", copy=True)
                      for k, p in vsr.net.named_parameters()}
            ema = {k: v.to("cpu", copy=True)
                   for k, v in vsr.ema.params.items()}
    harness.sync(r.device)

    steps = 0
    t0 = time.perf_counter()
    at["warm_s"] = t0 - r.started
    while True:
        vsr.feed_data(pool[steps % len(pool)])
        log = vsr.optimize_parameters()
        failed += not math.isfinite(log["loss"])
        steps += 1
        t = time.perf_counter()
        if t - t0 >= r.seconds:
            break
    window_s = t - t0
    units = [step_unit(r, s, lq) for s, lq in mix["scale_plan"]]
    sliced = None
    if r.trace:
        n = r.cell["trace_units"]
        nxt = iter(range(steps, steps + n + 1))  # a warm step, then n

        def one():
            vsr.feed_data(pool[next(nxt) % len(pool)])
            vsr.optimize_parameters()

        sliced = trace.traced(one, n)
        sliced["shapes"] = [units[j % len(units)]
                            for j in range(steps + 1, steps + n + 1)]
    harness.sync(r.device)
    peak = harness.peak_bytes(r.device)
    programs = vsr.programs.stats() if vsr.programs is not None else None
    del vsr
    harness.free(r.device)

    ref = reference(state, ema0, r, pool)
    lim = r.cell["check"]["limits"]
    checks = [(name, v, lim[name]) for name, v in readings(
        first_grad, params, ema, losses, state, ema0, ref)]
    return harness.Outcome(
        attempted=steps, failed=failed,
        e2e={"train_samples_per_s": steps * B / window_s},
        setup_end=t0,
        window={"seconds": window_s, "shapes": harness.tally(
            units[j % len(units)] for j in range(steps))},
        memory_peak_bytes=peak, checks=checks, slice=sliced,
        notes={"losses": losses, "reference_losses": ref["loss"],
               "setup_at": at, "programs": programs})
