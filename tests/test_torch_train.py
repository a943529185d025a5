"""The port's training maths against ``stif_tpu.train`` on the CPU: the
schedules, the optimizer on identical gradients, one train step and three
steps of a small ``LunaTokis`` (nf 8, groups 2, 1 + 1 blocks, LR 8x8, GT
32x32, B 2, nt 2, ``rgb_skip`` bicubic, DCN offsets perturbed) and
per-sample times. Losses and op gradients: ``test_torch_grads.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from stif_tpu.models import LunaTokis as JLunaTokis
from stif_tpu.train import schedules as js
from stif_tpu.train import trainer as jt

from stif_tpu_torch.convert import jax_params_to_state_dict
from stif_tpu_torch.models import LunaTokis
from stif_tpu_torch.train import schedules, trainer
from torch_parity import load_into_port, random_params, t

SMALL = dict(nf=8, groups=2, front_RBs=1, back_RBs=1, rgb_skip=True,
             rgb_skip_bicubic=True)


# --------------------------------------------------------------- schedules

# name -> (schedule of a module, base lr, warmup steps)
SCHEDULES = {
    "cosine_restarts": (
        lambda m: m.cosine_annealing_restart(2e-5, [50, 50, 50, 50],
                                             [50, 100, 150], [1, 0.5, 0.25],
                                             1e-7), 2e-5, 0),
    "cosine_warmup": (
        lambda m: m.warmup_wrap(m.cosine_annealing_restart(
            1e-4, [60, 80, 70], [60, 140], [0.75, 0.55], 1e-7), 20, 1e-4),
        1e-4, 20),
    "multistep_restart": (
        lambda m: m.multistep_restart(1e-3, [10, 20, 110, 160], 0.5,
                                      [30, 100], [0.5, 0.25]), 1e-3, 0),
    "multistep_warmup": (
        lambda m: m.warmup_wrap(m.multistep_restart(1e-3, [40, 90]), 30,
                                1e-3), 1e-3, 30),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_every_step(name):
    """rtol 1e-5 at every step 0-200. The JAX package computes the closed
    forms in float32: at the end of a cosine period ``1 + cos`` cancels, and
    there its value carries an absolute error of about float32's epsilon
    times the base lr, which is also allowed (the port computes in
    float64)."""
    build, base, warmup = SCHEDULES[name]
    want, got = build(js), build(schedules)
    eps32 = float(np.finfo(np.float32).eps)
    for step in range(201):
        w, g = float(want(step)), got(step)
        if step == 0 and warmup:
            assert g == w == 0.0
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=eps32 * base,
                                   err_msg=f"step {step}")


# --------------------------------------------------------------- optimizer

@pytest.mark.parametrize("clip,warmup", [(0.0, -1), (3.0, -1), (0.0, 3),
                                         (3.0, 3)])
def test_optimizer_matches_optax(rng, clip, warmup):
    """Adam, the global-norm clip and the schedule on the same five
    gradients as the optax chain; some steps are clipped, some not."""
    cfg = dict(lr=1e-2, beta1=0.9, beta2=0.99, warmup_iter=warmup,
               T_period=(10,), restarts=(), restart_weights=(), eta_min=1e-4,
               grad_clip=clip)
    shapes = {"w": (4, 5), "b": (5,), "c": (3, 3, 2)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * (4.0 if i % 2 else 0.3))
              .astype(np.float32) for k, s in shapes.items()}
             for i in range(5)]

    tx, _ = jt.make_optimizer(jt.TrainConfig(**cfg))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    for g in grads:
        up, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                              state, jp)
        jp = optax.apply_updates(jp, up)

    params = {k: torch.nn.Parameter(t(v)) for k, v in p0.items()}
    opt, sched = trainer.make_optimizer(params.values(),
                                        trainer.TrainConfig(**cfg))
    norms = []
    for count, g in enumerate(grads):
        for k, p in params.items():
            p.grad = t(g[k])
        norms.append(opt.step(count).item())
    if warmup > 0:
        assert sched(0) == 0.0
    want_norms = [np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                              for v in g.values())) for g in grads]
    np.testing.assert_allclose(norms, want_norms, rtol=1e-6)  # pre-clip
    if clip:
        assert min(want_norms) < clip < max(want_norms)
    for k, p in params.items():
        want = np.asarray(jp[k])
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


# -------------------------------------------------------------- train step

CFG = dict(lr=1e-4, warmup_iter=-1, T_period=(100,), restarts=(),
           restart_weights=(), eta_min=1e-7)


@pytest.fixture(scope="module")
def reference():
    """Inputs, carried-over params, and the JAX package's loss, gradients
    and grad norm at them, then its losses over three train steps."""
    rng = np.random.default_rng(5)
    x = rng.random((2, 2, 8, 8, 3)).astype(np.float32)
    gt = rng.random((2, 2, 32, 32, 3)).astype(np.float32)
    times = np.asarray([[0.0, 0.5], [0.875, 0.25]], np.float32)  # (B, nt)
    model = JLunaTokis(**SMALL)
    params = random_params(model, x, times, method=model.full_init)
    cfg = jt.TrainConfig(**CFG)
    batch = {"lqs": jnp.asarray(x), "gt": jnp.asarray(gt),
             "times": jnp.asarray(times)}
    vg = jax.jit(jax.value_and_grad(jt.make_loss_fn(model, cfg)))
    loss, grads = vg(params, batch)
    tx, _ = jt.make_optimizer(cfg)
    state, p, step_losses = tx.init(params), params, []
    for _ in range(3):
        lv, g = vg(p, batch) if p is not params else (loss, grads)
        step_losses.append(float(lv))
        up, state = tx.update(g, state, p)
        p = optax.apply_updates(p, up)
    return dict(x=x, gt=gt, times=times, params=params, loss=float(loss),
                grads=jax_params_to_state_dict(jax.device_get(grads)),
                grad_norm=float(optax.global_norm(grads)),
                losses=step_losses)


def _port_step(ref, times=None):
    model = load_into_port(LunaTokis(fused=False, **SMALL), ref["params"])
    model.train()
    cfg = trainer.TrainConfig(**CFG)
    opt, _ = trainer.make_optimizer(model.parameters(), cfg)
    step = trainer.make_train_step(model, opt, cfg)
    batch = {"lqs": t(ref["x"]), "gt": t(ref["gt"]),
             "times": t(ref["times"] if times is None else times)}
    return model, step, batch


def test_train_step_matches_jax(reference):
    """Loss rtol 1e-5, pre-clip grad norm rtol 1e-4, every parameter's
    gradient within 1e-4 of its largest entry. The legacy pixel-shuffle
    head gets no gradient on either side."""
    from stif_tpu_torch.utils import trace

    model, step, batch = _port_step(reference)
    before = trace.eager_stats("cpu")["stages"]
    out = step(batch, 0)
    after = trace.eager_stats("cpu")["stages"]
    # the phases' marks, and no model stage (grad is on)
    assert {k for k in after if after[k] != before.get(k)} == {
        "train.forward", "train.backward", "train.update"}
    np.testing.assert_allclose(out["loss"].item(), reference["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(out["grad_norm"].item(),
                               reference["grad_norm"], rtol=1e-4)
    want = reference["grads"]
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        w = want[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), name


def test_three_steps_match_jax(reference):
    """The loss of three Adam steps within rtol 1e-3: Adam's first update
    turns gradients near zero into +-lr, so a last-bit difference in such a
    gradient moves that parameter by lr and the later losses drift by about
    that much."""
    _, step, batch = _port_step(reference)
    got = [step(batch, count)["loss"].item() for count in range(3)]
    np.testing.assert_allclose(got, reference["losses"], rtol=1e-3)


def test_per_sample_times_supervision(reference):
    """(B, nt) times: each sample's loss depends on its own times, so the
    loss differs from the one with every sample at row 0's times."""
    _, step, batch = _port_step(reference)
    per_sample = step(batch, 0)["loss"].item()
    _, step0, batch0 = _port_step(reference, reference["times"][0])
    row0 = step0(batch0, 0)["loss"].item()
    assert np.isfinite(per_sample)
    assert abs(per_sample - row0) > 1e-6
