"""Training runtime: the optimizer and the train step (port of
``stif_tpu/train/trainer.py``).

The reference's ``VideoSRBaseModel``: Adam over all trainable parameters
(betas (0.9, 0.99) per ``train_zsm.yml:56-59``), the pixel loss summed over
the predicted time steps (``optimize_parameters``, ``:123-131``), a cosine
restart schedule. The JAX package writes the optimizer as an optax chain;
``Optimizer`` here computes the same update:

- ``optax.clip_by_global_norm`` (only when ``grad_clip`` > 0): gradients are
  scaled by ``max_norm / norm`` when ``norm >= max_norm``, as
  ``(g / norm) * max_norm``; no epsilon;
- ``optax.scale_by_adam`` (eps 1e-8, no eps_root): the moments
  ``b * m + (1 - b) * g``, bias-corrected by the update count on the
  device, ``m_hat / (sqrt(v_hat) + eps)``; no weight decay;
- ``optax.scale_by_schedule``: the lr is the schedule at the update count
  *before* the step, so under warmup the first update has lr 0.

The logged ``grad_norm`` is the global norm before clipping.

The update is written with ``torch._foreach_*`` ops on tensors at fixed
addresses: the lr in a 0-dim tensor filled on the host before each update,
the update count on the device, the moments and the gradients allocated
once (``zero_grad`` zeroes them in place, and the backward accumulates into
them). So the same code runs eagerly on any device and inside a captured
CUDA graph (``make_train_step(programs=)``), where each replay reads the lr
and writes the parameters, moments and count where the capture found them.

Both steps mark their phases on the device (``utils/trace.py``):
``train.forward`` (zero-grad and the loss), ``train.backward``,
``train.update`` (the clip and Adam) and ``train.ema``; a replayed step's
marks are kernels of its graph.

``make_parallel_train_step`` is the data-parallel step (the JAX package's
mesh-sharded one): DDP over one process per device, each rank on its rows
of the global batch, with the loss scaled so that the gradient is the
global batch's, as the JAX step's is.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from stif_tpu_torch.train.losses import make_pixel_criterion
from stif_tpu_torch.train.schedules import (cosine_annealing_restart,
                                            warmup_wrap)
from stif_tpu_torch.utils import trace


@dataclasses.dataclass
class TrainConfig:
    """Defaults mirror ``train_zsm.yml``."""

    lr: float = 2e-5
    beta1: float = 0.9
    beta2: float = 0.99
    niter: int = 600_000
    warmup_iter: int = -1
    T_period: tuple = (150_000, 150_000, 150_000, 150_000)
    restarts: tuple = (150_000, 300_000, 450_000)
    restart_weights: tuple = (1.0, 1.0, 1.0)
    eta_min: float = 1e-7
    pixel_criterion: str = "cb"
    pixel_weight: float = 1.0
    # global-norm gradient clipping (0 = off). The unnormalized summed
    # Charbonnier loss (~5e4) yields grad norms ~1e6 in healthy training;
    # clip bounds the step a single bad batch can take.
    grad_clip: float = 0.0


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (``optax.global_norm``,
    up to the order of the fp32 sums); a 0-dim tensor on the gradients'
    device, made by a few fused launches."""
    return torch.stack(torch._foreach_norm(grads)).square().sum().sqrt()


class Optimizer:
    """Global-norm clip, Adam and the closed-form schedule, stepped by the
    update count (see the module docstring). ``step(count)`` fills the lr
    for update ``count`` and runs ``update``; both return the pre-clip
    global norm."""

    def __init__(self, params, cfg: TrainConfig):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = warmup_wrap(
            cosine_annealing_restart(cfg.lr, cfg.T_period, cfg.restarts,
                                     cfg.restart_weights, cfg.eta_min),
            cfg.warmup_iter, cfg.lr)
        self.grad_clip = float(cfg.grad_clip or 0.0)
        self.betas = (float(cfg.beta1), float(cfg.beta2))
        self.eps = 1e-8
        dev = self.params[0].device
        self.lr = torch.zeros((), device=dev)
        self.count = torch.zeros((), device=dev)  # updates made
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)

    @property
    def grads(self):
        return [p.grad for p in self.params]

    def state(self) -> list:
        """Every tensor ``update`` and ``zero_grad`` write: a captured step
        writes to them by address."""
        return [self.count, *self.params, *self.grads, *self.mu, *self.nu]

    def set_lr(self, count: int) -> None:
        """The lr of update ``count``, into ``self.lr`` (no host sync)."""
        self.lr.fill_(self.schedule(int(count)))

    def step(self, count: int) -> torch.Tensor:
        self.set_lr(count)
        return self.update()

    @torch.no_grad()
    def update(self) -> torch.Tensor:
        """The clip, Adam and the step at ``self.lr``, all on the device."""
        grads = self.grads
        norm = global_norm(grads)
        if self.grad_clip > 0:
            # (g / norm) * max_norm where norm >= max_norm, else g / 1 * 1;
            # the decision stays on the device: no host sync
            clip = norm >= self.grad_clip
            one = torch.ones_like(norm)
            torch._foreach_div_(grads, torch.where(clip, norm, one))
            torch._foreach_mul_(grads, torch.where(clip, self.grad_clip,
                                                   one))
        b1, b2 = self.betas
        self.count.add_(1)
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        step = torch._foreach_div(self.mu, 1 - b1 ** self.count)
        denom = torch._foreach_div(self.nu, 1 - b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(step, denom)
        torch._foreach_mul_(step, -self.lr)
        torch._foreach_add_(self.params, step)
        return norm

    def zero_grad(self) -> None:
        """Zero every gradient in place (their addresses stay)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        torch._foreach_zero_(self.grads)

    def state_dict(self) -> dict:
        """``torch.optim.Adam``'s layout, which the port's checkpoints
        hold: per parameter index its ``step``, ``exp_avg`` and
        ``exp_avg_sq``. Reads the count from the device."""
        step = self.count.cpu()
        return {
            "state": {i: {"step": step.clone(), "exp_avg": m.clone(),
                          "exp_avg_sq": v.clone()}
                      for i, (m, v) in enumerate(zip(self.mu, self.nu))},
            "param_groups": [{
                "lr": float(self.lr), "betas": self.betas, "eps": self.eps,
                "weight_decay": 0.0, "amsgrad": False, "maximize": False,
                "foreach": None, "capturable": False,
                "differentiable": False, "fused": None,
                "params": list(range(len(self.params)))}]}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a ``state_dict`` (this one's, or ``torch.optim.Adam``'s,
        which holds no entry for a parameter that never had a gradient)
        into the optimizer's tensors in place."""
        entries = state["state"]
        for i, (m, v) in enumerate(zip(self.mu, self.nu)):
            e = entries.get(i)
            m.copy_(e["exp_avg"]) if e else m.zero_()
            v.copy_(e["exp_avg_sq"]) if e else v.zero_()
        steps = {float(e["step"]) for e in entries.values()}
        if len(steps) > 1:
            raise ValueError(f"parameters at different update counts: "
                             f"{sorted(steps)}")
        self.count.fill_(steps.pop() if steps else 0.0)


def make_optimizer(params, cfg: TrainConfig):
    """``(optimizer, schedule)``, as the JAX package's ``(tx, schedule)``."""
    opt = Optimizer(params, cfg)
    return opt, opt.schedule


def make_loss_fn(model: torch.nn.Module, cfg: TrainConfig) -> Callable:
    """``loss_fn(batch) -> scalar``: the pixel loss summed over the time
    indices, like ``optimize_parameters`` (:123-129). ``batch``: tensors
    ``lqs`` (B, N, H, W, 3), ``gt`` (B, nt, HH, WW, 3) and ``times``, (nt,)
    shared or (B, nt) per sample (``gt[b, t]`` is the frame at
    ``times[b, t]``)."""
    criterion = make_pixel_criterion(cfg.pixel_criterion)

    def loss_fn(batch) -> torch.Tensor:
        gt = batch["gt"]
        nt, HH, WW = gt.shape[1], gt.shape[2], gt.shape[3]
        preds = model(batch["lqs"], batch["times"], out_size=(HH, WW))
        l_pix = 0.0
        for t in range(nt):
            l_pix = l_pix + cfg.pixel_weight * criterion(preds[t], gt[:, t])
        return l_pix

    return loss_fn


class EMA:
    """An exponential moving average of ``model``'s state dict (parameters
    and buffers), ``d * e + (1 - d) * p`` at each ``update``, in tensors
    allocated once: ``load`` copies into them in place, so a captured step
    that updates them keeps writing where they are."""

    def __init__(self, model: torch.nn.Module, decay: float):
        self.model = model
        self.decay = float(decay)
        self.params = {k: v.detach().clone()
                       for k, v in model.state_dict().items()}

    def state(self) -> list:
        return list(self.params.values())

    @torch.no_grad()
    def update(self) -> None:
        d = self.decay
        ema = self.state()
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, list(self.model.state_dict().values()),
                            alpha=1.0 - d)

    @torch.no_grad()
    def load(self, params: dict) -> None:
        """Copy ``params`` (a state dict of the model's schema) in."""
        if params.keys() != self.params.keys():
            raise KeyError("the EMA's keys differ from the state dict's: "
                           f"{sorted(params.keys() ^ self.params.keys())}")
        for k, v in self.params.items():
            v.copy_(params[k])


def make_train_step(model: torch.nn.Module, optimizer: Optimizer,
                    cfg: TrainConfig, programs=None,
                    ema: Optional[EMA] = None) -> Callable:
    """``train_step(batch, count, tally=None) -> {'loss', 'grad_norm'}``
    (0-dim tensors): zero-grad, forward, backward, the optimizer's update
    at update count ``count`` and then ``ema``'s update, if given, each
    phase marked (see the module docstring). ``tally``: the step's host
    spans (``trace.Tally``), bound to its program's table, or the eager
    one.

    With ``programs`` (a ``runtime.compiled.ProgramCache``) the step is one
    program per bucket (the shapes of ``lqs``, ``gt`` and ``times``): the
    bucket's first step runs it eagerly once, captures it and replays it,
    and every later step copies the batch into the program's static inputs
    and replays it, the state it updates left where the capture found it
    (``Optimizer.state``, ``EMA.state``: their addresses are in the key).
    The outputs are the program's: read them before the next step."""
    loss_fn = make_loss_fn(model, cfg)

    def body(lqs, gt, times):
        dev = lqs.device
        with trace.mark("train.forward", dev):
            optimizer.zero_grad()
            loss = loss_fn({"lqs": lqs, "gt": gt, "times": times})
        with trace.mark("train.backward", dev):
            loss.backward()
        with trace.mark("train.update", dev):
            gnorm = optimizer.update()
        if ema is not None:
            with trace.mark("train.ema", dev):
                ema.update()
        return loss.detach(), gnorm

    def train_step(batch, count: int,
                   tally: Optional[trace.Tally] = None
                   ) -> Dict[str, torch.Tensor]:
        optimizer.set_lr(count)
        args = (batch["lqs"], batch["gt"], batch["times"])
        if programs is None:
            if tally is not None:
                tally.bind(trace.EAGER_SPANS)
            loss, gnorm = body(*args)
        else:
            state = optimizer.state() + ([] if ema is None else ema.state())
            loss, gnorm = programs.run("train_step", body, args, model,
                                       state=state, tally=tally)
        return {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_parallel_train_step(model: torch.nn.Module, optimizer: Optimizer,
                             cfg: TrainConfig, mesh,
                             per_sample_times: bool = False,
                             ema: Optional[EMA] = None) -> Callable:
    """Data-parallel ``train_step(batch, count, tally=None)``, op by op (no
    CUDA graph yet: ``ROADMAP.md`` Queue 1 item 23): ``model``
    wrapped in ``DistributedDataParallel``, one process per device of the
    mesh's ``data`` axis (NCCL on the card, gloo on the CPU; the process
    group must exist). Each rank is handed its own ``B / world`` rows of
    the global batch (a per-rank loader; ``B % world == 0``, as the JAX
    sharding requires). Per-sample times (B, nt) come with those rows;
    shared times (nt,) are the same on every rank.

    JAX shards one global step: its gradient is that of the loss over the
    whole batch, and DDP averages over ranks. A sum-reduced criterion
    ('cb') is therefore scaled by the world size before ``backward``; a
    mean-reduced one ('l1', 'l2', 'lp', equal rows per rank) is not. The
    logged ``loss`` is the global one (the ranks' sum, or their mean);
    ``grad_norm`` and the clip follow DDP's all-reduce, so they are global
    already. ``ema`` is updated after the optimizer, on every rank. The
    phases are marked as the one-card step's are."""
    from torch.nn.parallel import DistributedDataParallel

    if not dist.is_initialized():
        raise RuntimeError("make_parallel_train_step needs a process group")
    world = dist.get_world_size()
    if mesh.shape.get("data", 1) != world or mesh.size != world:
        raise ValueError(f"mesh {mesh.shape} over a process group of {world}")
    dev = next(model.parameters()).device
    ddp = DistributedDataParallel(
        model, device_ids=[dev] if dev.type == "cuda" else None,
        static_graph=True)
    reduction = make_pixel_criterion(cfg.pixel_criterion).reduction
    loss_fn = make_loss_fn(ddp, cfg)

    def check(batch):
        times = batch["times"]
        if times.dim() != (2 if per_sample_times else 1):
            raise ValueError(f"times of shape {tuple(times.shape)} with "
                             f"per_sample_times={per_sample_times}")
        return batch

    def train_step(batch, count: int,
                   tally: Optional[trace.Tally] = None
                   ) -> Dict[str, torch.Tensor]:
        if tally is not None:
            tally.bind(trace.EAGER_SPANS)
        with trace.mark("train.forward", dev):
            optimizer.zero_grad()
            loss = loss_fn(check(batch))
        with trace.mark("train.backward", dev):
            (loss * world if reduction == "sum" else loss).backward()
        with trace.mark("train.update", dev):
            gnorm = optimizer.step(count)
        if ema is not None:
            with trace.mark("train.ema", dev):
                ema.update()
        total = loss.detach().clone()
        dist.all_reduce(total)
        if reduction == "mean":
            total /= world
        return {"loss": total, "grad_norm": gnorm.detach()}

    train_step.ddp = ddp
    return train_step
