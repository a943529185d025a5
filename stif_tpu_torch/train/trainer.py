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
- ``optax.scale_by_adam`` (eps 1e-8, no eps_root): ``torch.optim.Adam``
  with no weight decay;
- ``optax.scale_by_schedule``: the lr is the schedule at the update count
  *before* the step, so under warmup the first update has lr 0.

The logged ``grad_norm`` is the global norm before clipping.

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
    update count. ``step(count)`` returns the pre-clip global norm."""

    def __init__(self, params, cfg: TrainConfig):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = warmup_wrap(
            cosine_annealing_restart(cfg.lr, cfg.T_period, cfg.restarts,
                                     cfg.restart_weights, cfg.eta_min),
            cfg.warmup_iter, cfg.lr)
        self.grad_clip = float(cfg.grad_clip or 0.0)
        self.adam = torch.optim.Adam(self.params, lr=0.0,
                                     betas=(cfg.beta1, cfg.beta2), eps=1e-8,
                                     weight_decay=0.0)

    def step(self, count: int) -> torch.Tensor:
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = global_norm(grads)
        if self.grad_clip > 0:
            # (g / norm) * max_norm where norm >= max_norm, else g / 1 * 1;
            # the decision stays on the device: no host sync
            clip = norm >= self.grad_clip
            one = torch.ones_like(norm)
            torch._foreach_div_(grads, torch.where(clip, norm, one))
            torch._foreach_mul_(grads, torch.where(clip, self.grad_clip,
                                                   one))
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(int(count))
        self.adam.step()
        return norm

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return self.adam.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state)


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


def make_train_step(model: torch.nn.Module, optimizer: Optimizer,
                    cfg: TrainConfig) -> Callable:
    """``train_step(batch, count, mark=None) -> {'loss', 'grad_norm'}``
    (0-dim tensors): forward, backward and the optimizer's update at update
    count ``count``. ``mark``, when given, is called with 'forward',
    'backward' and 'update' after each phase (a seam for timing)."""
    loss_fn = make_loss_fn(model, cfg)

    def train_step(batch, count: int,
                   mark: Optional[Callable[[str], None]] = None
                   ) -> Dict[str, torch.Tensor]:
        mark = mark or (lambda _: None)
        optimizer.zero_grad()
        loss = loss_fn(batch)
        mark("forward")
        loss.backward()
        mark("backward")
        gnorm = optimizer.step(count)
        mark("update")
        return {"loss": loss.detach(), "grad_norm": gnorm.detach()}

    return train_step


def make_parallel_train_step(model: torch.nn.Module, optimizer: Optimizer,
                             cfg: TrainConfig, mesh,
                             per_sample_times: bool = False) -> Callable:
    """Data-parallel ``train_step(batch, count, mark=None)``: ``model``
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
    already."""
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
                   mark: Optional[Callable[[str], None]] = None
                   ) -> Dict[str, torch.Tensor]:
        mark = mark or (lambda _: None)
        optimizer.zero_grad()
        loss = loss_fn(check(batch))
        mark("forward")
        (loss * world if reduction == "sum" else loss).backward()
        mark("backward")
        gnorm = optimizer.step(count)
        mark("update")
        total = loss.detach().clone()
        dist.all_reduce(total)
        if reduction == "mean":
            total /= world
        return {"loss": total, "grad_norm": gnorm.detach()}

    train_step.ddp = ddp
    return train_step
