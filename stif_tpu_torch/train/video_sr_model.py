"""High-level training facade (port of
``stif_tpu/train/video_sr_model.py``).

The reference's ``VideoSRBaseModel`` / ``BaseModel``
(``codes/models/VideoSR_base_model.py``, ``codes/models/base_model.py``) and
its ``create_model(opt)`` factory: feed_data / optimize_parameters / test /
get_current_log / save / load / resume_training, driven by the same YAML
option schema.

The net comes from ``define_g`` with every SIREN on its plain PyTorch form
(``fused=False``): the fused kernel has no backward. ``test`` runs the
kernel, under ``inference_mode``. An exponential moving average of the
parameters (``train.ema_decay``, 0 = off), ``d * e + (1 - d) * p`` after
every step, is kept outside the optimizer checkpoint and saved beside it as
``ema_params_<step>.pth``, two deep.

With ``parallel`` the model trains data-parallel (DDP, one process per
device; see ``trainer.make_parallel_train_step``): each rank is fed its own
rows of the global batch (``feed_data``), the EMA updates on every rank
from the same parameters, and checkpoints and the EMA snapshots are written
by rank 0 behind a barrier. State-dict keys carry no ``module.`` prefix, so
a checkpoint loads into a model of either kind.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from stif_tpu_torch.models.factory import define_g
from stif_tpu_torch.nn.init import init_model_
from stif_tpu_torch.nn.siren import set_fused
from stif_tpu_torch.parallel.distributed import (barrier, join_process_group,
                                                 rank_and_world)
from stif_tpu_torch.runtime.pipeline import resolve_device
from stif_tpu_torch.train.checkpoints import CheckpointManager, load_params
from stif_tpu_torch.train.trainer import (TrainConfig, make_optimizer,
                                          make_parallel_train_step,
                                          make_train_step)


def create_model(opt: dict, device=None):
    """Reference model factory: the only registered model is
    'VideoSR_base'."""
    which = opt.get("model", "VideoSR_base")
    if which != "VideoSR_base":
        raise NotImplementedError(f"Model [{which}] not recognized.")
    return VideoSRModel(opt, device=device)


def train_config(opt: dict) -> TrainConfig:
    """``TrainConfig`` from the ``train`` section of an options dict."""
    tr = opt.get("train") or {}
    return TrainConfig(
        lr=float(tr.get("lr_G", 2e-5)),
        beta1=float(tr.get("beta1", 0.9)),
        beta2=float(tr.get("beta2", 0.99)),
        niter=int(tr.get("niter", 600_000)),
        warmup_iter=int(tr.get("warmup_iter", -1) or -1),
        T_period=tuple(tr.get("T_period", (150_000,) * 4)),
        restarts=tuple(tr.get("restarts", (150_000, 300_000, 450_000))),
        restart_weights=tuple(tr.get("restart_weights", (1.0,) * 3)),
        eta_min=float(tr.get("eta_min", 1e-7)),
        pixel_criterion=tr.get("pixel_criterion", "cb"),
        pixel_weight=float(tr.get("pixel_weight", 1.0)),
        grad_clip=float(tr.get("grad_clip", 0.0) or 0.0),
    )


class VideoSRModel:
    """Runs on CUDA unless ``device`` says otherwise; raises without a GPU
    when CUDA is asked for or defaulted to. ``parallel``: data-parallel
    over the process group, joined from ``torch.distributed.run``'s
    environment when the process is in none (CUDA: this rank's
    ``cuda:LOCAL_RANK``)."""

    def __init__(self, opt: dict, device=None, parallel: bool = False):
        self.opt = opt
        self.device = resolve_device(device)
        self.parallel = parallel
        if parallel:
            self.device = join_process_group(self.device)
        self.rank, self.world = rank_and_world() if parallel else (0, 1)
        self.net = define_g(opt)
        set_fused(self.net, False)
        self.net.to(self.device).train()
        self.cfg = train_config(opt)
        self.ema_decay = float((opt.get("train") or {}).get("ema_decay", 0.0)
                               or 0.0)
        self.ema_params = None
        self.optimizer = None
        self._step_fn = None
        self.step = 0
        self.log = {}
        models_dir = (opt.get("path") or {}).get("models")
        self.ckpt = CheckpointManager(models_dir) if models_dir else None
        self._batch = None

    # ---------------------------------------------------------------- setup

    def init_params(self, example_lqs, example_times, seed: int = 0) -> dict:
        """Draw every parameter by the reference's training init from a
        generator seeded with ``seed`` and start the optimizer at step 0.
        The example batch is not read: a torch net's parameter shapes are
        fixed at construction (the JAX package inits from its shapes)."""
        init_model_(self.net, torch.Generator().manual_seed(int(seed)))
        self.optimizer, _ = make_optimizer(self.net.parameters(), self.cfg)
        if self.parallel:
            from stif_tpu_torch.parallel import default_mesh

            mesh = default_mesh(self.world, device_type=self.device.type)
            self._step_fn = make_parallel_train_step(
                self.net, self.optimizer, self.cfg, mesh,
                per_sample_times=np.ndim(example_times) == 2)
        else:
            self._step_fn = make_train_step(self.net, self.optimizer,
                                            self.cfg)
        self.step = 0
        if self.ema_decay > 0:
            self.ema_params = self._params_copy()
        return self.net.state_dict()

    def _params_copy(self) -> dict:
        return {k: v.detach().clone()
                for k, v in self.net.state_dict().items()}

    # ------------------------------------------------------------- training

    def feed_data(self, data: dict) -> None:
        """data: {'LQs': (B,N,h,w,3), 'GT': (B,nt,H,W,3), 'times': (nt,)
        shared or (B,nt) per sample}, NHWC (the reference's NCHW batches
        convert with ``from_torch_batch``); data-parallel, this rank's
        rows."""
        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)

        times = dev(data["times"])
        if times.dim() > 2:
            times = times.reshape(times.shape[0], -1)
        self._batch = {"lqs": dev(data["LQs"]), "gt": dev(data["GT"]),
                       "times": times}

    def optimize_parameters(self, step: Optional[int] = None,
                            mark=None) -> dict:
        """One train step on the fed batch at the model's own update count
        (``step`` is accepted for the reference's signature and not read).
        ``mark``: see ``make_train_step``."""
        if self._step_fn is None:
            raise RuntimeError("call init_params first")
        metrics = self._step_fn(self._batch, self.step, mark)
        self.step += 1
        if self.ema_params is not None:
            d = self.ema_decay
            with torch.no_grad():
                ema = list(self.ema_params.values())
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, list(self.net.state_dict().values()),
                                    alpha=1.0 - d)
        self.log = {k: float(v) for k, v in metrics.items()}
        return self.log

    def get_current_log(self) -> dict:
        return self.log

    # ------------------------------------------------------------ inference

    def test(self, test_mode: bool = False, out_size=None) -> torch.Tensor:
        """The net on the fed batch through the fused kernel, under
        ``inference_mode``: (nt, B, HH, WW, 3)."""
        b = self._batch
        set_fused(self.net, True)
        try:
            with torch.inference_mode():
                return self.net(b["lqs"], b["times"], out_size=out_size,
                                test=test_mode)
        finally:
            set_fused(self.net, False)

    # ----------------------------------------------------- checkpoint/resume

    def save(self) -> int:
        """Checkpoint (params, optimizer state, step) plus the EMA
        snapshot of this step; rank 0 writes, every rank waits for it."""
        if self.ckpt is None:
            raise RuntimeError("no path.models in the options")
        if self.rank == 0:
            self.ckpt.save(self.step, self.net.state_dict(),
                           self.optimizer.state_dict())
            if self.ema_params is not None:
                self.ckpt.save_params_only(self.ema_params, self.step,
                                           prefix="ema_params", keep=2)
        if self.parallel:
            barrier()
        return self.step

    def save_network(self, step: int) -> Optional[str]:
        """Weights only, ``params_<step>.pth``; its path (None on ranks
        other than 0, which wait for rank 0 to write it)."""
        if self.ckpt is None:
            raise RuntimeError("no path.models in the options")
        path = None
        if self.rank == 0:
            path = self.ckpt.save_params_only(self.net.state_dict(), step)
        if self.parallel:
            barrier()
        return path

    def resume_training(self, step: Optional[int] = None) -> int:
        """Restore params, optimizer state and step from checkpoint ``step``
        (the latest by default) and the EMA saved with it; a checkpoint
        written before EMA was on re-seeds it from the params."""
        if self.ckpt is None or self.optimizer is None:
            raise RuntimeError("resume needs path.models and init_params")
        ck = self.ckpt.restore(step)
        self.net.load_state_dict(ck["params"], strict=True)
        self.optimizer.load_state_dict(ck["opt_state"])
        self.step = int(ck["step"])
        if self.ema_decay > 0:
            path = os.path.join(self.ckpt.directory,
                                f"ema_params_{self.step}.pth")
            if os.path.exists(path):
                self.ema_params = {k: v.to(self.device)
                                   for k, v in load_params(path).items()}
            else:
                self.ema_params = self._params_copy()
        return self.step

    def load_pth(self, path: str) -> None:
        """Warm start from a reference ``.pth`` (strict); re-seeds EMA."""
        from stif_tpu_torch.convert import load_pth

        load_pth(self.net, path)
        if self.ema_decay > 0:
            self.ema_params = self._params_copy()


def from_torch_batch(batch: dict) -> dict:
    """A reference-style NCHW batch ({'LQs': (B,N,3,h,w), 'GT':
    (B,nt,3,H,W), 'time': [...]}) in this trainer's NHWC layout."""
    out = {
        "LQs": np.transpose(np.asarray(batch["LQs"]), (0, 1, 3, 4, 2)),
        "GT": np.transpose(np.asarray(batch["GT"]), (0, 1, 3, 4, 2)),
    }
    t = np.asarray(batch.get("time", batch.get("times")))
    # the reference's 'time' is a list of nt tensors of (B,): asarray gives
    # (nt, B); transpose to the per-sample (B, nt) layout
    out["times"] = t.reshape(-1) if t.ndim <= 1 else t.T
    return out
