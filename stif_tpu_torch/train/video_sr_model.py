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

The step, the optimizer's update and the EMA are one program per scale
bucket (``trainer.make_train_step(programs=)``), the counterpart of the JAX
package's jitted step and EMA: ``compiled`` None gives CUDA graphs on a
card and the eager step on another device, False the eager step, True
graphs (``ValueError`` off a card), or a ``ProgramCache`` of the caller's.
Loads (``resume_training``, ``load_pth``) copy into the tensors a graph
writes, in place; what the step updates is in the program's key, so a
tensor put in place of one is a new capture, never a replay over memory
let go of. After a step, ``p.grad`` holds that step's clipped gradient in
a buffer allocated once. ``optimize_parameters`` fetches its logs to the
host in one blocking copy; ``run_step`` leaves them on the device. A
step's host spans (``utils/trace.py``): ``train.feed`` (pin and upload),
``launch.copy_in`` and ``launch.replay`` (in its program), ``fetch.wait``
(the wait for the step and its logs' copy to page-locked memory) and
``train.logs`` (the logs read after it), added to its program's table.

With ``parallel`` the model trains data-parallel (DDP, one process per
device; see ``trainer.make_parallel_train_step``), op by op: ``compiled``
True or a cache raises ``NotImplementedError`` there. Each rank is fed its own
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
from stif_tpu_torch.runtime.compiled import ProgramCache, program_cache
from stif_tpu_torch.runtime.pipeline import resolve_device
from stif_tpu_torch.train.checkpoints import CheckpointManager, load_params
from stif_tpu_torch.train.trainer import (EMA, TrainConfig, make_optimizer,
                                          make_parallel_train_step,
                                          make_train_step)
from stif_tpu_torch.utils import trace


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
    ``cuda:LOCAL_RANK``). ``compiled``: see the module docstring."""

    def __init__(self, opt: dict, device=None, parallel: bool = False,
                 compiled=None):
        self.opt = opt
        self.device = resolve_device(device)
        self.parallel = parallel
        if parallel and (compiled is True
                         or isinstance(compiled, ProgramCache)):
            raise NotImplementedError(
                "the data-parallel step has no CUDA graph yet (ROADMAP.md "
                "Queue 1 item 23); pass compiled=None or False with "
                "parallel=True")
        if parallel:
            self.device = join_process_group(self.device)
        self.programs = (None if parallel
                         else program_cache(self.device, compiled))
        self.rank, self.world = rank_and_world() if parallel else (0, 1)
        self.net = define_g(opt)
        set_fused(self.net, False)
        self.net.to(self.device).train()
        self.cfg = train_config(opt)
        self.ema_decay = float((opt.get("train") or {}).get("ema_decay", 0.0)
                               or 0.0)
        self.ema = None
        self.optimizer = None
        self._step_fn = None
        self.step = 0
        self.log = {}
        models_dir = (opt.get("path") or {}).get("models")
        self.ckpt = CheckpointManager(models_dir) if models_dir else None
        self._batch = None
        self._tally: Optional[trace.Tally] = None  # the step's host spans

    # ---------------------------------------------------------------- setup

    def init_params(self, example_lqs, example_times, seed: int = 0) -> dict:
        """Draw every parameter by the reference's training init from a
        generator seeded with ``seed`` and start the optimizer at step 0.
        The example batch is not read: a torch net's parameter shapes are
        fixed at construction (the JAX package inits from its shapes)."""
        init_model_(self.net, torch.Generator().manual_seed(int(seed)))
        self.optimizer, _ = make_optimizer(self.net.parameters(), self.cfg)
        self.ema = (EMA(self.net, self.ema_decay) if self.ema_decay > 0
                    else None)
        if self.programs is not None:
            self.programs.clear()  # the old state's programs
        if self.parallel:
            from stif_tpu_torch.parallel import default_mesh

            mesh = default_mesh(self.world, device_type=self.device.type)
            self._step_fn = make_parallel_train_step(
                self.net, self.optimizer, self.cfg, mesh,
                per_sample_times=np.ndim(example_times) == 2, ema=self.ema)
        else:
            self._step_fn = make_train_step(self.net, self.optimizer,
                                            self.cfg, self.programs,
                                            self.ema)
        self.step = 0
        return self.net.state_dict()

    @property
    def ema_params(self) -> Optional[dict]:
        """The EMA's state dict (its own tensors), or None with EMA off."""
        return None if self.ema is None else self.ema.params

    # ------------------------------------------------------------- training

    def feed_data(self, data: dict) -> None:
        """data: {'LQs': (B,N,h,w,3), 'GT': (B,nt,H,W,3), 'times': (nt,)
        shared or (B,nt) per sample}, NHWC (the reference's NCHW batches
        convert with ``from_torch_batch``); data-parallel, this rank's
        rows. On a card each array goes through page-locked memory by a
        copy that does not block the host."""
        def dev(a):
            a = np.ascontiguousarray(a, np.float32)
            if self.device.type != "cuda":
                return torch.as_tensor(a, device=self.device)
            return torch.from_numpy(a).pin_memory().to(self.device,
                                                       non_blocking=True)

        self._tally = trace.Tally()
        with trace.span("train.feed", into=self._tally):
            times = dev(data["times"])
            if times.dim() > 2:
                times = times.reshape(times.shape[0], -1)
            self._batch = {"lqs": dev(data["LQs"]), "gt": dev(data["GT"]),
                           "times": times}

    def run_step(self) -> dict:
        """One train step on the fed batch at the model's own update count:
        {'loss', 'grad_norm'} as 0-dim tensors on the device, no host sync
        (a compiled step's are its program's outputs: read them before the
        next step)."""
        if self._step_fn is None:
            raise RuntimeError("call init_params first")
        if self._tally is None:
            self._tally = trace.Tally()
        metrics = self._step_fn(self._batch, self.step, self._tally)
        self.step += 1
        return metrics

    def optimize_parameters(self, step: Optional[int] = None) -> dict:
        """``run_step``, then its logs on the host by one blocking copy
        (``step`` is accepted for the reference's signature and not
        read); commits the step's host spans."""
        metrics = self.run_step()
        tally, self._tally = self._tally, None
        names = list(metrics)
        logs = torch.stack([metrics[k] for k in names])
        if self.device.type == "cuda":
            # queued into page-locked memory; the one wait is the stream's
            logs = logs.to("cpu", non_blocking=True)
            with trace.span("fetch.wait", into=tally):
                torch.cuda.current_stream(self.device).synchronize()
        with trace.span("train.logs", into=tally):
            values = logs.tolist()
        tally.commit()
        self.log = dict(zip(names, values))
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
        # every load copies in place: a captured step writes these tensors
        self.net.load_state_dict(ck["params"], strict=True)
        self.optimizer.load_state_dict(ck["opt_state"])
        self.step = int(ck["step"])
        if self.ema is not None:
            path = os.path.join(self.ckpt.directory,
                                f"ema_params_{self.step}.pth")
            self.ema.load(load_params(path) if os.path.exists(path)
                          else self.net.state_dict())
        return self.step

    def load_pth(self, path: str) -> None:
        """Warm start from a reference ``.pth`` (strict, in place);
        re-seeds EMA."""
        from stif_tpu_torch.convert import load_pth

        load_pth(self.net, path)
        if self.ema is not None:
            self.ema.load(self.net.state_dict())


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
