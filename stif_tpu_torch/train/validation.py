"""In-training validation and keep-best (port of
``stif_tpu/train/validation.py``): the ``val_freq`` hook the reference loop
runs (``codes/options/train/train_zsm.yml:69`` ``val_freq: 5e3``).

The validator keeps its own eval copy of the net with the fused SIREN
kernel on, loads the live (or EMA) state dict into it for each probe and
runs the Vid4-protocol harness ``eval_space_time_sr`` through an
``InferencePipeline`` (under ``inference_mode``), so keep-best selects on
what serving computes. The dev split (seed0 880_000) is disjoint from the
held-out eval split (seed0 990_000, ``scripts/eval_model_torch.py``).

Its pipelines replay their buckets' CUDA graphs on a card (``compiled``, as
``InferencePipeline`` takes it; a ``ProgramCache`` given is the x4
pipeline's, each scale probe's pipeline gets a sibling of it). The state
dict is loaded in place, so a probe after the first is a replay that reads
the new weights, as the JAX validator's fresh params are "a device_put, not
a recompile". Each pipeline's pool stays allocated between probes
(``stats``).
"""

from __future__ import annotations

import copy
import json
import logging
import os

import numpy as np
import torch

from stif_tpu_torch.nn.siren import set_fused
from stif_tpu_torch.train.checkpoints import atomic_save, load_params

log = logging.getLogger("base")


class Validator:
    """Vid4-protocol space-time probe on a held-out dev split.

    ``validate(params) -> dict`` with t0 / t0.5 Y-PSNR and SSIM and a scalar
    ``score`` (t0_psnr + t05_psnr) for keep-best selection; ``params`` is a
    state dict of ``net``'s schema.
    """

    def __init__(self, net: torch.nn.Module, root: str = "runs/val_data",
                 n_scenes: int = 3, n_frames: int = 12, size=(144, 192),
                 seed0: int = 880_000, device=None, scale_probes=(),
                 compiled=None):
        from stif_tpu_torch.data.synthetic import render_eval_folders

        self.net = copy.deepcopy(net).eval()
        for p in self.net.parameters():
            p.grad = None
            p.requires_grad_(False)
        set_fused(self.net, True)
        self.root = render_eval_folders(root, n_scenes=n_scenes,
                                        n_frames=n_frames, size=size,
                                        seed0=seed0)
        self.device = device
        self.compiled = compiled
        self._pipe = None
        # extra 1-scene t=0 probes at other spatial scales, logged into the
        # val curve beside their bicubic bars, not part of the score
        self.scale_probes = tuple(int(s) for s in (scale_probes or ()))
        self._probe_pipes = {}
        self._probe_data = {}

    def validate(self, params: dict) -> dict:
        from stif_tpu_torch.runtime import InferencePipeline
        from stif_tpu_torch.runtime.eval import eval_space_time_sr

        self.net.load_state_dict(params, strict=True)  # in place
        if self._pipe is None:
            self._pipe = InferencePipeline(self.net, scale=4, bucket=8,
                                           device=self.device,
                                           compiled=self._compiled())
        res = eval_space_time_sr(self._pipe, self.root, times=(0.5, 0.0))
        log.info("val: x4 protocol done")
        t0 = float(res.psnr_by_time[0.0])
        t05 = float(res.psnr_by_time[0.5])
        out = {
            "t0_psnr": t0,
            "t05_psnr": t05,
            "t0_ssim": float(res.ssim_by_time[0.0]),
            "t05_ssim": float(res.ssim_by_time[0.5]),
            "mean_psnr": float(res.mean_psnr),
            "score": t0 + t05,
        }
        for s in self.scale_probes:
            out.update(self._scale_probe(s))
        return out

    def _compiled(self):
        """A new pipeline's ``compiled``: a cache given goes to the first
        pipeline, each later one gets a sibling (a pool of its own)."""
        from stif_tpu_torch.runtime import ProgramCache

        if isinstance(self.compiled, ProgramCache) and self._pipe is not None:
            return self.compiled.sibling()
        return self.compiled

    def stats(self) -> dict:
        """Each pipeline's programs (``ProgramCache.stats``: replays,
        warm-up and capture ms, pool bytes, launches), None when eager."""
        pipes = {"x4": self._pipe, **{f"x{s}_probe": p for s, p in
                                      self._probe_pipes.items()}}
        return {k: (None if p is None or p.programs is None
                    else p.programs.stats()) for k, p in pipes.items()}

    def _scale_probe(self, s: int) -> dict:
        """t=0 Y-PSNR at spatial scale ``s`` on the first dev scene (and its
        bicubic bar, computed once), with the params ``validate`` loaded."""
        from stif_tpu_torch.data.native import host_imresize
        from stif_tpu_torch.runtime import InferencePipeline
        from stif_tpu_torch.runtime.eval import _load_frames
        from stif_tpu_torch.utils.metrics import bgr2ycbcr, calculate_psnr

        def ypsnr(pred, ref):
            p = bgr2ycbcr(np.clip(pred, 0, 1)[..., ::-1].astype(np.float32))
            r = bgr2ycbcr(ref[..., ::-1].astype(np.float32))
            return calculate_psnr(p * 255, r * 255)

        if s not in self._probe_data:
            folder = sorted(
                d for d in os.listdir(self.root)
                if os.path.isdir(os.path.join(self.root, d)))[0]
            gt = _load_frames(os.path.join(self.root, folder))
            H = gt.shape[1] - gt.shape[1] % (2 * s)
            W = gt.shape[2] - gt.shape[2] % (2 * s)
            gt = gt[:2, :H, :W]
            lr = host_imresize(gt, 1.0 / s)
            up = host_imresize(lr, float(s))
            self._probe_data[s] = (lr, gt, float(ypsnr(up[0], gt[0])))
        lr, gt, bi = self._probe_data[s]
        if s not in self._probe_pipes:
            self._probe_pipes[s] = InferencePipeline(
                self.net, scale=s, bucket=4, device=self.device,
                compiled=self._compiled())
        pred = self._probe_pipes[s].render_window(np.stack([lr[0], lr[1]]),
                                                  [0.0])
        return {f"x{s}_t0": float(ypsnr(pred[0], gt[0])), f"x{s}_bi_t0": bi}


class BestTracker:
    """Keep-best weights plus a JSON validation curve.

    Writes ``val_curve.jsonl`` (one record per probe) and keeps exactly one
    weights-only ``params_best_<step>.pth`` (the previous best is deleted),
    with a ``best.json`` pointer: a ``<iter>_G.pth``-style deliverable
    chosen on the dev score. A new best must score strictly higher.
    """

    def __init__(self, models_dir: str):
        self.dir = os.path.abspath(models_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.curve_path = os.path.join(self.dir, "val_curve.jsonl")
        self.best_path = os.path.join(self.dir, "best.json")
        self.best = None
        if os.path.exists(self.best_path):
            with open(self.best_path) as f:
                self.best = json.load(f)

    def update(self, step: int, metrics: dict, params: dict) -> bool:
        """Record the probe; if it is the new best, save ``params`` (a state
        dict). Returns True when a new best was saved."""
        rec = {"step": int(step), **{k: round(float(v), 4)
                                     for k, v in metrics.items()}}
        with open(self.curve_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.best is not None and rec["score"] <= self.best["score"]:
            return False
        path = os.path.join(self.dir, f"params_best_{int(step)}.pth")
        atomic_save(params, path)
        prev = self.best
        self.best = {**rec, "path": path}
        with open(self.best_path, "w") as f:
            json.dump(self.best, f, indent=2)
        if prev and prev.get("path") and prev["path"] != path \
                and os.path.exists(prev["path"]):
            os.remove(prev["path"])
        return True


def load_best_params(models_dir: str):
    """``(state_dict, best record)`` of the keep-best weights written by
    ``BestTracker``; the state dict is on the CPU."""
    with open(os.path.join(models_dir, "best.json")) as f:
        best = json.load(f)
    return load_params(best["path"]), best
