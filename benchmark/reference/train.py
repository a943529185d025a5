"""STIF's train step in plain PyTorch (the reference's ``VideoSRBaseModel``
with the r5 recipe): the summed Charbonnier loss of ``LunaTokis``'s
full-grid decode at the GT size over the query times, its gradient, the
global-norm clip, Adam (eps 1e-8, the moments bias-corrected by the update
count), the learning rate of the linear warmup and cosine restarts at the
update count before the step, and the EMA of the parameters.

The gradient of a step is summed over blocks of samples (the loss is a sum
over samples and every op is per sample), so that a batch of 18 fits.
"""

from __future__ import annotations

import bisect
import math
from typing import Dict, List, Optional

import torch

from benchmark.reference import stif


def learning_rate(cfg: dict, count: int) -> float:
    """The lr of update ``count`` (0-based): linear warmup below
    ``warmup_iter``, else cosine annealing with restarts."""
    base = float(cfg["lr_G"])
    warm = int(cfg.get("warmup_iter") or -1)
    if 0 < warm and count < warm:
        return base * count / warm
    rs = [0] + sorted(cfg["restarts"])
    ws = [1.0] + list(cfg["restart_weights"])
    i = max(bisect.bisect_right(rs, count) - 1, 0)
    eta = float(cfg["eta_min"])
    cos = math.cos(math.pi * (count - rs[i]) / float(cfg["T_period"][i]))
    return eta + (base * ws[i] - eta) * (1 + cos) / 2


def charbonnier(x, y, eps: float = 1e-6):
    d = x - y
    return torch.sum(torch.sqrt(d * d + eps))


def batch_loss(P, arch, lqs, gt, times, weight: float = 1.0):
    """Summed Charbonnier over the query times of one block of samples."""
    pred = stif.forward(P, arch, lqs, times, gt.shape[2:4])
    return sum(weight * charbonnier(pred[t], gt[:, t])
               for t in range(gt.shape[1]))


def train_steps(state: Dict[str, torch.Tensor], arch: dict, cfg: dict,
                batches: List[dict], block: int = 3,
                half_batch: bool = False,
                ema0: Optional[Dict[str, torch.Tensor]] = None) -> dict:
    """Run the train step on ``batches`` (each {'lqs', 'gt', 'times'} on
    the device) from parameters ``state`` and the EMA ``ema0`` (by default
    the parameters), counts 0, 1, ... Returns each
    step's ``loss`` and pre-clip ``grad_norm``, ``grad`` (the first step's
    clipped gradient, as Adam receives it), ``params`` (after the last
    step) and ``ema`` (the EMA after the last step). ``half_batch`` plants
    a fault: the loss of the first half of each batch, scaled to the whole
    batch's size."""
    if cfg.get("pixel_criterion", "cb") != "cb":
        raise ValueError("the reference trains the Charbonnier loss only")
    b1, b2 = float(cfg["beta1"]), float(cfg["beta2"])
    clip = float(cfg.get("grad_clip") or 0.0)
    decay = float(cfg.get("ema_decay") or 0.0)
    pw = float(cfg.get("pixel_weight", 1.0))
    P = {k: v.detach().clone().requires_grad_(True) for k, v in state.items()}
    mu = {k: torch.zeros_like(v) for k, v in P.items()}
    nu = {k: torch.zeros_like(v) for k, v in P.items()}
    ema = {k: v.detach().clone()
           for k, v in (P if ema0 is None else ema0).items()}
    out = {"loss": [], "grad_norm": []}
    for count, batch in enumerate(batches):
        B = batch["lqs"].shape[0]
        rows = B // 2 if half_batch else B
        scale = B / rows
        for v in P.values():
            v.grad = None
        total = 0.0
        for a in range(0, rows, block):
            b = min(a + block, rows)
            loss = scale * batch_loss(P, arch, batch["lqs"][a:b],
                                      batch["gt"][a:b],
                                      batch["times"][a:b], pw)
            loss.backward()
            total += float(loss.detach())
        with torch.no_grad():
            g = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                 for k, v in P.items()}
            norm = torch.sqrt(sum((x.double() ** 2).sum() for x in g.values()))
            if clip > 0 and float(norm) >= clip:
                g = {k: x / norm.float() * clip for k, x in g.items()}
            if count == 0:
                out["grad"] = {k: x.clone() for k, x in g.items()}
            lr = learning_rate(cfg, count)
            c = count + 1
            for k, v in P.items():
                mu[k].mul_(b1).add_(g[k], alpha=1 - b1)
                nu[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                step = (mu[k] / (1 - b1 ** c)) / (
                    torch.sqrt(nu[k] / (1 - b2 ** c)) + 1e-8)
                v.sub_(lr * step)
                if decay > 0:
                    ema[k].mul_(decay).add_(v, alpha=1 - decay)
        out["loss"].append(total)
        out["grad_norm"].append(float(norm))
    out["params"] = {k: v.detach() for k, v in P.items()}
    out["ema"] = ema
    return out
