"""The one generator of the benchmark's traffic: it reads a mix's
parameters (``benchmark/traffic/<mix>.json``) and makes that mix's inputs
from the seed, on the device, as host arrays the program is handed.

Two kinds of mix:

- ``windows``: ``pool`` windows of ``frames`` LR frames each: a scene
  (``scenes.sample_scene``, seeded by (seed, window)) rendered at
  ``hr_size`` at frame times 0, k, 2k, ... (k drawn from
  ``frame_step_choices``), brought to LR by MATLAB bicubic at
  1 / ``lr_factor``. A window is (frames, H, W, 3) float32.
- ``train``: one batch per entry of ``scale_plan`` (scale, LQ size), of
  the configuration's ``train_batch_size``, in
  order, as the r5 recipe's ``SyntheticVideoDataset`` draws a sample: a
  scene on a ``canvas``, a GT crop of scale x LQ size, an input pair k
  frames apart (k from ``interval_choices``), ``nt`` GT frames at sorted
  distinct frame indices in [0, k] and their times index / k, the pair
  brought to LQ by MATLAB bicubic. A batch is {'LQs' (B, 2, lq, lq, 3),
  'GT' (B, nt, g, g, 3), 'times' (B, nt)}, every sample of every batch
  drawn afresh.

Every seed gets the same sizes and counts; the seed changes the content.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from benchmark.traffic import scenes


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), *keys]))


def windows(mix: dict, seed: int, device) -> List[np.ndarray]:
    hr = tuple(mix["hr_size"])
    f = int(mix["lr_factor"])
    out = []
    for i in range(int(mix["pool"])):
        rng = _rng(seed, i)
        scene = scenes.sample_scene(rng, hr,
                                    max_speed=float(mix["max_speed"]))
        k = float(rng.choice(mix["frame_step_choices"]))
        hr_frames = scenes.render(scene, [j * k for j in range(mix["frames"])],
                                  hr, device=device)
        out.append(scenes.downscale(hr_frames, f).cpu().numpy())
    return out


def train_batches(mix: dict, batch: int, seed: int, device) -> List[dict]:
    """One batch of ``batch`` samples per entry of the mix's scale
    plan."""
    batches = []
    for b, (scale, lq) in enumerate(mix["scale_plan"]):
        g = scale * lq
        lqs, gts, times = [], [], []
        for s in range(int(batch)):
            rng = _rng(seed, b, s)
            scene = scenes.sample_scene(rng, tuple(mix["canvas"]),
                                        max_speed=float(mix["max_speed"]))
            Hc, Wc = scene["canvas"]
            origin = (rng.uniform(0, Hc - g), rng.uniform(0, Wc - g))
            k = int(rng.choice(mix["interval_choices"]))
            idx = np.sort(rng.choice(k + 1, size=int(mix["nt"]),
                                     replace=False))
            frames = scenes.render(scene, [float(i) for i in idx]
                                   + [0.0, float(k)], (g, g), origin, device)
            gts.append(frames[:-2])
            lqs.append(scenes.downscale(frames[-2:], scale))
            times.append(idx.astype(np.float32) / k)
        batches.append({"LQs": torch.stack(lqs).cpu().numpy(),
                        "GT": torch.stack(gts).cpu().numpy(),
                        "times": np.stack(times)})
    return batches
