"""Procedural video: a deterministic eval source (the port's own copy of
the scene sampler and renderers of ``stif_tpu/data/synthetic.py``; numpy
only, ``cv2`` only inside the two folder writers).

*Band-limited analytic scenes* whose frames can be evaluated at exact
subpixel positions for any continuous time:

  * background: a sum of oriented sinusoids (wavelengths spanning the
    LR-Nyquist boundary, so x4 SR has genuine detail to recover) under a
    global affine motion (translation + slight rotation/zoom);
  * foreground: soft-edged moving blobs carrying their own texture and
    velocity — occlusion boundaries and multiple motions for the flow stage;
  * everything analytic in (y, x, t): no resampling artifacts in GT, exact
    subpixel displacement between frames.

``SyntheticVideoDataset`` draws training windows over these scenes (and,
with ``natural_frac``, over the photographic scenes of
``stif_tpu_torch.data.natural``), deterministic per (seed, index).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def sample_scene(rng: np.random.Generator, canvas: Tuple[int, int] = (360, 480),
                 n_bg: int = 10, n_fg: int = 3, max_speed: float = 3.0,
                 family: str = "default") -> dict:
    """Draw scene parameters. Speeds are HR pixels per frame step.

    Families (harder held-out domains; the reference's data is natural
    video with exactly these failure modes, ``codes/data/Vimeo7_dataset.py``):
      * ``default``   — the training distribution (byte-identical draws to
                        the pre-family sampler for a given rng state);
      * ``occlusion`` — more, larger, faster, near-opaque blobs with
                        crossing trajectories: dense occlusion boundaries
                        stress the flow/alignment stages;
      * ``lighting``  — a global illumination ramp over time (gain + bias
                        drift) breaks the brightness-constancy assumption
                        the alignment implicitly relies on.
    """
    if family == "occlusion":
        n_fg = n_fg + 3
        max_speed = max_speed * 1.5
    H, W = canvas
    # background sinusoids: wavelengths log-uniform in [6, 96] px — the x4 LR
    # grid's Nyquist wavelength is 8 px, so part of the band is only
    # recoverable by SR, part survives downsampling (anchors registration)
    lam = np.exp(rng.uniform(np.log(6.0), np.log(96.0), n_bg))
    theta = rng.uniform(0, np.pi, n_bg)
    freq = np.stack([np.sin(theta), np.cos(theta)], -1) / lam[:, None]  # (K,2)
    phase = rng.uniform(0, 2 * np.pi, n_bg)
    amp = rng.normal(0, 1, (n_bg, 3)).astype(np.float32)
    amp *= 0.38 / np.abs(amp).sum(0, keepdims=True).clip(1e-6)
    n_fg = int(rng.integers(max(1, n_fg - 1), n_fg + 2))
    # family-specific extras drawn AFTER the base draws so 'default' scenes
    # stay byte-identical to the pre-family sampler for a given rng state
    gain_slope = bias_slope = np.float32(0.0)
    opacity_lo = 0.75
    if family == "lighting":
        gain_slope = np.float32(rng.uniform(-0.035, 0.035))
        bias_slope = np.float32(rng.uniform(-0.02, 0.02))
    elif family == "occlusion":
        opacity_lo = 0.92
    return {
        "gain_slope": gain_slope,
        "bias_slope": bias_slope,
        "canvas": canvas,
        "bg_freq": freq.astype(np.float32),
        "bg_phase": phase.astype(np.float32),
        "bg_amp": amp,
        "bg_mean": rng.uniform(0.35, 0.65, 3).astype(np.float32),
        # global affine motion of the background
        "vel": rng.uniform(-max_speed, max_speed, 2).astype(np.float32),
        "omega": np.float32(rng.uniform(-0.004, 0.004)),       # rad / frame
        "zoom": np.float32(rng.uniform(-0.002, 0.002)),        # /frame
        # foreground blobs
        "fg_pos": np.stack([rng.uniform(0.15 * H, 0.85 * H, n_fg),
                            rng.uniform(0.15 * W, 0.85 * W, n_fg)],
                           -1).astype(np.float32),
        "fg_vel": rng.uniform(-1.4 * max_speed, 1.4 * max_speed,
                              (n_fg, 2)).astype(np.float32),
        "fg_sigma": rng.uniform(9.0, 42.0, n_fg).astype(np.float32),
        "fg_color": rng.uniform(0.08, 0.92, (n_fg, 3)).astype(np.float32),
        "fg_opacity": rng.uniform(opacity_lo, 1.0, n_fg).astype(np.float32),
        "fg_lam": np.exp(rng.uniform(np.log(5.0), np.log(28.0),
                                     n_fg)).astype(np.float32),
        "fg_tex_amp": rng.uniform(0.05, 0.22, (n_fg, 3)).astype(np.float32),
        "fg_tex_dir": rng.uniform(0, np.pi, n_fg).astype(np.float32),
    }


def render_frame(scene: dict, t: float, size: Tuple[int, int],
                 origin: Tuple[float, float] = (0.0, 0.0)) -> np.ndarray:
    """Render the (size[0], size[1]) crop at canvas offset ``origin`` at
    continuous time ``t`` (frame units). Returns (H, W, 3) float32 in [0,1].
    Cost is proportional to the crop, not the canvas."""
    Hc, Wc = scene["canvas"]
    H, W = size
    y0, x0 = origin
    yy, xx = np.meshgrid(
        np.arange(H, dtype=np.float32) + y0,
        np.arange(W, dtype=np.float32) + x0, indexing="ij",
    )
    # inverse-map through the global affine (rotate/zoom about the canvas
    # center, then translate): background sampled at q
    cy, cx = Hc / 2.0, Wc / 2.0
    py = yy - cy - scene["vel"][0] * t
    px = xx - cx - scene["vel"][1] * t
    s = 1.0 + scene["zoom"] * t
    th = scene["omega"] * t
    c, sn = np.cos(th), np.sin(th)
    qy = (c * py + sn * px) / s + cy
    qx = (-sn * py + c * px) / s + cx

    fy = scene["bg_freq"][:, 0][:, None, None]
    fx = scene["bg_freq"][:, 1][:, None, None]
    ph = scene["bg_phase"][:, None, None]
    waves = np.sin(2 * np.pi * (fy * qy[None] + fx * qx[None]) + ph)  # (K,H,W)
    img = scene["bg_mean"][None, None, :] + np.einsum(
        "khw,kc->hwc", waves, scene["bg_amp"])

    for i in range(scene["fg_pos"].shape[0]):
        by = scene["fg_pos"][i, 0] + scene["fg_vel"][i, 0] * t
        bx = scene["fg_pos"][i, 1] + scene["fg_vel"][i, 1] * t
        dy = yy - by
        dx = xx - bx
        sig = scene["fg_sigma"][i]
        alpha = scene["fg_opacity"][i] * np.exp(
            -(dy * dy + dx * dx) / (2 * sig * sig))
        # blob-attached texture (moves with the blob)
        d = scene["fg_tex_dir"][i]
        wave = np.sin(2 * np.pi * (np.sin(d) * dy + np.cos(d) * dx)
                      / scene["fg_lam"][i])
        col = scene["fg_color"][i][None, None, :] + (
            wave[..., None] * scene["fg_tex_amp"][i][None, None, :])
        img = img * (1.0 - alpha[..., None]) + col * alpha[..., None]

    # global illumination drift ('lighting' family; zero slopes otherwise —
    # .get keeps pre-family scene dicts working)
    gs = float(scene.get("gain_slope", 0.0))
    bs = float(scene.get("bias_slope", 0.0))
    if gs or bs:
        img = img * (1.0 + gs * t) + bs * t

    return np.clip(img, 0.0, 1.0).astype(np.float32)


def render_sequence(seed: int, n_frames: int, size: Tuple[int, int],
                    frame_step: float = 1.0,
                    canvas: Optional[Tuple[int, int]] = None,
                    family: str = "default") -> np.ndarray:
    """(n_frames, H, W, 3) clip of one scene — eval sequences / demos."""
    rng = np.random.default_rng(seed)
    scene = sample_scene(rng, canvas=canvas or size, family=family)
    return np.stack([
        render_frame(scene, i * frame_step, size) for i in range(n_frames)
    ])


def render_eval_folders(root: str, n_scenes: int = 4, n_frames: int = 12,
                        size: Tuple[int, int] = (144, 192),
                        seed0: int = 990_000) -> str:
    """Render deterministic scenes to ``<root>/scene<k>/*.png`` (idempotent).

    The offline eval uses seed0 990_000 and the in-training validator of
    the JAX package seed0 880_000: disjoint seed ranges keep the dev split
    and the held-out eval split distinct, and both sit far outside the
    training sampler's ``SeedSequence([seed, index])`` stream.
    """
    import os

    import cv2

    os.makedirs(root, exist_ok=True)
    for k in range(n_scenes):
        d = os.path.join(root, f"scene{k}")
        if os.path.isdir(d) and len(os.listdir(d)) == n_frames:
            continue
        os.makedirs(d, exist_ok=True)
        clip = render_sequence(seed0 + k, n_frames, size)
        for t in range(n_frames):
            img = (np.clip(clip[t], 0, 1) * 255).round().astype(np.uint8)
            cv2.imwrite(os.path.join(d, f"{t:03d}.png"), img[..., ::-1])
    return root


def render_eval_suite(root: str, n_per_family: int = 4, n_frames: int = 12,
                      size: Tuple[int, int] = (144, 192),
                      seed0: int = 990_000,
                      families=("default", "occlusion", "lighting")) -> str:
    """The widened held-out eval set: ``n_per_family``
    scenes per family rendered to ``<root>/<family><k>/*.png`` (idempotent).
    The 'default' scenes reuse the classic eval seeds (seed0 + k) and are
    pixel-identical to ``render_eval_folders``'s scene<k>; harder families
    get disjoint seed blocks."""
    import os

    import cv2

    os.makedirs(root, exist_ok=True)
    for fi, fam in enumerate(families):
        for k in range(n_per_family):
            d = os.path.join(root, f"{fam}{k}")
            if os.path.isdir(d) and len(os.listdir(d)) == n_frames:
                continue
            os.makedirs(d, exist_ok=True)
            clip = render_sequence(seed0 + fi * 1000 + k, n_frames, size,
                                   family=fam)
            for t in range(n_frames):
                img = (np.clip(clip[t], 0, 1) * 255).round().astype(np.uint8)
                cv2.imwrite(os.path.join(d, f"{t:03d}.png"), img[..., ::-1])
    return root


class SyntheticVideoDataset:
    """x8-temporal windows over procedural scenes (AdobeDataset schema).

    ``nt`` GT frames are drawn per sample at random window indices — times
    DIFFER per sample, exercising the per-sample pe conditioning path.
    """

    def __init__(self, n_items: int = 20000, gt_size: int = 192,
                 scale: int = 4, nt: int = 3, interval: int = 8,
                 interval_choices=None, seed: int = 0, phase: str = "train",
                 max_speed: float = 3.0, scale_plan=None,
                 natural_frac: float = 0.0, **_ignored):
        self.n_items = n_items
        self.gt_size, self.scale = gt_size, scale
        self.nt, self.interval = nt, interval
        # per-sample random pair span (frames between the two inputs): the
        # eval protocols query pairs at several motion magnitudes (the Vid4
        # recipe's every-2nd-frame inputs span 2 frames; x8-temporal spans
        # 8) — mixing spans at train time matches that distribution.
        self.interval_choices = (list(interval_choices)
                                 if interval_choices else None)
        self.seed = seed
        self.phase = phase
        self.max_speed = max_speed
        # Mixed-scale training (the reference's batch-level random-scale
        # recipe, collate_function2 ``codes/data/__init__.py:124-154``, with
        # a finite bucket plan as in ``collate_arbitrary_scale``). Each entry
        # is [scale, lq_size]; one bucket is drawn PER BATCH (all samples
        # share a shape) via ``load_batch``.
        self.scale_plan = ([(int(s), int(lq)) for s, lq in scale_plan]
                           if scale_plan else None)
        # fraction of samples drawn from the layered photographic family
        # (``data/natural.py``): subpixel affine + independent occluding
        # layers — the real-video-statistics slice of the train distribution
        self.natural_frac = float(natural_frac or 0.0)
        # batch-level API only engages when a batch-level decision exists
        self.use_load_batch = bool(self.scale_plan) or self.natural_frac > 0

    def __len__(self):
        return self.n_items

    def _sample_scene(self, rng, g: int):
        """Scene + a crop origin whose window stays on-canvas; with
        ``natural_frac``, a per-sample draw picks the photographic family."""
        if self.natural_frac > 0 and rng.random() < self.natural_frac:
            from stif_tpu_torch.data.natural import (
                find_natural_textures, sample_natural_scene)

            if find_natural_textures():
                margin = int(np.ceil(1.4 * self.max_speed * 8)) + 4
                scene = sample_natural_scene(
                    rng, min_canvas=(g + 2 * margin, g + 2 * margin),
                    max_speed=self.max_speed)
                Hc, Wc = scene["canvas"]
                y0 = rng.uniform(margin, max(margin + 1, Hc - g - margin))
                x0 = rng.uniform(margin, max(margin + 1, Wc - g - margin))
                return scene, y0, x0
        scene = sample_scene(rng, max_speed=self.max_speed)
        Hc, Wc = scene["canvas"]
        return scene, rng.uniform(0, Hc - g), rng.uniform(0, Wc - g)

    def _render_item(self, index: int, scale: int, gt_size: int):
        from stif_tpu_torch.data.datasets import host_imresize

        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, int(index)]))
        g = gt_size
        scene, y0, x0 = self._sample_scene(rng, g)
        render = render_frame
        if scene.get("kind") == "natural":
            from stif_tpu_torch.data.natural import render_natural_frame

            render = render_natural_frame

        k = self.interval  # input pair = frames (0, k)
        if self.interval_choices:
            k = int(rng.choice(self.interval_choices))
        if self.phase == "train":
            idx = np.sort(rng.choice(k + 1, size=min(self.nt, k + 1),
                                     replace=False))
            if idx.size < self.nt:  # k+1 < nt: pad by repeating times
                idx = np.concatenate(
                    [idx, idx[rng.integers(0, idx.size, self.nt - idx.size)]])
                idx = np.sort(idx)
        else:
            idx = np.linspace(0, k, self.nt).round().astype(int)
        times = idx.astype(np.float32) / k

        gts = np.stack([
            render(scene, float(i), (g, g), (y0, x0)) for i in idx
        ])
        lq0 = render(scene, 0.0, (g, g), (y0, x0))
        lqk = render(scene, float(k), (g, g), (y0, x0))
        lqs = host_imresize(np.stack([lq0, lqk]), 1.0 / scale)
        return {
            "LQs": np.ascontiguousarray(lqs.astype(np.float32)),
            "GT": np.ascontiguousarray(gts),
            "times": times,
            "key": f"syn{self.seed}_{index}",
        }

    def __getitem__(self, index: int):
        return self._render_item(index, self.scale, self.gt_size)

    def load_batch(self, indices, group=None):
        """Batch-level loading: draw ONE (scale, lq_size) bucket for the
        whole batch (deterministic in (seed, group)), render every sample
        at that shape, and stack: the reference's batch-level random-scale
        collate (``codes/data/__init__.py:63-121``) over a bucket plan:
        per-batch scale, per-sample times. ``group``: the indices of the
        global batch that ``indices`` is a data-parallel rank's share of
        (``indices`` by default)."""
        if self.scale_plan:
            group = indices if group is None else group
            brng = np.random.default_rng(np.random.SeedSequence(
                [self.seed, 1_000_003] + [int(i) for i in group]))
            s, lq = self.scale_plan[int(brng.integers(len(self.scale_plan)))]
            g = s * lq
        else:
            s, g = self.scale, self.gt_size
        samples = [self._render_item(int(i), s, g) for i in indices]
        out = {k: (np.stack([smp[k] for smp in samples])
                   if k != "key" else [smp[k] for smp in samples])
               for k in samples[0]}
        out["scale"] = s
        return out
