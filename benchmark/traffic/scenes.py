"""Seeded moving scenes, the content of every cell's inputs: a copy of the
port's ``data/synthetic.py`` scene sampler (the 'default' family), with its
renderer written in PyTorch so that a pool of 720p frames is made on the
card in milliseconds.

A scene is a band-limited background (oriented sinusoids of 6-96 HR pixel
wavelengths under a global affine motion) with soft-edged textured blobs
moving over it. Frames are rendered at HR at continuous times (frame units)
and brought to LR by the MATLAB-bicubic ``imresize`` of the reference, the
degradation the models were trained on.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.ops import matlab_matrix


def sample_scene(rng: np.random.Generator, canvas: Tuple[int, int],
                 n_bg: int = 10, n_fg: int = 3,
                 max_speed: float = 3.0) -> dict:
    """Scene parameters; speeds are HR pixels per frame step. The draws are
    those of ``data/synthetic.py``'s ``sample_scene`` (family 'default')."""
    H, W = canvas
    lam = np.exp(rng.uniform(np.log(6.0), np.log(96.0), n_bg))
    theta = rng.uniform(0, np.pi, n_bg)
    freq = np.stack([np.sin(theta), np.cos(theta)], -1) / lam[:, None]
    phase = rng.uniform(0, 2 * np.pi, n_bg)
    amp = rng.normal(0, 1, (n_bg, 3)).astype(np.float32)
    amp *= 0.38 / np.abs(amp).sum(0, keepdims=True).clip(1e-6)
    n_fg = int(rng.integers(max(1, n_fg - 1), n_fg + 2))
    return {
        "canvas": canvas,
        "bg_freq": freq.astype(np.float32),
        "bg_phase": phase.astype(np.float32),
        "bg_amp": amp,
        "bg_mean": rng.uniform(0.35, 0.65, 3).astype(np.float32),
        "vel": rng.uniform(-max_speed, max_speed, 2).astype(np.float32),
        "omega": np.float32(rng.uniform(-0.004, 0.004)),
        "zoom": np.float32(rng.uniform(-0.002, 0.002)),
        "fg_pos": np.stack([rng.uniform(0.15 * H, 0.85 * H, n_fg),
                            rng.uniform(0.15 * W, 0.85 * W, n_fg)],
                           -1).astype(np.float32),
        "fg_vel": rng.uniform(-1.4 * max_speed, 1.4 * max_speed,
                              (n_fg, 2)).astype(np.float32),
        "fg_sigma": rng.uniform(9.0, 42.0, n_fg).astype(np.float32),
        "fg_color": rng.uniform(0.08, 0.92, (n_fg, 3)).astype(np.float32),
        "fg_opacity": rng.uniform(0.75, 1.0, n_fg).astype(np.float32),
        "fg_lam": np.exp(rng.uniform(np.log(5.0), np.log(28.0),
                                     n_fg)).astype(np.float32),
        "fg_tex_amp": rng.uniform(0.05, 0.22, (n_fg, 3)).astype(np.float32),
        "fg_tex_dir": rng.uniform(0, np.pi, n_fg).astype(np.float32),
    }


def render(scene: dict, times: Sequence[float], size: Tuple[int, int],
           origin: Tuple[float, float] = (0.0, 0.0),
           device="cpu") -> torch.Tensor:
    """The (size) crop at canvas offset ``origin`` at each time:
    (len(times), H, W, 3) float32 in [0, 1] on ``device``."""
    def v(key):
        return torch.as_tensor(np.asarray(scene[key]), device=device)

    Hc, Wc = scene["canvas"]
    H, W = size
    t = torch.as_tensor(np.asarray(times, np.float32),
                        device=device)[:, None, None]
    yy = (torch.arange(H, device=device, dtype=torch.float32)
          + origin[0])[None, :, None]
    xx = (torch.arange(W, device=device, dtype=torch.float32)
          + origin[1])[None, None, :]
    vel = v("vel")
    py = yy - Hc / 2.0 - vel[0] * t
    px = xx - Wc / 2.0 - vel[1] * t
    s = 1.0 + v("zoom") * t
    th = v("omega") * t
    c, sn = torch.cos(th), torch.sin(th)
    qy = (c * py + sn * px) / s + Hc / 2.0
    qx = (-sn * py + c * px) / s + Wc / 2.0
    img = v("bg_mean").expand(len(times), H, W, 3).clone()
    freq, phase, amp = v("bg_freq"), v("bg_phase"), v("bg_amp")
    for k in range(freq.shape[0]):
        wave = torch.sin(2 * np.pi * (freq[k, 0] * qy + freq[k, 1] * qx)
                         + phase[k])
        img = img + wave[..., None] * amp[k]
    pos, fvel = v("fg_pos"), v("fg_vel")
    for i in range(pos.shape[0]):
        dy = yy - (pos[i, 0] + fvel[i, 0] * t)
        dx = xx - (pos[i, 1] + fvel[i, 1] * t)
        sig = v("fg_sigma")[i]
        alpha = v("fg_opacity")[i] * torch.exp(-(dy * dy + dx * dx)
                                               / (2 * sig * sig))
        d = v("fg_tex_dir")[i]
        wave = torch.sin(2 * np.pi * (torch.sin(d) * dy + torch.cos(d) * dx)
                         / v("fg_lam")[i])
        col = v("fg_color")[i] + wave[..., None] * v("fg_tex_amp")[i]
        img = img * (1.0 - alpha[..., None]) + col * alpha[..., None]
    return img.clamp(0.0, 1.0)


def downscale(frames: torch.Tensor, factor: int) -> torch.Tensor:
    """MATLAB-bicubic (antialiased) ``1 / factor`` of (..., H, W, 3)."""
    h, w = frames.shape[-3], frames.shape[-2]
    mh = torch.from_numpy(matlab_matrix(h, h // factor)).to(frames.device)
    mw = torch.from_numpy(matlab_matrix(w, w // factor)).to(frames.device)
    y = torch.einsum("oh,...hwc->...owc", mh, frames)
    return torch.einsum("ow,...hwc->...hoc", mw, y)
