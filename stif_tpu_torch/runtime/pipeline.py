"""Inference pipeline (port of ``stif_tpu/runtime/pipeline.py``): padding,
sliding frame windows, and the window renderer.

The JAX pipeline buckets padded shapes to reuse compiled programs; PyTorch
runs eagerly, so here ``bucket`` only sets the padding multiple, which keeps
the output identical to the JAX pipeline's.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device the pipeline runs on: CUDA unless the caller asks for
    another. Raises when CUDA is asked for (or defaulted to) and no GPU is
    present — the pipeline never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def pad_to_multiple(x: np.ndarray, multiple: int = 4,
                    bucket: int = 1) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Zero-pad (..., H, W, C) so H and W are multiples of
    ``max(multiple, bucket)``. Returns (padded, (H, W) original)."""
    h, w = x.shape[-3], x.shape[-2]
    m = max(multiple, bucket)
    hp = int(m * math.ceil(h / m))
    wp = int(m * math.ceil(w / m))
    pad = [(0, 0)] * (x.ndim - 3) + [(0, hp - h), (0, wp - w), (0, 0)]
    return np.pad(x, pad), (h, w)


def window_plan(skip: bool, n_out: int, len_in: int) -> List[List[List[int]]]:
    """Sliding-window index plans for long sequences (the reference's
    ``test_index_generation``). Returns [input_indices, output_indices]
    windows; with ``skip`` the inputs are every 2nd frame of each
    ``n_out``-frame output window."""
    n_in = 1 + n_out // 2
    if n_in > len_in:
        raise ValueError("input too short for one window")
    plans = []
    if skip:
        right = n_out
        while right <= len_in:
            h_list = [right - n_out + x for x in range(n_out)]
            right += n_out - 1
            plans.append([h_list[::2], h_list])
        if right < len_in - 1:
            h_list = [len_in - n_out + x for x in range(n_out)]
            plans.append([h_list[::2], h_list])
    else:
        right, right_in = n_out, n_in
        while right_in <= len_in:
            h_list = [right - n_out + x for x in range(n_out)]
            l_list = [right_in - n_in + x for x in range(n_in)]
            right += n_out - 1
            right_in += n_in - 1
            plans.append([l_list, h_list])
        if right_in < len_in - 1:
            right = len_in * 2 - 1
            h_list = [right - n_out + x for x in range(n_out)]
            l_list = [len_in - n_in + x for x in range(n_in)]
            plans.append([l_list, h_list])
    return plans


class InferencePipeline:
    """Renders LR frame windows with a ``LunaTokis`` on one device (CUDA
    unless ``device`` says otherwise)."""

    def __init__(self, model: torch.nn.Module, scale: int = 4,
                 bucket: int = 16, device=None, self_ensemble: bool = False):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.scale = scale
        self.bucket = bucket
        # x8 geometric self-ensemble (EDSR dihedral average): not a
        # reference mode; an optional quality / compute trade
        self.self_ensemble = self_ensemble

    def render_window(self, frames: np.ndarray,
                      times: Sequence[float]) -> np.ndarray:
        """frames: (N, H, W, 3) float32 RGB in [0, 1] ->
        (nt, H*scale, W*scale, 3) float32."""
        if self.self_ensemble:
            return self._render_window_ensemble(frames, times)
        return self._render_window_raw(frames, times)

    def _render_window_raw(self, frames: np.ndarray,
                           times: Sequence[float]) -> np.ndarray:
        x, (h, w) = pad_to_multiple(np.asarray(frames, np.float32), 4,
                                    self.bucket)
        hp, wp = x.shape[1], x.shape[2]
        with torch.inference_mode():
            xt = torch.from_numpy(x[None]).to(self.device)
            t = torch.as_tensor(np.asarray(times, np.float32),
                                device=self.device)
            out = self.model(xt, t, out_size=(hp * self.scale,
                                              wp * self.scale))
            out = out[:, 0, :h * self.scale, :w * self.scale].cpu().numpy()
        return out

    def _render_window_ensemble(self, frames: np.ndarray,
                                times: Sequence[float]) -> np.ndarray:
        """Average over the 8 dihedral transforms (flips + transpose)."""
        acc = None
        for k in range(8):
            f = frames
            if k & 1:
                f = f[:, :, ::-1]
            if k & 2:
                f = f[:, ::-1]
            if k & 4:
                f = np.transpose(f, (0, 2, 1, 3))
            o = self._render_window_raw(np.ascontiguousarray(f), times)
            if k & 4:
                o = np.transpose(o, (0, 2, 1, 3))
            if k & 2:
                o = o[:, ::-1]
            if k & 1:
                o = o[:, :, ::-1]
            acc = o if acc is None else acc + o
        return acc / 8.0

    def render_sequence(self, frames: np.ndarray,
                        n_times: int = 8) -> List[np.ndarray]:
        """Stream a sequence (T, H, W, 3) through overlapping frame pairs,
        ``n_times`` frames per pair at times i / n_times. Returns a list of
        (n_times, H*scale, W*scale, 3)."""
        times = [i / n_times for i in range(n_times)]
        return [self._render_window_raw(frames[i:i + 2], times)
                for i in range(frames.shape[0] - 1)]
