"""Batch evaluation harnesses (port of ``stif_tpu/runtime/eval.py``).

Six protocols, each over folders of ground-truth HR frames; the first four
need only ``pipeline.render_window``, the TMNet ones
``pipeline.render_window_tmnet``:

- ``eval_space_time_sr``: the Vid4 x4 space-time SR protocol: every 2nd frame
  downscaled as LR input, query times t in {0.5, 0}, Y-channel
  MATLAB-convention PSNR/SSIM;
- ``eval_adobe_4x`` / ``eval_adobe_liif4x``: the Adobe x16-spatial LIIF
  protocols over frame pairs (i, i+4);
- ``eval_temporal_x8``: the Adobe/GoPro x8 temporal protocol with a per-time
  PSNR breakdown;
- ``eval_adobe_tmnet`` / ``eval_vid4_tmnet``: the Adobe and Vid4 protocols
  over 4-frame TMNet windows, whose interleaved fixed-x4 output is scored
  where it lands on ground-truth frames.

Each protocol scores one clip in a private helper that takes the frames as an
array (T, H, W, 3), so in-memory clips can be scored without reading files.
The LR frames are made on the host by the native MATLAB-bicubic resize
(``data.native.host_imresize``), as in the JAX package.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from stif_tpu_torch.data.native import host_imresize
from stif_tpu_torch.utils.metrics import (
    bgr2ycbcr,
    calculate_psnr,
    calculate_ssim,
)


@dataclass
class EvalResult:
    psnr: Dict[str, float] = field(default_factory=dict)
    ssim: Dict[str, float] = field(default_factory=dict)
    per_time_psnr: List[float] = field(default_factory=list)
    avg_time_s: float = 0.0
    # "MID PSNR/SSIM" breakdown of the adobe_4x / liif4x protocols
    mid_psnr: float = 0.0
    mid_ssim: float = 0.0
    # per-query-time split (t = 0.5 "center" and t = 0 "key" averages)
    psnr_by_time: Dict[float, float] = field(default_factory=dict)
    ssim_by_time: Dict[float, float] = field(default_factory=dict)

    @property
    def mean_psnr(self) -> float:
        return float(np.mean(list(self.psnr.values()))) if self.psnr else 0.0

    @property
    def mean_ssim(self) -> float:
        return float(np.mean(list(self.ssim.values()))) if self.ssim else 0.0


def _load_frames(folder: str) -> np.ndarray:
    """Read a folder of frames -> (T, H, W, 3) float32 RGB in [0, 1]."""
    import cv2

    names = sorted(
        n for n in os.listdir(folder)
        if n.lower().endswith((".png", ".jpg", ".jpeg", ".bmp"))
    )
    imgs = []
    for n in names:
        img = cv2.imread(os.path.join(folder, n), cv2.IMREAD_UNCHANGED)
        img = img.astype(np.float32) / 255.0
        imgs.append(img[..., [2, 1, 0]])  # BGR -> RGB
    return np.stack(imgs)


def _folders(gt_root: str, folders: Optional[Sequence[str]]):
    return folders or sorted(
        d for d in os.listdir(gt_root)
        if os.path.isdir(os.path.join(gt_root, d))
    )


def _crop(gt: np.ndarray, multiple: int) -> np.ndarray:
    """Crop (T, H, W, 3) so H and W are multiples of ``multiple``."""
    H = gt.shape[1] - gt.shape[1] % multiple
    W = gt.shape[2] - gt.shape[2] % multiple
    return gt[:, :H, :W]


def _crop_and_degrade(gt: np.ndarray, multiple: int, downscale: float):
    """(gt, lr): gt cropped to multiples of ``multiple``, lr its
    MATLAB-bicubic ``downscale``."""
    gt = _crop(gt, multiple)
    return gt, host_imresize(gt, downscale)


def append_logfile(logfile: str, epoch_id, iter_id, cost_s: float,
                   psnr: float, ssim: float) -> None:
    """Append an eval line in the reference harnesses' logfile format."""
    with open(logfile, "a") as f:
        print(
            "Date: {0}s, Epoch: [{1}/{2}], Cost time: {3:.2f}s, "
            "Val_PSNR: {4:.2f}, Val_SSIM: {5:.4f}".format(
                time.strftime("%Y-%m-%d %H:%M:%S", time.localtime()),
                epoch_id, iter_id, cost_s, psnr, ssim),
            file=f,
        )


def _metric_pair(pred, ref, y_channel: bool):
    """(PSNR, SSIM) of two RGB [0, 1] images, on Y or on full RGB."""
    if y_channel:
        pred = bgr2ycbcr(pred[..., ::-1].astype(np.float32))
        ref = bgr2ycbcr(ref[..., ::-1].astype(np.float32))
    return (calculate_psnr(pred * 255, ref * 255),
            calculate_ssim(pred * 255, ref * 255))


def _score_space_time_sr(pipeline, gt: np.ndarray, times=(0.5, 0.0),
                         y_channel: bool = True, downscale: float = 0.25):
    """One clip (T, H, W, 3) under the space-time SR protocol. Returns
    (scores, seconds, calls): ``scores`` lists (t, psnr, ssim) per scored
    frame; ``seconds`` and ``calls`` are the time in and the number of
    ``render_window`` calls."""
    m = int(round(1 / downscale))
    gt, lr = _crop_and_degrade(gt, m * 2, downscale)
    inputs = lr[::2]
    scores, seconds, calls = [], 0.0, 0
    for i in range(inputs.shape[0] - 1):
        t0 = time.perf_counter()
        out = pipeline.render_window(inputs[i:i + 2], list(times))
        seconds += time.perf_counter() - t0
        calls += 1
        for ti, t in enumerate(times):
            gt_idx = 2 * i if t == 0.0 else int(round(2 * i + 2 * t))
            if gt_idx >= gt.shape[0]:
                continue
            scores.append((t,) + _metric_pair(np.clip(out[ti], 0, 1),
                                              gt[gt_idx], y_channel))
    return scores, seconds, calls


def eval_space_time_sr(pipeline, gt_root: str,
                       folders: Optional[Sequence[str]] = None,
                       times=(0.5, 0.0), y_channel: bool = True,
                       downscale: float = 0.25) -> EvalResult:
    """Vid4-style protocol: GT folders of HR frames; LR input = MATLAB-bicubic
    downscale of every 2nd frame; the model's frames at the given query times
    against GT (t = 0.5 -> the skipped odd frames, t = 0 -> the even frames).
    """
    res = EvalResult()
    t_total, n_calls = 0.0, 0
    by_t = {t: [] for t in times}
    for name in _folders(gt_root, folders):
        scores, seconds, calls = _score_space_time_sr(
            pipeline, _load_frames(os.path.join(gt_root, name)), times,
            y_channel, downscale)
        t_total += seconds
        n_calls += calls
        for t, p, s in scores:
            by_t[t].append((p, s))
        res.psnr[name] = float(np.mean([p for _, p, _ in scores]))
        res.ssim[name] = float(np.mean([s for _, _, s in scores]))
    res.psnr_by_time = {t: float(np.mean([p for p, _ in v]))
                        for t, v in by_t.items() if v}
    res.ssim_by_time = {t: float(np.mean([s for _, s in v]))
                        for t, v in by_t.items() if v}
    res.avg_time_s = t_total / max(n_calls, 1)
    return res


def _score_adobe(pipeline, gt: np.ndarray, times, gt_offset: int,
                 downscale: float, stride: int, y_channel: bool):
    """One clip under the Adobe LIIF protocols: input pair (i, i+4)
    downscaled, ``times`` against GT frames i + gt_offset + index. Returns
    (time index, psnr, ssim) per scored frame."""
    m = int(round(1 / downscale))
    gt, lr = _crop_and_degrade(gt, 4 * m, downscale)
    scores = []
    i = 0
    while i + 4 < gt.shape[0]:
        out = pipeline.render_window(np.stack([lr[i], lr[i + 4]]), times)
        for ti in range(len(times)):
            scores.append((ti,) + _metric_pair(
                np.clip(out[ti], 0, 1), gt[i + gt_offset + ti], y_channel))
        i += stride
    return scores


def _eval_adobe(pipeline, gt_root, folders, times, gt_offset, downscale,
                stride, y_channel):
    """The folder loop both Adobe LIIF protocols share. Returns (result with
    per-folder means and the run's seconds, every score)."""
    res = EvalResult()
    every = []
    t_start = time.time()
    for name in _folders(gt_root, folders):
        scores = _score_adobe(
            pipeline, _load_frames(os.path.join(gt_root, name)), times,
            gt_offset, downscale, stride, y_channel)
        every += scores
        res.psnr[name] = float(np.mean([p for _, p, _ in scores]))
        res.ssim[name] = float(np.mean([s for _, _, s in scores]))
    res.avg_time_s = time.time() - t_start
    return res, every


def eval_adobe_4x(pipeline, gt_root: str,
                  folders: Optional[Sequence[str]] = None,
                  downscale: float = 1 / 16, stride: int = 4,
                  y_channel: bool = False,
                  logfile: Optional[str] = None,
                  epoch_id: int = 0, iter_id: int = 0) -> EvalResult:
    """``test_metric_adobe_4x`` LIIF protocol: x16 spatial SR — input pair
    (i, i+4) downscaled 1/16, query times {0, 1/4, 1/2, 3/4, 1} against GT
    frames i..i+4 at full resolution, full-RGB PSNR/SSIM, "MID" = the last
    (t = 1) index, window stride 4.

    The pipeline must be built with ``scale`` matching ``1/downscale``.
    Frame dims that are not multiples of ``4/downscale`` are cropped down
    (the reference resizes them up instead), so metrics on such datasets are
    not one-to-one comparable with reference-reported numbers."""
    res, every = _eval_adobe(pipeline, gt_root, folders,
                             [i / 4 for i in range(5)], 0, downscale, stride,
                             y_channel)
    mid = [(p, s) for ti, p, s in every if ti == 4]
    res.mid_psnr = float(np.mean([p for p, _ in mid])) if mid else 0.0
    res.mid_ssim = float(np.mean([s for _, s in mid])) if mid else 0.0
    if logfile:
        append_logfile(logfile, epoch_id, iter_id, res.avg_time_s,
                       res.mean_psnr, res.mean_ssim)
    return res


def eval_adobe_liif4x(pipeline, gt_root: str,
                      folders: Optional[Sequence[str]] = None,
                      downscale: float = 1 / 16, stride: int = 4,
                      y_channel: bool = True,
                      logfile: Optional[str] = None,
                      epoch_id: int = 0, iter_id: int = 0) -> EvalResult:
    """``test_metric_adobe_liif4x`` LIIF protocol: like ``eval_adobe_4x`` but
    only the three interior times {1/4, 1/2, 3/4} against GT frames
    i+1..i+3, Y-channel metrics. Shares its crop-instead-of-resize
    deviation."""
    res, _ = _eval_adobe(pipeline, gt_root, folders,
                         [i / 4 for i in range(1, 4)], 1, downscale, stride,
                         y_channel)
    res.mid_psnr = res.mean_psnr
    res.mid_ssim = res.mean_ssim
    if logfile:
        append_logfile(logfile, epoch_id, iter_id, res.avg_time_s,
                       res.mean_psnr, res.mean_ssim)
    return res


def _score_adobe_tmnet(pipeline, gt_full: np.ndarray):
    """One clip under the Adobe TMNet protocol. Returns (output index, psnr,
    ssim) per scored frame."""
    gt_full = _crop(gt_full, 32)
    lr = host_imresize(gt_full, 1 / 8)
    gt = host_imresize(gt_full, 1 / 2)
    times = [i / 6 for i in range(1, 6)]
    scores = []
    for i in range(0, gt.shape[0] - 18, 18):
        out = pipeline.render_window_tmnet(
            np.stack([lr[i], lr[i + 6], lr[i + 12], lr[i + 18]]), times)
        for j in range(min(out.shape[0] - 1, 18)):
            scores.append((j,) + _metric_pair(np.clip(out[j], 0, 1),
                                              gt[i + j], y_channel=False))
    return scores


def eval_adobe_tmnet(pipeline, gt_root: str,
                     folders: Optional[Sequence[str]] = None,
                     logfile: Optional[str] = None,
                     epoch_id: int = 0, iter_id: int = 0) -> EvalResult:
    """``test_metric_adobe_tmnet``: 4-frame TMNet windows (i, i+6, i+12,
    i+18) downscaled 1/8; GT = the 18 frames i..i+17 at 1/2 scale (x4
    model); interior times {1/6..5/6} per pair, so the interleaved output
    covers every GT frame; full-RGB metrics, "MID" = output index 4, window
    stride 18."""
    res = EvalResult()
    mid = []
    t_start = time.time()
    for name in _folders(gt_root, folders):
        scores = _score_adobe_tmnet(
            pipeline, _load_frames(os.path.join(gt_root, name)))
        mid += [(p, s) for j, p, s in scores if j == 4]
        res.psnr[name] = float(np.mean([p for _, p, _ in scores]))
        res.ssim[name] = float(np.mean([s for _, _, s in scores]))
    res.mid_psnr = float(np.mean([p for p, _ in mid])) if mid else 0.0
    res.mid_ssim = float(np.mean([s for _, s in mid])) if mid else 0.0
    res.avg_time_s = time.time() - t_start
    if logfile:
        append_logfile(logfile, epoch_id, iter_id, res.avg_time_s,
                       res.mean_psnr, res.mean_ssim)
    return res


def _score_vid4_tmnet(pipeline, gt: np.ndarray):
    """One clip under the Vid4 TMNet protocol. Returns (psnr, ssim) per
    scored frame."""
    gt, lr = _crop_and_degrade(gt, 16, 0.25)
    inputs = lr[::2]
    times = [i / 8 for i in range(1, 8)]
    scores = []
    for i in range(inputs.shape[0] - 3):
        out = pipeline.render_window_tmnet(inputs[i:i + 4], times)
        for j in range(0, out.shape[0] - 1, 4):
            gt_idx = 2 * i + j // 4
            if gt_idx < gt.shape[0]:
                scores.append(_metric_pair(np.clip(out[j], 0, 1), gt[gt_idx],
                                           y_channel=True))
    return scores


def eval_vid4_tmnet(pipeline, gt_root: str,
                    folders: Optional[Sequence[str]] = None,
                    logfile: Optional[str] = None,
                    epoch_id: int = 0, iter_id: int = 0) -> EvalResult:
    """``test_metric_full_tmnet``: Vid4 with 4-frame TMNet windows of every
    2nd LR frame, times {1/8..7/8}; of the interleaved outputs only j in
    {0, 4, 8, ...} land on GT frames (2i + j/4); Y-channel metrics; window
    stride 1."""
    res = EvalResult()
    t_start = time.time()
    for name in _folders(gt_root, folders):
        scores = _score_vid4_tmnet(
            pipeline, _load_frames(os.path.join(gt_root, name)))
        res.psnr[name] = float(np.mean([p for p, _ in scores]))
        res.ssim[name] = float(np.mean([s for _, s in scores]))
    res.avg_time_s = time.time() - t_start
    if logfile:
        append_logfile(logfile, epoch_id, iter_id, res.avg_time_s,
                       res.mean_psnr, res.mean_ssim)
    return res


def _score_temporal_x8(pipeline, gt: np.ndarray, y_channel: bool = True,
                       downscale: float = 0.25):
    """One clip under the x8 temporal protocol: input frames (i, i+8)
    downscaled, all 8 times i/8 against GT frames i..i+7. Returns
    (time index, psnr, ssim) per scored frame."""
    gt, lr = _crop_and_degrade(gt, int(round(1 / downscale)), downscale)
    times = [i / 8 for i in range(8)]
    scores = []
    for i in range(0, gt.shape[0] - 8, 8):
        out = pipeline.render_window(np.stack([lr[i], lr[i + 8]]), times)
        for ti in range(8):
            scores.append((ti,) + _metric_pair(np.clip(out[ti], 0, 1),
                                               gt[i + ti], y_channel))
    return scores


def eval_temporal_x8(pipeline, gt_root: str,
                     folders: Optional[Sequence[str]] = None,
                     y_channel: bool = True,
                     downscale: float = 0.25) -> EvalResult:
    """Adobe/GoPro-style x8 temporal protocol: input frames (i, i+8)
    downscaled; all 8 intermediate times, with a per-time-index PSNR
    breakdown."""
    res = EvalResult()
    per_time = [[] for _ in range(8)]
    for name in _folders(gt_root, folders):
        scores = _score_temporal_x8(
            pipeline, _load_frames(os.path.join(gt_root, name)), y_channel,
            downscale)
        for ti, p, _ in scores:
            per_time[ti].append(p)
        res.psnr[name] = float(np.mean([p for _, p, _ in scores]))
        res.ssim[name] = float(np.mean([s for _, _, s in scores]))
    res.per_time_psnr = [float(np.mean(p)) if p else 0.0 for p in per_time]
    return res
