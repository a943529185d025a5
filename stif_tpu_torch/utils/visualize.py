"""Flow visualization, the Middlebury color wheel (the port's own copy of
``stif_tpu/utils/visualize.py``; numpy).

Parity target: ``flow_to_image`` / ``compute_color`` / ``make_color_wheel``
(``codes/myutils.py:595-726``).
"""

from __future__ import annotations

import numpy as np


def make_color_wheel() -> np.ndarray:
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


def compute_color(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    h, w = u.shape
    img = np.zeros((h, w, 3))
    nan_idx = np.isnan(u) | np.isnan(v)
    u = np.where(nan_idx, 0, u)
    v = np.where(nan_idx, 0, v)
    wheel = make_color_wheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1) + 1
    k0 = np.floor(fk).astype(int)
    k1 = k0 + 1
    k1[k1 == ncols + 1] = 1
    f = fk - k0
    for i in range(3):
        tmp = wheel[:, i]
        col0 = tmp[k0 - 1] / 255
        col1 = tmp[k1 - 1] / 255
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] *= 0.75
        img[:, :, i] = np.floor(255 * col * (1 - nan_idx)).astype(np.uint8)
    return img


def flow_to_image(flow: np.ndarray) -> np.ndarray:
    """(H, W, 2) flow -> uint8 RGB visualization."""
    u = flow[:, :, 0].astype(np.float64)
    v = flow[:, :, 1].astype(np.float64)
    UNKNOWN = 1e7
    bad = (np.abs(u) > UNKNOWN) | (np.abs(v) > UNKNOWN)
    u = np.where(bad, 0, u)
    v = np.where(bad, 0, v)
    rad = np.sqrt(u ** 2 + v ** 2)
    maxrad = max(-1.0, float(rad.max()))
    eps = np.finfo(float).eps
    u = u / (maxrad + eps)
    v = v / (maxrad + eps)
    img = compute_color(u, v)
    img[bad] = 0
    return np.uint8(img)
