"""Training losses (port of ``stif_tpu/train/losses.py``).

``CharbonnierLoss`` (sum-reduced ``sqrt(d^2 + eps)``, eps 1e-6) and the
Gaussian / Laplacian-pyramid ``LapLoss`` of the reference
(``codes/models/modules/loss.py:7-77``), plus the l1 / l2 / cb / lp choice
of ``VideoSRBaseModel``. Images are channels-last (..., H, W, C).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def charbonnier_loss(x: torch.Tensor, y: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """Sum-reduced Charbonnier: sum(sqrt((x-y)^2 + eps))."""
    d = x - y
    return torch.sum(torch.sqrt(d * d + eps))


@lru_cache(maxsize=8)
def _gauss_kernel(size: int = 5, sigma: float = 2.0) -> np.ndarray:
    """(size, size) kernel built as the reference builds it, including its
    exp(...)**2 quirk (loss.py:23), which halves the variance."""
    grid = np.mgrid[0:size, 0:size].T.astype(np.float32)
    g = np.exp((grid - size // 2) ** 2 / (-2 * sigma ** 2)) ** 2
    kernel = np.sum(g, axis=2)
    kernel /= kernel.sum()
    return kernel.astype(np.float32)


def _conv_gauss(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Depthwise gaussian blur with replicate padding. img: NHWC."""
    p = kernel.shape[0] // 2
    C = img.shape[-1]
    x = F.pad(img.permute(0, 3, 1, 2), (p, p, p, p), mode="replicate")
    w = torch.as_tensor(kernel, dtype=img.dtype, device=img.device)
    w = w[None, None].expand(C, 1, *kernel.shape)
    return F.conv2d(x, w, groups=C).permute(0, 2, 3, 1)


def _avg_pool2(img: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(img.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def lap_loss(x: torch.Tensor, y: torch.Tensor, max_levels: int = 5,
             k_size: int = 5, sigma: float = 2.0) -> torch.Tensor:
    """Laplacian pyramid L1 loss (mean-reduced per level, summed). NHWC."""
    kernel = _gauss_kernel(k_size, sigma)

    def pyramid(img):
        pyr, cur = [], img
        for _ in range(max_levels):
            filt = _conv_gauss(cur, kernel)
            pyr.append(cur - filt)
            cur = _avg_pool2(filt)
        pyr.append(cur)
        return pyr

    return sum(torch.mean(torch.abs(a - b))
               for a, b in zip(pyramid(x), pyramid(y)))


def _reduced(fn, reduction: str):
    """``fn`` with its reduction over the batch named: 'sum' or 'mean'.
    Data-parallel training reads it to rebuild the global gradient from
    DDP's average over ranks."""
    def criterion(x, y):
        return fn(x, y)

    criterion.reduction = reduction
    return criterion


def make_pixel_criterion(name: str):
    """'l1' | 'l2' | 'cb' | 'lp' -> loss fn (sum / mean as the reference's
    torch losses reduce; the fn's ``reduction`` attribute says which)."""
    if name == "l1":
        return _reduced(lambda x, y: torch.mean(torch.abs(x - y)), "mean")
    if name == "l2":
        return _reduced(lambda x, y: torch.mean((x - y) ** 2), "mean")
    if name == "cb":
        return _reduced(charbonnier_loss, "sum")
    if name == "lp":
        return _reduced(lap_loss, "mean")
    raise ValueError(f"unknown pixel criterion '{name}'")
