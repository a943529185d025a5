"""Channels-last pixel shuffle (port of ``stif_tpu/ops/pixel_shuffle.py``)."""

from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H, W, C*r*r) -> (B, H*r, W*r, C) with torch's channel order:
    input channel ``c*r*r + i*r + j`` lands at offset ``(i, j)`` of ``c``."""
    B, H, W, Crr = x.shape
    C = Crr // (r * r)
    x = x.reshape(B, H, W, C, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, H * r, W * r, C)
