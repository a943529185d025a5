"""Warp-grid construction (port of ``stif_tpu/ops/warp.py::warp_grid``)."""

from __future__ import annotations

import numpy as np
import torch


def _base_grid(h: int, w: int, device=None) -> torch.Tensor:
    """(h, w, 2) grid of ``linspace(-1, 1)`` coords, channel order (x, y)."""
    gx = np.linspace(-1.0, 1.0, w, dtype=np.float64)
    gy = np.linspace(-1.0, 1.0, h, dtype=np.float64)
    g = np.stack(np.meshgrid(gx, gy, indexing="xy"), axis=-1)
    return torch.from_numpy(g.astype(np.float32)).to(device)


def warp_grid(flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp sampling grid for ``flow`` (B, H, W, 2) pixel
    displacements (x, y): the align_corners=True base lattice plus the flow
    normalised by the flow's *own* dims ((W-1)/2, (H-1)/2). Returns
    (B, H, W, 2) in (x, y) order."""
    _, H, W, _ = flow.shape
    fn = torch.stack([flow[..., 0] / ((W - 1.0) / 2.0),
                      flow[..., 1] / ((H - 1.0) / 2.0)], dim=-1)
    return _base_grid(H, W, flow.device)[None] + fn
