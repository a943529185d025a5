"""Backward warping and warp-grid construction (port of
``stif_tpu/ops/warp.py``).

The reference's ``warp`` / ``warpgrid`` / ``warpgrid2``
(``codes/models/modules/warplayer.py:9-47``). Flows are NHWC with
``flow[..., 0]`` the horizontal (x) and ``flow[..., 1]`` the vertical (y)
displacement in pixels. The reference's two normalisations are kept:
``backward_warp`` divides the flow by the *input image's* dims,
``warp_grid`` by the *flow's own* dims. Both add the flow to the
``align_corners=True`` lattice ``linspace(-1, 1, n)``.
"""

from __future__ import annotations

import numpy as np
import torch

from stif_tpu_torch.ops.grid_sample import grid_sample


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


def backward_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp ``x`` (B, H, W, C) by ``flow`` (B, Hf, Wf, 2): the flow
    normalised by the *input's* dims, bilinear sampling with ``border``
    padding and ``align_corners=True`` (the reference's ``warp``).
    Returns (B, Hf, Wf, C)."""
    _, Hf, Wf, _ = flow.shape
    fn = torch.stack([flow[..., 0] / ((x.shape[2] - 1.0) / 2.0),
                      flow[..., 1] / ((x.shape[1] - 1.0) / 2.0)], dim=-1)
    g = _base_grid(Hf, Wf, flow.device)[None] + fn
    return grid_sample(x, g, mode="bilinear", padding_mode="border",
                       align_corners=True)


def warp_grid_coords(coords: torch.Tensor, flow: torch.Tensor, h: int,
                     w: int) -> torch.Tensor:
    """A flow added to a flat list of coordinates (the reference's
    ``warpgrid2``): ``coords`` (B, Q, 2) in (y, x) order, ``flow`` (B, Q, 2)
    pixel displacements in (x, y) order, normalised by (w, h). Returns the
    (B, Q, 2) grid in (y, x) order, clamped to +-(1 - 1e-6)."""
    fn = torch.stack([flow[..., 0] / ((w - 1.0) / 2.0),
                      flow[..., 1] / ((h - 1.0) / 2.0)], dim=-1)
    return (coords + fn.flip(-1)).clamp(-1 + 1e-6, 1 - 1e-6)
