"""LIIF cell-centre coordinates (port of ``stif_tpu/ops/coords.py``)."""

from __future__ import annotations

import numpy as np
import torch


def make_coord(shape, ranges=None, flatten: bool = True, device=None,
               dtype=torch.float32) -> torch.Tensor:
    """Coordinates at grid-cell centres, channel order = axis order of
    ``shape`` (``(y, x)`` for ``(H, W)``).

    For each axis with ``n = shape[i]`` and range ``(v0, v1)`` (default
    ``(-1, 1)``): ``v0 + r + 2*r*arange(n)`` with ``r = (v1 - v0) / (2n)``,
    computed in float64 and rounded once to float32, as the JAX package does.
    Returns ``(*shape, len(shape))`` or ``(prod(shape), len(shape))``.
    """
    seqs = []
    for i, n in enumerate(shape):
        v0, v1 = (-1.0, 1.0) if ranges is None else ranges[i]
        r = (v1 - v0) / (2 * n)
        seqs.append(v0 + r + (2 * r) * np.arange(n, dtype=np.float64))
    grids = np.meshgrid(*seqs, indexing="ij")
    ret = np.stack(grids, axis=-1).astype(np.float32)
    if flatten:
        ret = ret.reshape(-1, ret.shape[-1])
    return torch.from_numpy(ret).to(device=device, dtype=dtype)


def make_coord_demo(shape, new_shape, center, device=None) -> torch.Tensor:
    """Zoom-window coordinates: a ``new_shape`` crop of the ``shape`` grid's
    cell lattice centred at ``center`` (normalised (y, x)), shifted right /
    down if it underflows -1. Computed in float64 and rounded once to
    float32. Returns ``(prod(new_shape), len(new_shape))``.
    """
    interval = (2.0 / shape[0], 2.0 / shape[1])
    seqs = []
    for i, n in enumerate(new_shape):
        if n % 2 == 0:
            v0 = -interval[i] * (n / 2) + interval[i] / 2 + center[i]
        else:
            v0 = -interval[i] * (n // 2) + center[i]
        seq = v0 + interval[i] * np.arange(n, dtype=np.float64)
        if seq.min() < -1:
            seq = seq + (-1 - seq.min())
        seqs.append(seq)
    grids = np.meshgrid(*seqs, indexing="ij")
    ret = np.stack(grids, axis=-1).astype(np.float32)
    return torch.from_numpy(ret.reshape(-1, len(new_shape))).to(device)
