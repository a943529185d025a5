"""3x3 overlap-add fold (port of ``stif_tpu/ops/fold.py``): the assembly of
the train-variant decoder's overlapping 3x3 RGB patches,
``F.fold(kernel_size=3, padding=1)`` on channels-last tensors."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def fold3x3(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C*9) -> (B, H, W, C) overlap-add.

    Input channel ``c*9 + i*3 + j`` is the patch value at offset
    ``(i-1, j-1)`` from the query pixel, as torch's fold lays it out:
    ``out[y, x] = sum_{i,j} patch[y - (i-1), x - (j-1), c, i, j]``, nine
    shifted slices of a zero-padded copy."""
    B, H, W, C9 = x.shape
    C = C9 // 9
    p = F.pad(x.reshape(B, H, W, C, 3, 3), (0, 0, 0, 0, 0, 0, 1, 1, 1, 1))
    out = None
    for i in range(3):
        for j in range(3):
            part = p[:, 2 - i:2 - i + H, 2 - j:2 - j + W, :, i, j]
            out = part if out is None else out + part
    return out
