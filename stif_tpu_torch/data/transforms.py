"""Data augmentation: joint flip / rotate for frame stacks (port of
``stif_tpu/data/transforms.py``).

``augment`` / ``augment_a`` of the reference (``codes/data/util.py:92-140``):
hflip, vflip and a 90-degree rotation applied alike to every frame of a
sample (and across LQ / GT pairs).
"""

from __future__ import annotations

import random
from typing import List

import numpy as np


def augment_stack(imgs: List[np.ndarray], hflip: bool = True,
                  rot: bool = True, rng: random.Random = random):
    """imgs: list of (..., H, W, C) arrays, augmented jointly."""
    do_h = hflip and rng.random() < 0.5
    do_v = rot and rng.random() < 0.5
    do_r = rot and rng.random() < 0.5

    def aug(img):
        if do_h:
            img = img[..., :, ::-1, :]
        if do_v:
            img = img[..., ::-1, :, :]
        if do_r:
            img = np.swapaxes(img, -3, -2)
        return np.ascontiguousarray(img)

    return [aug(im) for im in imgs]
