"""Batch collation, including the arbitrary-scale degradation collate (port
of ``stif_tpu/data/collate.py``).

``collate_function2`` of the reference (``codes/data/__init__.py:124-154``):
the batch-level random-scale augmentation that trains the continuous
decoder: draw d in U(2, 4), crop GT_size = floor(64*d), LQ = bicubic
1/(2d) downscale (-> 32 px), GT = bicubic 1/2 downscale (-> 32*d px), joint
flip / rot, BGR -> RGB. ``scale_buckets`` quantizes d to a finite set of
scales, as the JAX package does. Outputs stay NHWC float32.
"""

from __future__ import annotations

import math
import random
from typing import Optional, Sequence

import numpy as np


def collate_fixed(samples):
    """Stack dict samples with identical shapes (Vimeo7 / Adobe fixed
    scale). Times stay per sample, (B, nt): Adobe draws a random time per
    sample and the model conditions pe per batch element."""
    out = {}
    for k in samples[0]:
        if k == "key":
            out[k] = [s[k] for s in samples]
        else:
            out[k] = np.stack([s[k] for s in samples])
    return out


def collate_arbitrary_scale(samples, lq_size: int = 64,
                            scale_buckets: Optional[Sequence[float]] = None,
                            rng: random.Random = random):
    """samples: list of ``AdobeArbitraryDataset`` items (raw uint8 BGR).

    Returns {'LQs': (B, 2, h, w, 3), 'GT': (B, 3, H, W, 3), 'times': (B, 3)}
    RGB float32. As in the reference, the 3 sampled times differ per sample
    while the batch shares one crop and scale.
    """
    from stif_tpu_torch.data.datasets import host_imresize
    from stif_tpu_torch.data.transforms import augment_stack

    if scale_buckets:
        d = rng.choice(list(scale_buckets))
    else:
        d = rng.uniform(2, 4)
    gt_size = int(math.floor(lq_size * d))

    h0, w0 = samples[0]["LQs_raw"][0].shape[:2]
    x = rng.randint(0, max(0, min(h0, w0) - gt_size))
    y = rng.randint(0, max(0, max(h0, w0) - gt_size))

    def crop(img):
        if img.shape[0] == h0 and h0 <= w0:
            return img[x:x + gt_size, y:y + gt_size]
        return img[y:y + gt_size, x:x + gt_size]

    lq_crops = np.stack([
        np.stack([crop(im) for im in s["LQs_raw"]]) for s in samples
    ])  # (B, 2, g, g, 3) uint8
    gt_crops = np.stack([
        np.stack([crop(im) for im in s["GT_raw"]]) for s in samples
    ])  # (B, 3, g, g, 3)
    lqs = host_imresize(lq_crops.astype(np.float32), 1.0 / (2 * d))
    gts = host_imresize(gt_crops.astype(np.float32), 0.5)
    lqs /= 255.0
    gts /= 255.0

    lqs, gts = augment_stack([lqs, gts], True, True, rng)
    lqs = np.ascontiguousarray(lqs[..., ::-1])  # BGR -> RGB
    gts = np.ascontiguousarray(gts[..., ::-1])
    times = np.stack([s["times"] for s in samples])  # (B, 3)
    return {"LQs": lqs.astype(np.float32), "GT": gts.astype(np.float32),
            "times": times, "shape": gts.shape[2:4]}
