"""The three ``LIIF_train`` SIREN nets' roofline bound over the slice's
units (``roofline/liif_train.py``: 200 -> 128, 329 -> 4, 652 -> 27) over
the device time of the fused SIREN kernel, in %; None where the kernel did
not run or the units hold no such net. Reads
``siren_liif_train_roofline.serve``."""

from benchmark import harness
from benchmark.roofline import liif_train


def read(outcome, card):
    return harness.roofline(outcome.slice, liif_train.work_of, card,
                            "siren_fused_kernel")
