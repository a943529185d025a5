"""The measured window's FLOPs, counted from the shapes of the
``LIIF_train`` windows it ran (``roofline/liif_train.py``: the flagship's
encoder and the three nets), per second of the window over the card's dense
TF32 peak, in %; None where the window ran no such unit. Reads
``mfu_liif_train.serve``."""

from benchmark.roofline import liif_train
from benchmark.roofline.peaks import peak


def read(outcome, card):
    w = outcome.window
    flops = sum(n * liif_train.flops(u) for u, n in w["shapes"]
                if u["model"] == "liif_train")
    if not flops:
        return None
    return 100.0 * flops / w["seconds"] / peak(card)["flops"]
