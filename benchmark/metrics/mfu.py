"""The measured window's FLOPs, counted from the shapes of the units it
ran (``roofline/model.py``: a train step three forwards), per second of
the window over the card's dense TF32 peak, in %. Reads ``mfu.serve`` and
``mfu.train``."""

from benchmark import harness


def read(outcome, card):
    return harness.mfu(outcome, card)
