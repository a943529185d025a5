"""Device ms per replayed train step in the port's stage
``train.backward`` (its stage marks, read from the card's own timer inside
the graph; ``marks.py``). Reads ``backward_ms.train``."""

from benchmark import marks


def read(outcome, card):
    return marks.stage_ms(outcome, "train.backward")
