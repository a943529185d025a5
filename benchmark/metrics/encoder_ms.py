"""Device ms per replayed window in the port's stage ``encode`` (its stage
marks, read from the card's own timer inside the graph; ``marks.py``).
Reads ``encoder_ms.serve``."""

from benchmark import marks


def read(outcome, card):
    return marks.stage_ms(outcome, "encode")
