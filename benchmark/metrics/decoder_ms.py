"""Device ms per replayed window in the port's stage ``decode`` (its stage
marks, read from the card's own timer inside the graph; ``marks.py``).
Reads ``decoder_ms.serve``."""

from benchmark import marks


def read(outcome, card):
    return marks.stage_ms(outcome, "decode")
