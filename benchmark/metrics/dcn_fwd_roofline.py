"""Every DCN forward's roofline bound over the slice's units
(``roofline/dcn.py``, each call once) over the device time of the DCN
forward kernel, in %."""

from benchmark import harness
from benchmark.roofline import dcn


def read(outcome, card):
    return harness.roofline(outcome.slice, dcn.forward_of, card,
                            "dcn_forward_kernel")
