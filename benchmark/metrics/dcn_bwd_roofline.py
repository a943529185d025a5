"""Every DCN backward's roofline bound over the slice's train steps
(``roofline/dcn.py``) over the device time of the DCN backward kernel and
its weight-gradient sum, in %; None where no backward ran."""

from benchmark import harness
from benchmark.roofline import dcn


def read(outcome, card):
    return harness.roofline(outcome.slice, dcn.backward_of, card,
                            "dcn_backward_kernel", "dcn_wgrad_sum_kernel")
