"""The three SIREN nets' roofline bound over the slice's units
(``roofline/siren.py``) over the device time of the fused SIREN kernel, in
%; None where the kernel did not run (a train step runs the plain nets)."""

from benchmark import harness
from benchmark.roofline import siren


def read(outcome, card):
    return harness.roofline(outcome.slice, siren.work_of, card,
                            "siren_fused_kernel")
