"""Device idle share of a traced slice (whole windows or steps): the share
of its wall time in which no kernel, copy or fill ran (the union of their
intervals), in %. Reads ``idle_share.serve`` and ``idle_share.train``."""


def read(outcome, card):
    s = outcome.slice
    return 100.0 * (1.0 - s["busy_s"] / s["wall_s"])
