"""Host milliseconds in ``cudaGraphLaunch`` per unit (window or train step)
of the slice: the launch of a replayed graph, during which nothing else is
queued; None where the slice launched no graph. Reads
``graph_launch_ms.serve`` and ``graph_launch_ms.train``."""

from benchmark import harness


def read(outcome, card):
    s = outcome.slice
    spent = harness.runtime_s(s, "cudaGraphLaunch")
    return 1e3 * spent / len(s["shapes"]) if spent > 0 else None
