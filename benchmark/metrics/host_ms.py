"""Host ms per steady window or step in the port's own host work: its
spans ``marks.HOST_WORK`` (serving: the padding, the pin and upload, the
static-input copy and the copy of the frames into their host array;
training: the batch's pin and upload, the static-input copy and the logs'
copy), not the waits for the device and not the graph's launch. Reads
``host_ms.serve`` and ``host_ms.train``."""

from benchmark import marks


def read(outcome, card):
    return marks.host_ms(outcome)
