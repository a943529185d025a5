"""The port's accounting: host spans, device stage marks and their tables.

A replayed CUDA graph runs no Python, so nothing on the host can say where
its time goes. Two kinds of record can:

- ``mark(stage, device)``, a device stage mark: a one-thread kernel,
  ``stage_mark_kernel`` (``csrc/stage_marks.cu``), launched on the current
  stream at the stage's start and at its end. The start writes the card's
  ``%globaltimer`` into the stage's slot; the end adds (now - start) to the
  stage's total and 1 to its count. The sums stay on the card in an int64
  table of ``[len(STAGES), 3]``, read by one small copy when asked for
  (``Marks.read``), off the hot path. A graph captured with marks inside
  holds them as kernel nodes, so every replay adds to its program's table
  (``runtime/compiled.py`` allocates one per program, hands it to the
  capture through ``ops/capture.py``'s ``Recording`` and zeroes it after the
  capture: its warm-up and capture add nothing). A mark made outside any
  program goes to one process-wide eager table per device. Being stream
  ordered, the marks need no atomics, and their sums never race a
  double-buffered stream: CUDA events would, since the next replay
  re-records a graph's event nodes before the previous window is fetched.
  On the CPU a mark measures the host's ``perf_counter_ns`` into the same
  kind of table. The kernel shows in a profiler's device trace under its
  name, on the profiler's clock.
- ``span(name)``, a host span: a ``torch.profiler.record_function`` range,
  and an NVTX range once CUDA is up, so on the profiler's clock with the
  device trace, whose ``perf_counter`` seconds and count are added to a
  ``Spans`` table. A window's or a step's spans go into its ``Tally``, which
  carries its sequence number (the ranges' ``args``) and is committed to the
  table of the program the window replays once that is known
  (``ProgramCache.run``): nothing while the call made the program, the
  process-wide eager table when no program runs. A span with no tally goes
  to the eager table.

Model stage marks (every stage but the train step's ``PHASES``) open only
while grad is disabled: a training forward, and the ConvLSTM's
rematerialised forward inside the backward, are the train step's phases.

Both are always on: the marks add a few graph nodes to a window's
thousands, and the spans a few ``perf_counter`` pairs to a call.
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools
import logging
import threading
import time
from typing import Dict, Iterator, Optional

import torch

from stif_tpu_torch.ops import capture as capture_scope
from stif_tpu_torch.ops import cuda_build

# every stage has a slot in a table; a child's name starts with its parent's
STAGES = ("encode", "encode.front", "encode.pcd", "encode.convlstm",
          "encode.trunk", "head",
          "decode", "decode.prep", "decode.ab", "decode.cd",
          "train.forward", "train.backward", "train.update", "train.ema")
SLOT = {s: i for i, s in enumerate(STAGES)}
# the train step's phases, which open with grad enabled too
PHASES = frozenset(s for s in STAGES if s.startswith("train."))
# the host spans the runtime and the train step open
SPANS = ("stage.pad", "stage.upload", "launch.copy_in", "launch.replay",
         "fetch.wait", "fetch.copy", "train.feed", "train.logs")

_local = threading.local()  # .marks: the program table of this thread
_lock = threading.Lock()
_seq = itertools.count()


# ------------------------------------------------------------- device marks

def _library():
    fn = cuda_build.load("stage_marks").stage_mark
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def graph_nodes(raw_graph: int) -> Optional[int]:
    """The node count of a captured graph (``CUDAGraph.raw_cuda_graph()``),
    or None where CUDA refuses the query."""
    fn = cuda_build.load("stage_marks").stage_graph_nodes
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_longlong
    n = fn(raw_graph)
    return n if n >= 0 else None


class Marks:
    """A table of stage totals on ``device``: int64 ``[len(STAGES), 3]``,
    each row (last start, total ns, count) (see the module docstring)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.table = torch.zeros((len(STAGES), 3), dtype=torch.int64,
                                 device=self.device)
        self._host = (None if self.device.type == "cuda"
                      else self.table.numpy())

    def _launch(self, slot: int, end: int) -> None:
        dev = self.device
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = _library()(self.table.data_ptr(), slot, end, stream)
        if err != 0:
            raise RuntimeError(f"stage_mark kernel launch failed: CUDA "
                               f"error {err}")

    def open(self, slot: int) -> None:
        if self._host is None:
            self._launch(slot, 0)
        else:
            self._host[slot, 0] = time.perf_counter_ns()

    def close(self, slot: int) -> None:
        if self._host is None:
            self._launch(slot, 1)
        else:
            row = self._host[slot]
            row[1] += time.perf_counter_ns() - row[0]
            row[2] += 1

    def zero(self) -> None:
        self.table.zero_()

    def read(self) -> Dict[str, dict]:
        """``{stage: {'n': count, 'device_ms': total}}`` of the stages
        opened (on the CPU the host's ms); one copy off the card, ordered
        after the work queued on its current stream."""
        rows = self.table.cpu().tolist()
        return {s: {"n": n, "device_ms": ns / 1e6}
                for s, (_, ns, n) in zip(STAGES, rows) if n}


_eager_marks: Dict[str, Marks] = {}


def _device_key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def eager_marks(device) -> Marks:
    """The process-wide table of the marks made on ``device`` outside any
    program."""
    dev = _device_key(device)
    with _lock:
        if str(dev) not in _eager_marks:
            _eager_marks[str(dev)] = Marks(dev)
        return _eager_marks[str(dev)]


@contextlib.contextmanager
def into_marks(marks: Optional[Marks]) -> Iterator[None]:
    """Send this thread's marks to ``marks`` inside (a program's warm-up,
    and its replays, which on the CPU run the callable again)."""
    before = getattr(_local, "marks", None)
    _local.marks = marks
    try:
        yield
    finally:
        _local.marks = before


def _marks_for(device) -> Marks:
    rec = capture_scope.current()
    if rec is not None and rec.marks is not None:
        return rec.marks
    marks = getattr(_local, "marks", None)
    return marks if marks is not None else eager_marks(device)


@contextlib.contextmanager
def mark(stage: str, device) -> Iterator[None]:
    """Device stage mark around the body, into the table of the program
    being captured or replayed, else the eager table of ``device``. A model
    stage (not one of ``PHASES``) opens only while grad is disabled."""
    slot = SLOT[stage]
    if stage not in PHASES and torch.is_grad_enabled():
        yield
        return
    marks = _marks_for(device)
    marks.open(slot)
    yield
    marks.close(slot)


# --------------------------------------------------------------- host spans

class Spans:
    """Host span totals: ``{name: [count, seconds]}``."""

    def __init__(self):
        self.rows: Dict[str, list] = {}

    def add(self, name: str, seconds: float, n: int = 1) -> None:
        with _lock:
            row = self.rows.setdefault(name, [0, 0.0])
            row[0] += n
            row[1] += seconds

    def read(self) -> Dict[str, dict]:
        """``{span: {'n': count, 'ms': total}}``."""
        with _lock:
            return {k: {"n": n, "ms": 1e3 * s}
                    for k, (n, s) in self.rows.items()}


EAGER_SPANS = Spans()


class Tally(Spans):
    """The host spans of one window or one step, numbered, held until
    ``commit`` adds them to the table ``bind`` named (a program's, the
    eager one, or None: dropped)."""

    def __init__(self):
        super().__init__()
        self.seq = next(_seq)
        self.into: Optional[Spans] = None

    def bind(self, spans: Optional[Spans]) -> None:
        self.into = spans

    def commit(self) -> None:
        with _lock:
            rows, self.rows = self.rows, {}
        if self.into is not None:
            for name, (n, s) in rows.items():
                self.into.add(name, s, n)


@contextlib.contextmanager
def span(name: str, log: bool = False,
         into: Optional[Spans] = None) -> Iterator[None]:
    """A host span around the body (see the module docstring) into
    ``into`` (a ``Tally``: its sequence number is the range's ``args``),
    else the eager table; with ``log``, its wall-clock seconds to the
    'base' logger."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    seq = getattr(into, "seq", None)
    t0 = time.perf_counter()
    with torch.profiler.record_function(
            name, None if seq is None else str(seq)):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
    seconds = time.perf_counter() - t0
    (into if into is not None else EAGER_SPANS).add(name, seconds)
    if log:
        logging.getLogger("base").info("%s: %.4fs", name, seconds)


def _summed(programs, device, key: str, field: str) -> Dict[str, float]:
    """``field`` of each row of the ``key`` table (``stages`` or ``host``),
    summed over the programs of ``programs`` (a ``ProgramCache``), or of
    the eager tables where it is None."""
    tables = ([eager_stats(device)[key]] if programs is None else
              [st[key] for st in programs.stats()])
    out: Dict[str, float] = {}
    for table in tables:
        for name, row in table.items():
            out[name] = out.get(name, 0.0) + row[field]
    return out


def stage_ms(programs, device) -> Dict[str, float]:
    """Device ms by stage (see ``_summed``)."""
    return _summed(programs, device, "stages", "device_ms")


def host_ms(programs, device) -> Dict[str, float]:
    """Host ms by span (see ``_summed``)."""
    return _summed(programs, device, "host", "ms")


def eager_stats(device) -> dict:
    """The eager tables: ``stages`` of ``device`` and every ``host`` span
    made outside a program."""
    return {"stages": eager_marks(device).read(),
            "host": EAGER_SPANS.read()}
