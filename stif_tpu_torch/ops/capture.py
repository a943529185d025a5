"""What a captured CUDA graph holds on to, and when it is stale.

A graph captured by ``runtime/compiled.py`` replays the kernels of one
forward with the pointers and parameters they had while it was captured.
Two things follow, kept here because the layers below the runtime take part
in them:

- ``scope``: while a capture is recorded on this thread (or on its capture
  stream, by another thread: a backward's kernels are launched from
  autograd's own thread for the card), the constant store
  (``ops/constants.py``) hands each tensor it returns to ``hold``, and the
  kernels' wrappers hand each launch to ``launched``. The ``Recording``
  keeps a reference to every such tensor (the graph reads it by address, so
  the store's least-recently-used bound must not free it), and tallies the
  launches (and a wrapper's further counters, such as the SIREN kernel's
  tensor-core layers) instead of adding them to the wrappers' counts:
  nothing runs at a capture, and each replay adds the tally. The stage marks
  (``utils/trace.py``) find there the table of the program being
  captured, which its replays add to.
- the route: the switches that change which kernels a forward launches
  set flags on a model's modules (``nn.siren.set_fused``: each ``Siren``'s
  ``fused``; ``nn.dcn.set_dcn_kernel``: each ``DCNSep``'s ``use_kernel``)
  or a process-wide default (``ops.deform_conv.set_dcn_impl``). Such a
  module is ``Switched``: ``route_flags()`` gives its flags. A program's
  key holds each switched module's flags and the process-wide switch's
  values, each with an epoch (``switched``): a switch that changes a flag
  puts back the epoch its owner last had with that value, so a round trip
  (``set_fused(net, True)`` then ``set_fused(net, False)``) finds the
  programs captured before it; a switch that leaves a flag as it was draws
  a fresh epoch, so a caller can ask for a new capture by switching to the
  value a model already has. A switch on one model (the validator's copy)
  never touches the key of another.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
from typing import Callable, Dict, Hashable, Iterator, Optional, Tuple

import torch

_local = threading.local()
# the recordings of captures under way, by their capture stream: autograd
# launches a captured backward from its own thread, on that stream
_by_stream: Dict[int, "Recording"] = {}
_fresh = itertools.count(1)  # epochs: 0 is a flag no switch has set
_route_lock = threading.Lock()


class Recording:
    """What one capture holds: the store tensors its forward read, the
    launches of each kernel wrapper (keyed by the wrapper) it recorded and
    its further counters (keyed by wrapper and attribute name), the table
    its stage marks write (``utils/trace.py``; None: the eager one) and the
    captured graph's node count (None where it is not read)."""

    def __init__(self):
        self.tensors: Dict[int, torch.Tensor] = {}  # by id: each held once
        self.launches: Dict[Callable, int] = {}
        self.counters: Dict[Tuple[Callable, str], int] = {}
        self.marks = None
        self.graph_nodes: Optional[int] = None


def current() -> Optional[Recording]:
    """The recording of a capture under way on this thread, or of the one
    capturing this thread's current stream, or None."""
    rec = getattr(_local, "recording", None)
    if rec is None and _by_stream:
        rec = _by_stream.get(torch.cuda.current_stream().cuda_stream)
    return rec


@contextlib.contextmanager
def scope(stream: Optional[torch.cuda.Stream] = None
          ) -> Iterator[Recording]:
    """Record what the work inside captures (see the module docstring);
    ``stream``: the capture stream, whose work other threads record here
    too."""
    if getattr(_local, "recording", None) is not None:
        raise RuntimeError("a capture is already being recorded on this "
                           "thread")
    rec = Recording()
    _local.recording = rec
    key = None if stream is None else stream.cuda_stream
    if key is not None:
        _by_stream[key] = rec
    try:
        yield rec
    finally:
        _local.recording = None
        if key is not None:
            del _by_stream[key]


def hold(tensor: torch.Tensor) -> None:
    """Keep ``tensor`` alive for the capture being recorded, if any."""
    rec = current()
    if rec is not None:
        rec.tensors[id(tensor)] = tensor


def launched(wrapper: Callable, **counters: int) -> None:
    """Count one launch of ``wrapper``'s kernel, and ``counters`` (what the
    launch ran, added to ``wrapper``'s attributes of those names): into the
    capture being recorded, if any (the kernel did not run), else onto
    ``wrapper.launches`` and those attributes."""
    rec = current()
    if rec is None:
        wrapper.launches += 1
        add_counters(wrapper, counters)
    else:
        rec.launches[wrapper] = rec.launches.get(wrapper, 0) + 1
        for name, n in counters.items():
            key = (wrapper, name)
            rec.counters[key] = rec.counters.get(key, 0) + n


def add_counters(wrapper: Callable, counters: Dict[str, int]) -> None:
    """Add ``counters`` to ``wrapper``'s attributes of those names."""
    for name, n in counters.items():
        setattr(wrapper, name, getattr(wrapper, name) + n)


class Switched:
    """A module with flags that a route switch sets."""

    def route_flags(self) -> tuple:
        raise NotImplementedError


def switched(epochs: Dict[Hashable, int], before: Hashable,
             after: Hashable) -> None:
    """Record in its owner's table ``epochs`` that a switch set a flag from
    ``before`` to ``after`` (see the module docstring)."""
    with _route_lock:
        if after == before or after not in epochs:
            epochs[after] = next(_fresh)


def epochs_of(module) -> Dict[Hashable, int]:
    """The epoch table of ``module``'s flags (kept in its ``__dict__``: a
    copy of the module starts from the same table, and is its own key)."""
    return module.__dict__.setdefault("_route_epochs", {})


def route_of(module: Switched) -> tuple:
    """A switched module's part of a program's key: its flags and their
    epoch."""
    flags = module.route_flags()
    return flags, module.__dict__.get("_route_epochs", {}).get(flags, 0)
