"""What a captured CUDA graph holds on to, and when it is stale.

A graph captured by ``runtime/compiled.py`` replays the kernels of one
forward with the pointers and parameters they had while it was captured.
Two things follow, kept here because the layers below the runtime take part
in them:

- ``scope``: while a capture is recorded on this thread, the constant store
  (``ops/constants.py``) hands each tensor it returns to ``hold``, and the
  kernels' wrappers hand each launch to ``launched``. The ``Recording``
  keeps a reference to every such tensor (the graph reads it by address, so
  the store's least-recently-used bound must not free it), and tallies the
  launches instead of adding them to the wrappers' counts: nothing runs at
  a capture, and each replay adds the tally.
- ``route_epoch``: the switches that change which kernels a forward
  launches (``nn.siren.set_fused``, ``nn.dcn.set_dcn_kernel``,
  ``ops.deform_conv.set_dcn_impl``) call ``bump_route``. A program's key
  holds the epoch, so a switch after a capture makes the next call capture
  anew.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Iterator, Optional

import torch

_local = threading.local()
_route = {"epoch": 0}
_route_lock = threading.Lock()


class Recording:
    """What one capture holds: the store tensors its forward read, and the
    launches of each kernel wrapper (keyed by the wrapper) it recorded."""

    def __init__(self):
        self.tensors: Dict[int, torch.Tensor] = {}  # by id: each held once
        self.launches: Dict[Callable, int] = {}


def current() -> Optional[Recording]:
    """The recording of a capture under way on this thread, or None."""
    return getattr(_local, "recording", None)


@contextlib.contextmanager
def scope() -> Iterator[Recording]:
    """Record what the work inside captures (see the module docstring)."""
    if current() is not None:
        raise RuntimeError("a capture is already being recorded on this "
                           "thread")
    rec = Recording()
    _local.recording = rec
    try:
        yield rec
    finally:
        _local.recording = None


def hold(tensor: torch.Tensor) -> None:
    """Keep ``tensor`` alive for the capture being recorded, if any."""
    rec = current()
    if rec is not None:
        rec.tensors[id(tensor)] = tensor


def launched(wrapper: Callable) -> None:
    """Count one launch of ``wrapper``'s kernel: into the capture being
    recorded, if any (the kernel did not run), else ``wrapper.launches``."""
    rec = current()
    if rec is None:
        wrapper.launches += 1
    else:
        rec.launches[wrapper] = rec.launches.get(wrapper, 0) + 1


def route_epoch() -> int:
    return _route["epoch"]


def bump_route() -> None:
    """A switch changed which kernels a forward launches: every captured
    program is stale."""
    with _route_lock:
        _route["epoch"] += 1
