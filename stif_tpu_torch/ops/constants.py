"""The forward's per-bucket constants, kept on the device.

The JAX package builds its forward's shape constants in numpy while
``jax.jit`` traces a (shape, nt, out_size) bucket and bakes them into the
compiled program: the resize matrices (``ops/resize.py``), the coordinate
grids (``ops/coords.py``), the warp base grids (``ops/warp.py``) and a few
small scale vectors. The compiled forward then makes no host-to-device copy.
Here the first call that needs a constant plays the part of that trace:
``constant`` runs the numpy builder once per (builder, arguments, device,
dtype), uploads the result, and every later call of the bucket reads that
device tensor. After one call per bucket the forward makes no host sync of
its own; before, each constant went up from pageable memory at every call,
and PyTorch drains the stream before such a copy.

The rules the store keeps:

- A constant is built under ``torch.inference_mode(False)`` and
  ``torch.no_grad()``: a normal tensor that does not require grad, so that
  a train step can use what an inference-mode render built.
- The key holds the device with its index: ``cuda`` is the current card,
  so ``cuda`` and ``cuda:0`` are one key while card 0 is current, and
  ``cuda:1`` is another.
- Callers share the tensor and never write into it.
- The values are the numpy builder's, uploaded once, bit for bit.
- A failed build raises; nothing falls back to a per-call copy.
- While a CUDA graph is captured (``runtime/compiled.py``), every tensor
  ``get`` returns is handed to the capture's scope (``ops/capture.py``), and
  the captured program keeps a reference to it: the graph reads it by
  address, so the table's bound below must not free it while the program
  lives.

The table is a least-recently-used one, bounded by ``MAX_BYTES`` per device
(the newest constant is kept even if it alone is larger). One bucket of the
deployed window (LR 96x160 -> 8 x 384x640) holds 4.7 MB: the query grid
and the warp base grid 1.97 MB each, the bicubic skip matrices 0.56 MB, the
LR cell centres 0.12 MB, the pyramids' four bilinear matrices 0.09 MB. A
1080p bucket (LR 272x480 padded -> 1088x1920) holds 40 MB, most of it the
two 16.7 MB grids. So the bound keeps about 25 buckets of 1080p on a card.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict

import numpy as np
import torch

from stif_tpu_torch.ops import capture

MAX_BYTES = 1 << 30  # per device


def _device_key(device) -> torch.device:
    """``device`` with its index: ``cuda`` resolves to the current card."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class ConstantStore:
    """A table of device tensors built once each by numpy builders (see the
    module docstring), least recently used first out, at most
    ``self.max_bytes`` per device."""

    def __init__(self):
        self.max_bytes = MAX_BYTES
        self._tables: Dict[torch.device, OrderedDict] = {}
        self._stats: Dict[torch.device, Dict[str, int]] = {}
        self._lock = threading.Lock()

    def get(self, builder: Callable[..., np.ndarray], *args, device=None,
            dtype=torch.float32) -> torch.Tensor:
        """``builder(*args)`` as a tensor of ``dtype`` on ``device``, built
        and uploaded on the first call with these arguments. The arguments
        must be hashable."""
        dev = _device_key(device)
        key = (builder, args, dtype)
        with self._lock:
            table = self._tables.setdefault(dev, OrderedDict())
            stats = self._stats.setdefault(
                dev, {"builds": 0, "hits": 0, "bytes": 0, "entries": 0})
            hit = table.get(key)
            if hit is not None:
                table.move_to_end(key)
                stats["hits"] += 1
                capture.hold(hit)
                return hit
            with torch.inference_mode(False), torch.no_grad():
                value = torch.as_tensor(builder(*args)).to(
                    device=dev, dtype=dtype, copy=True)
            table[key] = value
            stats["builds"] += 1
            stats["bytes"] += value.nbytes
            while stats["bytes"] > self.max_bytes and len(table) > 1:
                _, old = table.popitem(last=False)
                stats["bytes"] -= old.nbytes
            stats["entries"] = len(table)
            capture.hold(value)
            return value

    def tensors(self):
        """Every cached tensor, for checks that none is written."""
        with self._lock:
            return [v for table in self._tables.values()
                    for v in table.values()]

    def stats(self) -> Dict[str, Dict[str, int]]:
        """Builds, hits, bytes held and entries, by device (``str``)."""
        with self._lock:
            return {str(dev): dict(s) for dev, s in self._stats.items()}

    def clear(self) -> None:
        """Drop every constant and count from zero (a cold store)."""
        with self._lock:
            self._tables.clear()
            self._stats.clear()


STORE = ConstantStore()
# the shared, read-only device copy of ``builder(*args)``
constant = STORE.get
stats = STORE.stats


def _values(values) -> np.ndarray:
    return np.asarray(values, np.float64)


def vector(*values, device=None, dtype=torch.float32) -> torch.Tensor:
    """The small vector ``torch.tensor(values, dtype=dtype)``, from the
    store: the Python numbers are rounded once to ``dtype``, as there."""
    return constant(_values, values, device=device, dtype=dtype)
