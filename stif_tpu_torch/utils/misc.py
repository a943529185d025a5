"""Misc utilities: meters, logging, experiment dirs, profiling spans (port
of ``stif_tpu/utils/misc.py``).

Parity targets: ``AverageMeter`` (``codes/myutils.py:228-271``),
``setup_logger`` / ``mkdir_and_rename`` (``codes/utils/util.py:66-97``).
``trace_span`` names a span for the profilers, which the reference lacked:
the JAX package's wraps ``jax.profiler.TraceAnnotation``; this one wraps
``torch.profiler.record_function`` (a span in ``torch.profiler`` traces)
and, once CUDA is initialised, an NVTX range (for ``nsys``), around the
same wall-clock log.
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from contextlib import contextmanager


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def mkdir_and_rename(path: str):
    """Archive an existing experiment dir with a timestamp suffix
    (reference ``mkdir_and_rename``)."""
    if os.path.exists(path):
        new_name = path + "_archived_" + time.strftime("%Y%m%d-%H%M%S")
        shutil.move(path, new_name)
    os.makedirs(path, exist_ok=True)


def setup_logger(name: str = "base", log_file: str = None,
                 level=logging.INFO, screen: bool = True):
    logger = logging.getLogger(name)
    fmt = logging.Formatter(
        "%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s",
        datefmt="%y-%m-%d %H:%M:%S",
    )
    logger.setLevel(level)
    if log_file:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file, mode="w")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    if screen:
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    return logger


class ProgressBar:
    """Terminal progress bar with rate/ETA — capability parity with the
    reference's ``ProgressBar`` (``codes/utils/util.py:199-246``), written
    for dumb terminals too (single-line carriage-return redraw instead of
    ANSI cursor movement)."""

    def __init__(self, task_num: int = 0, bar_width: int = 50,
                 start: bool = True, stream=None):
        import sys

        self.task_num = task_num
        self.stream = stream or sys.stdout
        cols = shutil.get_terminal_size().columns
        self.bar_width = max(10, min(bar_width, int(cols * 0.6), cols - 50))
        self.completed = 0
        self.start_time = time.time()
        if start:
            self.start()

    def start(self):
        if self.task_num > 0:
            self.stream.write(
                f"[{' ' * self.bar_width}] 0/{self.task_num}, ETA: --\r")
        else:
            self.stream.write("completed: 0, elapsed: 0s\r")
        self.stream.flush()
        self.start_time = time.time()

    def update(self, msg: str = ""):
        self.completed += 1
        elapsed = max(time.time() - self.start_time, 1e-9)
        rate = self.completed / elapsed
        if self.task_num > 0:
            pct = self.completed / float(self.task_num)
            eta = int(elapsed * (1 - pct) / max(pct, 1e-9) + 0.5)
            mark = int(self.bar_width * pct)
            bar = ">" * mark + "-" * (self.bar_width - mark)
            self.stream.write(
                f"[{bar}] {self.completed}/{self.task_num}, "
                f"{rate:.1f} task/s, elapsed: {int(elapsed + 0.5)}s, "
                f"ETA: {eta:5d}s {msg}\r")
            if self.completed == self.task_num:
                self.stream.write("\n")
        else:
            self.stream.write(
                f"completed: {self.completed}, "
                f"elapsed: {int(elapsed + 0.5)}s, {rate:.1f} tasks/s\r")
        self.stream.flush()


@contextmanager
def trace_span(name: str, log: bool = False):
    """A named profiler span (``torch.profiler.record_function``, and an
    NVTX range once CUDA is initialised) around the body; with ``log``, its
    wall-clock seconds to the 'base' logger."""
    import torch

    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
    if log:
        logging.getLogger("base").info("%s: %.4fs", name,
                                       time.perf_counter() - t0)
