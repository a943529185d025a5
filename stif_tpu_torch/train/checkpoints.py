"""Checkpoint and resume (port of ``stif_tpu/train/checkpoints.py``), with
``torch.save`` in place of orbax.

A checkpoint ``checkpoint_<step>.pth`` holds the step, the model's state
dict in the reference ``.pth`` schema and the optimizer's state. The
schedule is a pure function of the step, so no scheduler state is saved.
``save_params_only`` writes the reference's ``<iter>_G.pth`` equivalent: a
plain state dict, which ``stif_tpu_torch.convert.load_pth`` loads strictly.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

_CKPT_RE = re.compile(r"^checkpoint_(\d+)\.pth$")


def atomic_save(obj, path: str) -> None:
    """Write through a temporary file, so a run stopped mid-write leaves no
    half-written checkpoint under the final name."""
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _steps(directory: str, pattern) -> list:
    return sorted((int(m.group(1)), name) for name in os.listdir(directory)
                  if (m := pattern.match(name)))


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint_{int(step)}.pth")

    def save(self, step: int, params: dict, opt_state: dict) -> int:
        """Write checkpoint ``step`` and keep the newest ``max_to_keep``."""
        step = int(step)
        atomic_save({"step": step, "params": params, "opt_state": opt_state},
              self.path(step))
        if self.max_to_keep:
            for _, name in _steps(self.directory,
                                  _CKPT_RE)[:-self.max_to_keep]:
                os.remove(os.path.join(self.directory, name))
        return step

    def latest_step(self) -> Optional[int]:
        found = _steps(self.directory, _CKPT_RE)
        return found[-1][0] if found else None

    def restore(self, step: Optional[int] = None) -> dict:
        """``{'step', 'params', 'opt_state'}`` of checkpoint ``step`` (the
        latest by default), on the CPU. ``FileNotFoundError`` when there is
        none."""
        step = step if step is not None else self.latest_step()
        if step is None or not os.path.exists(self.path(step)):
            raise FileNotFoundError(
                f"no checkpoint{'' if step is None else f' {step}'} in "
                f"{self.directory}")
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True)

    def save_params_only(self, params: dict, step: int,
                         prefix: str = "params", keep: int = 0) -> str:
        """Weights only, ``<prefix>_<step>.pth``. ``keep`` > 0 prunes older
        ``<prefix>_*`` files down to the newest ``keep``."""
        path = os.path.join(self.directory, f"{prefix}_{int(step)}.pth")
        atomic_save(params, path)
        if keep > 0:
            pat = re.compile(rf"^{re.escape(prefix)}_(\d+)\.pth$")
            for _, name in _steps(self.directory, pat)[:-keep]:
                os.remove(os.path.join(self.directory, name))
        return path


def load_params(path: str) -> dict:
    """A weights-only state dict written by ``save_params_only``, on the
    CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
