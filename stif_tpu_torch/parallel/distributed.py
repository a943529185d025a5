"""Process groups for data-parallel training: one process per device,
NCCL between cards, gloo on the CPU.

``torch.distributed.run`` describes the group to each process in the
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``); a caller that starts the processes itself calls
``torch.distributed.init_process_group`` with its own address first.
"""

from __future__ import annotations

import os
import socket

import torch


def join_process_group(device: torch.device) -> torch.device:
    """Join the group ``torch.distributed.run`` describes, unless this
    process is in one already; returns this rank's device: ``cuda:
    LOCAL_RANK`` when ``device`` is a CUDA device given without an index,
    else ``device``."""
    import torch.distributed as dist

    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"data-parallel training needs a process group: run under "
                f"python -m torch.distributed.run (missing {missing}) or "
                f"call torch.distributed.init_process_group first")
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://")
    return device


def rank_and_world() -> tuple:
    """(rank, world size) of the current group, (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier() -> None:
    """Wait for every rank of the current group; nothing without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def free_port() -> int:
    """A TCP port on localhost that was free when asked (bind to port 0)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]
