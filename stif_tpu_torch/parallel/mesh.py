"""Device meshes (port of ``stif_tpu/parallel/mesh.py``).

The JAX package names its devices with one ``jax.sharding.Mesh`` and lets
XLA place the collectives. PyTorch splits that role in two:

  ``Mesh``        named axes over an ndarray of ``torch.device`` handles;
                  the single-process ``ChunkedDecoder`` reads its devices
                  from one (two handles may name the same card);
  ``device_mesh`` the same axes as a ``torch.distributed`` ``DeviceMesh``
                  over the ranks of a process group, one process per
                  device: DDP and tensor parallelism use it.

Axes:
  ``data``  the batch, one shard per rank (the DDP layout);
  ``model`` the decoder's widest matmuls (tensor parallelism) and, at
            inference, the decoder's query axis.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch


class Mesh:
    """Named axes over an ndarray of ``torch.device`` handles."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim} mesh dims, {len(axis_names)} "
                             "axis names")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis`` at index 0 of every other axis."""
        i = self.axis_names.index(axis)
        return list(np.moveaxis(self.devices, i, 0).reshape(
            self.devices.shape[i], -1)[:, 0])


def cuda_devices() -> list:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(axis_sizes: dict, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh with named axes, e.g. ``make_mesh({'data': 4, 'model': 2})``,
    over ``devices`` (every CUDA device by default). Raises when the mesh
    needs more devices than it is given."""
    devices = list(devices if devices is not None else cuda_devices())
    names = tuple(axis_sizes)
    sizes = tuple(int(axis_sizes[n]) for n in names)
    n = int(np.prod(sizes))
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(d) for d in devices[:n]]
    return Mesh(arr.reshape(sizes), names)


def default_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
                 device_type: str = "cuda") -> Mesh:
    """``data`` x ``model`` mesh over every CUDA device (or the first
    ``n_devices``); with ``device_type='cpu'``, over ``n_devices`` handles
    of the CPU (one by default). Raises when CUDA is asked for and there is
    no GPU."""
    if device_type == "cpu":
        devs = [torch.device("cpu")] * (n_devices or 1)
    elif device_type == "cuda":
        devs = cuda_devices()
        if not devs:
            raise RuntimeError("no CUDA device is available; pass "
                               "device_type='cpu' for a mesh of the CPU")
    else:
        raise ValueError(f"unsupported device type {device_type!r}")
    n = n_devices or len(devs)
    return make_mesh({"data": n // model_parallel, "model": model_parallel},
                     devs[:n])


def device_mesh(mesh: Mesh):
    """``mesh`` as a ``torch.distributed`` ``DeviceMesh`` with the same axis
    names over ranks ``0 .. size - 1`` of the current process group, which
    must hold exactly ``mesh.size`` processes."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("device_mesh needs a process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world != mesh.size:
        raise ValueError(f"mesh of {mesh.size} devices over a process group "
                         f"of {world}")
    ranks = torch.arange(world).reshape(mesh.devices.shape)
    return DeviceMesh(mesh.devices.flat[0].type, ranks,
                      mesh_dim_names=mesh.axis_names)
