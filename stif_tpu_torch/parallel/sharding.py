"""Placements for parameters, batches and decoder query grids (port of
``stif_tpu/parallel/sharding.py``).

A JAX ``NamedSharding(mesh, P(...))`` names a mesh axis per array dim; a
DTensor placement names an array dim per mesh axis. The functions here
return one placement per axis of the mesh, ``Replicate()`` on every axis
the JAX spec leaves out.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from stif_tpu_torch.parallel.mesh import Mesh, device_mesh


def _placements(mesh: Mesh, axis=None, mesh_axis=None) -> Tuple:
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(axis) if name == mesh_axis else Replicate()
                 for name in mesh.axis_names)


def replicated(mesh: Mesh) -> Tuple:
    """Every mesh axis replicates (``P()``)."""
    return _placements(mesh)


def batch_sharding(mesh: Mesh, ndim: int, axis: int = 0,
                   mesh_axis: str = "data") -> Tuple:
    """Dim ``axis`` of an ``ndim``-dim tensor sharded over ``mesh_axis``."""
    if not -ndim <= axis < ndim:
        raise ValueError(f"axis {axis} of a {ndim}-dim tensor")
    return _placements(mesh, axis % ndim, mesh_axis)


def _is_imnet_weight(key: str, value: torch.Tensor) -> bool:
    parts = key.split(".")
    return (any("imnet" in p for p in parts) and parts[-1] == "weight"
            and value.dim() == 2)


def param_shardings(mesh: Mesh, state_dict: Dict[str, torch.Tensor],
                    tensor_parallel: bool = False) -> Dict[str, Tuple]:
    """One placement tuple per state-dict key. Replicated (the data-parallel
    layout) unless ``tensor_parallel`` and the ``model`` axis is > 1: then
    each SIREN decoder weight (a key under ``*imnet*`` ending in
    ``weight``) whose output dim divides by the ``model`` size is sharded
    on its output dim, ``Shard(0)`` of torch's (out, in) ``Linear.weight``:
    the JAX ``P(None, 'model')`` of the (in, out) kernel."""
    mp = mesh.shape.get("model", 1)
    tp = tensor_parallel and mp > 1
    out = {}
    for key, value in state_dict.items():
        if tp and _is_imnet_weight(key, value) and value.shape[0] % mp == 0:
            out[key] = _placements(mesh, 0, "model")
        else:
            out[key] = replicated(mesh)
    return out


def apply_tensor_parallel(model: torch.nn.Module, mesh: Mesh) -> list:
    """Shard every decoder ``Linear`` that ``param_shardings`` shards over
    the ``model`` axis (column parallelism: each rank computes a slice of
    the outputs, gathered whole before the sine and the next layer), and
    turn the fused kernel off in the nets it touches: the kernel reads a
    weight through its raw pointer, which under tensor parallelism holds
    one shard. Returns the names of the sharded layers (none when the
    ``model`` axis is 1: the model is left as it is)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   parallelize_module)

    from stif_tpu_torch.nn.siren import Siren

    specs = param_shardings(mesh, model.state_dict(), tensor_parallel=True)
    layers = sorted(k[:-len(".weight")] for k, p in specs.items()
                    if any(isinstance(x, Shard) for x in p))
    if not layers:
        return []
    plan = {name: ColwiseParallel(output_layouts=Replicate())
            for name in layers}
    parallelize_module(model, device_mesh(mesh)["model"], plan)
    for name, m in model.named_modules():
        if isinstance(m, Siren) and any(k.startswith(name + ".")
                                        for k in layers):
            m.fused = False
    return layers


def shard_queries(x: torch.Tensor, mesh: Mesh, axis: int = 1,
                  mesh_axis: str = "model"):
    """The decoder's flat query axis ``axis`` of ``x`` as a DTensor sharded
    over ``mesh_axis``; ``x`` unchanged when that axis has size <= 1.
    Needs a process group of the mesh's size."""
    if mesh.shape.get(mesh_axis, 1) <= 1:
        return x
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, device_mesh(mesh),
                             batch_sharding(mesh, x.dim(), axis, mesh_axis))
