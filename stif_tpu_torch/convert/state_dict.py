"""Checkpoint interop (port of ``stif_tpu/convert/torch_import.py``).

The port's module tree follows the reference ``.pth`` schema, so a reference
checkpoint loads with ``load_state_dict(strict=True)``. JAX parameter trees
(nested dicts of arrays, as ``model.init`` returns them) map to that schema:

  conv kernels  HWIO -> OIHW;   dense kernels (in, out) -> (out, in)
  scanned trunks (``.../blocks/block/...``, stacked on axis 0) -> one key
    per block;
  ``forward_net/step/cell/conv`` -> ``forward_net.cell_list.0.conv``;
  ``forward_net/step/pcd_{h,c}`` -> ``forward_net.pcd_{h,c}``;
  SIREN ``{imnet}/layer{i}`` -> ``{imnet}.net.{i}.linear``, the last layer
    ``{imnet}.net.{last}``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _imnet_depths(paths) -> Dict[str, int]:
    """Number of layers of each SIREN (``*imnet``) in the tree."""
    depths: Dict[str, int] = {}
    for path in paths:
        for i in range(1, len(path) - 1):
            if path[i].startswith("layer") and path[i - 1].endswith("imnet"):
                name = path[i - 1]
                depths[name] = max(depths.get(name, 0),
                                   int(path[i][len("layer"):]) + 1)
    return depths


def _key(path: Tuple[str, ...], depths: Dict[str, int]) -> Tuple[str, str]:
    """(state-dict key, kind) of a JAX parameter path; kind in
    {"conv", "linear", "bias"} selects the layout transform."""
    *mods, leaf = path
    out, kind, i = [], None, 0
    while i < len(mods):
        m = mods[i]
        if m.startswith("block"):
            out.append(m[len("block"):])
        elif m == "forward_net" and i + 1 < len(mods) and mods[i + 1] == "step":
            if mods[i + 2] == "cell":
                out += ["forward_net", "cell_list", "0"]
                i += 2
            else:
                out.append("forward_net")
                i += 1
        elif (m in depths and i + 1 < len(mods)
              and mods[i + 1].startswith("layer")):
            li = int(mods[i + 1][len("layer"):])
            out += [m, "net", str(li)]
            if li != depths[m] - 1:
                out.append("linear")
            kind = "linear"
            i += 1
        else:
            out.append(m)
        i += 1
    if leaf in ("kernel", "weight"):
        return ".".join(out + ["weight"]), kind or "conv"
    return ".".join(out + ["bias"]), "bias"


def _to_torch_layout(v: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv" and v.ndim == 4:
        return v.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if kind == "linear" and v.ndim == 2:
        return v.T
    return v


def jax_params_to_state_dict(params) -> Dict[str, torch.Tensor]:
    """A JAX parameter tree (``{'params': ...}`` or its inner dict) of numpy
    arrays -> a state dict of float32 tensors in the reference schema."""
    tree = params["params"] if "params" in params else params
    entries = list(_flatten(tree))
    depths = _imnet_depths([p for p, _ in entries])
    state = {}
    for path, value in entries:
        v = np.array(value, dtype=np.float32)  # a writable copy
        if "blocks" in path:  # scanned trunk: one stacked block axis
            j = path.index("blocks")
            for b in range(v.shape[0]):
                key, kind = _key(path[:j] + (f"block{b}",) + path[j + 2:],
                                 depths)
                state[key] = _to_torch_layout(v[b], kind)
        else:
            key, kind = _key(path, depths)
            state[key] = _to_torch_layout(v, kind)
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in state.items()}


def load_pth(model: torch.nn.Module, path: str):
    """Load a reference ``.pth`` state dict into ``model`` strictly,
    stripping a leading DataParallel ``module.`` prefix."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    state = {(k[len("module."):] if k.startswith("module.") else k): v
             for k, v in raw.items()}
    return model.load_state_dict(state, strict=True)
