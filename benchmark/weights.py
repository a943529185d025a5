"""The weights a cell runs: a configuration's ``weights`` entry made into a
state dict, which the benchmark hands to the program and to the reference
alike.

- ``{"file": path}``: a reference-schema ``.pth`` in the checkout, loaded
  on the device (a leading ``module.`` stripped).
- ``{"draw": {...}}``: drawn from the seed on the device by one
  ``torch.Generator`` in two calls over all parameters at once: conv
  weights normal with std sqrt(1 / fan_in), times ``residual_scale`` in the
  residual trunks; linear (SIREN) weights with that std over 30; biases
  zero; each DCN's offset-and-mask conv with its
  weight at ``offset_weight_scale`` of that std and the offset half of its
  bias uniform in +-``offset_px`` pixels, so that its samples land off the
  grid by a few pixels.

``lagging`` makes the state an EMA starts from in a resumed run: the
weights with seeded noise of a given share of each leaf's RMS, drawn in one
call over all leaves.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

Shapes = Dict[str, torch.Size]


def load_file(path, device) -> Dict[str, torch.Tensor]:
    raw = torch.load(str(path), map_location=device, weights_only=True)
    return {(k[len("module."):] if k.startswith("module.") else k): v.float()
            for k, v in raw.items()}


def draw(shapes: Shapes, spec: dict, seed: int,
         device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(math.prod(s) for s in shapes.values())
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device) * 2 - 1
    res = float(spec.get("residual_scale", 0.1))
    om_scale = float(spec.get("offset_weight_scale", 0.1))
    px = float(spec.get("offset_px", 2.0))
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        z, u = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        if name.endswith(".weight") and len(shape) == 4:
            std = math.sqrt(1.0 / (shape[1] * shape[2] * shape[3]))
            if "conv_offset_mask" in name:
                std *= om_scale
            elif name.startswith(("feature_extraction.", "recon_trunk.")):
                std *= res
            out[name] = z * std
        elif name.endswith(".weight") and len(shape) == 2:
            # a SIREN layer: sin(30 x) of its product
            out[name] = z * math.sqrt(1.0 / shape[1]) / 30.0
        elif name.endswith("conv_offset_mask.bias"):
            # [o1, o2, mask]: the offsets' two thirds drawn, the mask's 0
            b = torch.zeros(shape, device=device)
            k = 2 * shape[0] // 3
            b[:k] = u[:k] * px
            out[name] = b
        elif name.endswith(".bias"):
            out[name] = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"no draw rule for {name} {tuple(shape)}")
    return out


def make(spec: dict, shapes: Shapes, seed: int, root,
         device) -> Dict[str, torch.Tensor]:
    """The state dict of weights entry ``spec`` (see the module
    docstring); ``root`` is the checkout, the base of a file's path."""
    if "file" in spec:
        state = load_file(root / spec["file"], device)
        if set(state) != set(shapes):
            raise KeyError("the weights file's keys differ from the model's: "
                           f"{sorted(set(state) ^ set(shapes))[:8]}")
        return state
    return draw(shapes, spec["draw"], seed, device)


def lagging(state: Dict[str, torch.Tensor], share: float, seed: int,
            device) -> Dict[str, torch.Tensor]:
    """``state`` plus normal noise with std ``share`` times each floating
    leaf's RMS, from the seed (a stream apart from ``draw``'s): an EMA
    that lags the weights, as a resumed run's does. Other leaves are
    copied."""
    gen = torch.Generator(device=device).manual_seed(int(seed) ^ 0x5EED)
    floats = [k for k, v in state.items() if v.is_floating_point()]
    total = sum(state[k].numel() for k in floats)
    noise = torch.randn(total, generator=gen, device=device)
    out, at = {k: v.clone() for k, v in state.items()}, 0
    for k in floats:
        v = state[k]
        rms = v.double().pow(2).mean().sqrt().float()
        out[k] = v + noise[at:at + v.numel()].view(v.shape) * (share * rms)
        at += v.numel()
    return out
