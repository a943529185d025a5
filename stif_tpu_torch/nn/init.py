"""The reference's training initialization, drawn from an explicit
``torch.Generator`` (port of ``stif_tpu/nn/init.py``).

- torch's nn.Conv2d / nn.Linear default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
  for weight and bias;
- residual blocks: kaiming_normal(fan_in) scaled by 0.1, zero bias
  (``codes/models/modules/module_util.py:7-24, 46``);
- SIREN layers: U(-1/n, 1/n) first, U(-sqrt(6/n)/omega, +) hidden and
  last, the bias at the torch default
  (``codes/models/modules/SIREN.py:35-45``);
- DCN: offset / mask conv zeros (``DCNv2/dcn_v2.py:123-125``), weight
  U(-1/sqrt(Cin*k*k), +), zero bias;
- the LIIF ``MLP``'s dense layers: flax's default, lecun-normal truncated
  at two standard deviations, zero bias.

Modules keep their constructor init for serving; ``init_model_`` re-draws
every parameter of a model by these rules, for training from scratch.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from stif_tpu_torch.nn.blocks import Conv, ResidualBlockNoBN
from stif_tpu_torch.nn.dcn import DCNSep
from stif_tpu_torch.nn.mlp import MLP
from stif_tpu_torch.nn.siren import Siren

# flax's truncated-normal correction: the std of a unit normal truncated
# to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _fan_in(w: torch.Tensor) -> int:
    return w[0].numel()  # OIHW conv or (out, in) dense


def _uniform(p, bound: float, gen: torch.Generator) -> None:
    u = torch.empty(p.shape, dtype=torch.float32).uniform_(
        -bound, bound, generator=gen)
    p.copy_(u)


def _normal(p, std: float, gen: torch.Generator) -> None:
    p.copy_(torch.empty(p.shape, dtype=torch.float32).normal_(
        0.0, std, generator=gen))


def _torch_default(weight, bias, gen) -> None:
    bound = 1.0 / math.sqrt(_fan_in(weight))
    _uniform(weight, bound, gen)
    if bias is not None:
        _uniform(bias, bound, gen)


def _siren(net: Siren, gen) -> None:
    linears = [m.linear for m in net.net[:-1]] + [net.net[-1]]
    for i, lin in enumerate(linears):
        n = lin.in_features
        _uniform(lin.weight, 1.0 / n if i == 0
                 else math.sqrt(6.0 / n) / net.omega0, gen)
        _uniform(lin.bias, 1.0 / math.sqrt(n), gen)


def _lecun_trunc(lin: nn.Linear, gen) -> None:
    t = torch.empty(lin.weight.shape, dtype=torch.float32)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    lin.weight.copy_(t / _TRUNC_STD / math.sqrt(lin.in_features))
    lin.bias.zero_()


def init_model_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every parameter of ``model`` in place by the rule of its JAX
    counterpart, in module order, from ``generator`` (a CPU generator; the
    parameters may lie on any device). Raises for a parameter no rule
    covers."""
    done = set()

    def mark(*ps):
        done.update(id(p) for p in ps if p is not None)

    with torch.no_grad():
        for mod in model.modules():
            if any(id(p) in done for p in mod.parameters(recurse=False)):
                continue
            if isinstance(mod, ResidualBlockNoBN):
                for conv in (mod.conv1, mod.conv2):
                    std = math.sqrt(2.0 / _fan_in(conv.weight)) * 0.1
                    _normal(conv.weight, std, generator)
                    conv.bias.zero_()
                mark(*mod.parameters())
            elif isinstance(mod, DCNSep):
                mod.conv_offset_mask.weight.zero_()
                mod.conv_offset_mask.bias.zero_()
                _uniform(mod.weight, 1.0 / math.sqrt(_fan_in(mod.weight)),
                         generator)
                mod.bias.zero_()
                mark(*mod.parameters())
            elif isinstance(mod, Siren):
                _siren(mod, generator)
                mark(*mod.parameters())
            elif isinstance(mod, MLP):
                for lin in mod.layers:
                    if isinstance(lin, nn.Linear):
                        _lecun_trunc(lin, generator)
                mark(*mod.parameters())
            elif isinstance(mod, Conv):
                _torch_default(mod.weight, mod.bias, generator)
                mark(*mod.parameters())
        left = [n for n, p in model.named_parameters() if id(p) not in done]
    if left:
        raise NotImplementedError(f"init_model_: no rule for {left[:5]}")
    return model
