"""SIREN coordinate MLP (port of ``stif_tpu/nn/siren.py``).

Parameters follow the reference schema: sine layers are ``net.{i}.linear``,
the plain linear output layer is ``net.{last}``. The fp32 forward hands the
field list to ``siren_apply_fused`` and never concatenates it itself: on the
GPU the fused kernel reads the fields in place. ``compute_dtype`` and
``split_first`` are layer-by-layer forms outside the kernel, as in the JAX
package.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn

from stif_tpu_torch.ops.precision import round_to
from stif_tpu_torch.ops.siren_fused import (
    is_dtensor,
    siren_apply_fused,
    siren_apply_fused_plain,
)


class SineLayer(nn.Module):
    def __init__(self, in_features: int, out_features: int, is_first: bool,
                 omega0: float = 30.0):
        super().__init__()
        self.linear = nn.Linear(in_features, out_features)
        # SIREN init: U(-1/n, 1/n) first, U(-sqrt(6/n)/omega0, +) hidden;
        # the bias keeps nn.Linear's default
        bound = (1.0 / in_features if is_first
                 else math.sqrt(6.0 / in_features) / omega0)
        nn.init.uniform_(self.linear.weight, -bound, bound)


class Siren(nn.Module):
    """net = [Sine(first), Sine x hidden_layers, Linear].

    Which form runs, in the JAX module's order of precedence:

    - ``compute_dtype`` set (e.g. ``torch.bfloat16``): never the fused
      kernel, which is fp32 only. Each layer's input and weight are rounded
      to ``compute_dtype``; product, accumulation, bias add and sine are
      fp32; each layer's result, the last included, is rounded to
      ``compute_dtype`` again and the output is fp32. The product is an fp32
      ``matmul`` of the rounded operands widened back to fp32: a ``matmul``
      of two bf16 tensors would round its result to bf16 before the bias,
      which ``jnp.dot(..., preferred_element_type=float32)`` does not.
      Products of two bf16 values are exact in fp32, so this form gives the
      fp32-accumulated result on the CPU and on a GPU alike.
    - ``fused`` (the default) with ``split_first``: ``ValueError``. The
      kernel has no split-K form, and running it would record split-K as
      active on a path that never splits.
    - ``fused``: ``siren_apply_fused`` (the kernel on CUDA tensors; it
      raises on tensor-parallel weights).
    - layers sharded by ``parallel.apply_tensor_parallel`` (DTensor
      weights): each ``Linear`` module is called, so that its hooks gather
      the sharded outputs whole before the sine; fp32 only, so
      ``compute_dtype`` or ``split_first`` raises ``ValueError``.
    - ``split_first`` on a field list: the first layer is the sum of one
      partial product per field, ``sum_i x_i @ W[k_i] + b``; the same math
      up to the order of fp32 sums.
    - otherwise the plain PyTorch version: the yardstick the fused kernel
      is compared against, never a fallback.
    """

    def __init__(self, in_features: int, hidden_features: Sequence[int],
                 hidden_layers: int, out_features: int, omega0: float = 30.0,
                 fused: bool = True, compute_dtype=None,
                 split_first: bool = False):
        super().__init__()
        dims = ([in_features] + list(hidden_features[:hidden_layers + 1])
                + [out_features])
        layers = [SineLayer(dims[i], dims[i + 1], i == 0, omega0)
                  for i in range(len(dims) - 2)]
        last = nn.Linear(dims[-2], dims[-1])
        bound = math.sqrt(6.0 / dims[-2]) / omega0
        nn.init.uniform_(last.weight, -bound, bound)
        self.net = nn.ModuleList(layers + [last])
        self.omega0 = omega0
        self.fused = fused
        self.compute_dtype = compute_dtype
        self.split_first = split_first
        self._uses_kernel()  # a conflicting configuration fails here

    def _uses_kernel(self) -> bool:
        if not self.fused or self.compute_dtype is not None:
            return False
        if self.split_first:
            raise ValueError(
                "Siren: fused and split_first are mutually exclusive: the "
                "fused kernel has no split-K form; disable one")
        return True

    def forward(self, x) -> torch.Tensor:
        """``x``: (..., Cin), or a list of (..., c_i) fields sharing leading
        dims, concatenated on the feature axis inside the op."""
        linears = [m.linear for m in self.net[:-1]] + [self.net[-1]]
        dt = self.compute_dtype
        kernel = self._uses_kernel()
        if not kernel and any(is_dtensor(lin.weight) for lin in linears):
            if dt is not None or self.split_first:
                raise ValueError(
                    "Siren: tensor-parallel weights run the fp32 layers "
                    "whole; compute_dtype and split_first are not supported "
                    "there")
            h = torch.cat(list(x) if isinstance(x, (list, tuple)) else [x],
                          dim=-1)
            for i, lin in enumerate(linears):
                h = lin(h)
                if i < len(linears) - 1:
                    h = torch.sin(self.omega0 * h)
            return h
        if kernel or (dt is None and not self.split_first):
            ws = [lin.weight.t().contiguous() for lin in linears]
            bs = [lin.bias for lin in linears]
            fn = siren_apply_fused if kernel else siren_apply_fused_plain
            return fn(x, ws, bs, omega0=self.omega0)

        parts = [round_to(v, dt)
                 for v in (x if isinstance(x, (list, tuple)) else [x])]
        w0 = round_to(linears[0].weight.t(), dt)
        if self.split_first:
            y, off = None, 0
            for v in parts:
                c = v.shape[-1]
                part = v @ w0[off:off + c]
                y = part if y is None else y + part
                off += c
        else:
            y = torch.cat(parts, -1) @ w0
        y = y + linears[0].bias
        for lin in linears[1:]:
            h = round_to(torch.sin(self.omega0 * y), dt)
            y = h @ round_to(lin.weight.t(), dt) + lin.bias
        return round_to(y, dt)


def set_fused(model: nn.Module, fused: bool) -> None:
    """Turn the fused kernel on or off in every ``Siren`` of ``model``; a
    net with ``split_first`` stays off, since the kernel has no split-K
    form."""
    for m in model.modules():
        if isinstance(m, Siren):
            m.fused = fused and not m.split_first
