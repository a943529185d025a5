"""Reduced-precision operands (the ``gather_dtype`` / ``stagec_dtype`` /
``mlp_dtype`` knobs): a tensor's values are rounded to a narrow dtype and
widened back to fp32, so whatever consumes them (an interpolation, a matrix
product) still computes and accumulates in fp32, as the JAX package's
``astype`` ahead of a gather or a ``preferred_element_type=float32`` product
does."""

from __future__ import annotations

import torch

_FP8_MAX = 448.0  # largest finite float8_e4m3fn


def round_to(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (to nearest, ties to even) and widened back
    to fp32; ``dtype`` None returns ``x`` itself.

    ``torch.float8_e4m3fn`` has no infinity. Beyond its range the two
    packages differ: the JAX package's cast rounds |v| <= 464 to 448 and gives
    NaN above; here the values are clamped to +-448 first, so the cast
    saturates whatever the device and the PyTorch version do on overflow.
    Inside +-448 both round alike.
    """
    if dtype is None:
        return x
    if dtype == torch.float8_e4m3fn:
        x = x.clamp(-_FP8_MAX, _FP8_MAX)
    return x.to(dtype).to(torch.float32)
