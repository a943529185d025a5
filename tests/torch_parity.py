"""Shared helpers for the port's parity tests (``tests/test_torch_*.py``).

JAX parameters are made without compiling an init: ``jax.eval_shape`` gives
the tree of shapes, and a numpy generator fills it at each kind's init scale.
Unlike the JAX init, the DCN ``conv_offset_mask`` gets non-zero weights, so
the deformable convs really deform (and sample out of bounds on the small
pyramid levels).
"""

from __future__ import annotations

import jax
import numpy as np
import torch


def _fill(path, shape, rng):
    names = [getattr(p, "key", str(p)) for p in path]
    if any(n.endswith("imnet") for n in names) and names[-1] == "kernel":
        fan_in = shape[0]
        bound = (1.0 / fan_in if "layer0" in names
                 else np.sqrt(6.0 / fan_in) / 30.0)
        return rng.uniform(-bound, bound, shape)
    if len(shape) == 4:  # conv kernel (kh, kw, cin, cout)
        fan_in = shape[0] * shape[1] * shape[2]
        scale = 3.0 if "conv_offset_mask" in names else 1.0
        return rng.uniform(-1, 1, shape) * scale / np.sqrt(fan_in)
    if "conv_offset_mask" in names:
        return rng.uniform(-1.0, 1.0, shape)
    return rng.uniform(-0.1, 0.1, shape)


def random_params(model, *init_args, seed: int = 0, method=None):
    """Numpy-filled parameters with the tree ``model.init`` would give."""
    kw = {} if method is None else {"method": method}
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), *init_args, **kw))
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    return jax.tree_util.tree_unflatten(
        treedef, [_fill(p, sd.shape, rng).astype(np.float32)
                  for p, sd in flat])


def load_into_port(port_model: torch.nn.Module, params) -> torch.nn.Module:
    """Load JAX params into a port module strictly; returns it in eval mode."""
    from stif_tpu_torch.convert import jax_params_to_state_dict

    port_model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return port_model.eval()


def t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))

