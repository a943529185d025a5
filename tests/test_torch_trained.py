"""The trained deployed model (``weights/trained_best_G.pth``) at full width
in the port vs the JAX package on the CPU: strict load, exact checkpoint
conversion, and forward parity at LR 16x16, nt=2 (bar 1e-4: 11.3M trained
parameters through 45 residual blocks and 13 PCD alignments in fp32)."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stif_tpu.convert import flax_params_to_torch_state, load_pth_checkpoint
from stif_tpu.models import LunaTokis as JLunaTokis

from stif_tpu_torch.convert import jax_params_to_state_dict, load_pth
from stif_tpu_torch.models import LunaTokis
from torch_parity import t

PTH = Path(__file__).resolve().parents[1] / "weights" / "trained_best_G.pth"
HEAD = dict(rgb_skip=True, rgb_skip_bicubic=True)


@pytest.fixture(scope="module")
def jax_side():
    model = JLunaTokis(**HEAD)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 16, 16, 3)),
        jnp.zeros((2,)), method=model.full_init))
    return model, load_pth_checkpoint(str(PTH), shapes)


@pytest.fixture(scope="module")
def port_model():
    model = LunaTokis(**HEAD)
    load_pth(model, str(PTH))
    return model.eval()


def test_strict_load(port_model):
    state = port_model.state_dict()
    assert len(state) == 442
    assert sum(v.numel() for v in state.values()) == 11_312_698
    raw = torch.load(PTH, map_location="cpu", weights_only=True)
    for k, v in raw.items():
        assert torch.equal(state[k], v), k


def test_jax_params_round_trip(jax_side, port_model):
    """JAX params -> state dict reproduces the checkpoint exactly, agrees
    with the JAX package's own converter, and loads strictly."""
    _, params = jax_side
    state = jax_params_to_state_dict(params)
    raw = torch.load(PTH, map_location="cpu", weights_only=True)
    assert set(state) == set(raw)
    for k, v in raw.items():
        assert torch.equal(state[k], v), k
    ref = flax_params_to_torch_state(params)
    assert set(ref) == set(state)
    for k, v in ref.items():
        np.testing.assert_array_equal(state[k].numpy(), v)
    fresh = LunaTokis(**HEAD)
    fresh.load_state_dict(state, strict=True)


def test_trained_forward(jax_side, port_model):
    model, params = jax_side
    x = np.random.default_rng(0).random((1, 2, 16, 16, 3)).astype(np.float32)
    times = np.asarray([0.0, 0.5], np.float32)
    want = np.asarray(jax.jit(model.apply)(params, x, times))
    with torch.inference_mode():
        got = port_model(t(x), t(times)).numpy()
    assert got.shape == want.shape == (2, 1, 64, 64, 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4)
