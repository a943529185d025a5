"""Port LunaTokis vs the JAX package on the CPU at a small config
(nf=16, groups=4, 2/2 residual blocks, LR 8x8) with identical weights.
Bars: encoder features 2e-5, full forward 5e-5 (those of
``tests/test_model_parity.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stif_tpu.models import LunaTokis as JLunaTokis
from stif_tpu.models.luna_tokis import _times_nb as j_times_nb

from stif_tpu_torch.models import LunaTokis
from stif_tpu_torch.models.luna_tokis import _times_nb
from torch_parity import load_into_port, random_params, t

CFG = dict(nf=16, nframes=6, groups=4, front_RBs=2, back_RBs=2)
H = W = 8


@pytest.fixture(scope="module")
def params():
    model = JLunaTokis(**CFG)
    return random_params(model, jnp.zeros((1, 2, H, W, 3)),
                         jnp.asarray([0.0, 0.5]), seed=42,
                         method=model.full_init)


def _pair(params, **kw):
    jm = JLunaTokis(**CFG, **kw)
    pm = load_into_port(LunaTokis(**CFG, **kw), params)
    return jm, pm


def _clip(seed):
    return np.random.default_rng(seed).random((1, 2, H, W, 3)).astype(
        np.float32)


def test_gen_feat(params):
    jm, pm = _pair(params)
    x = _clip(1)
    want = np.asarray(jax.jit(
        lambda p, x: jm.apply(p, x, method=jm.gen_feat))(params, x))
    with torch.inference_mode():
        got = pm.gen_feat(t(x)).numpy()
    assert got.shape == want.shape == (1, 3, H, W, CFG["nf"])
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("skip", ["off", "bicubic", "per_sample"])
def test_forward(params, skip):
    """Full forward; ``per_sample``: a batch of two clips, each with its own
    query times (B, nt), through the bicubic skip."""
    kw = ({} if skip == "off"
          else dict(rgb_skip=True, rgb_skip_bicubic=True))
    jm, pm = _pair(params, **kw)
    if skip == "per_sample":
        x = np.concatenate([_clip(2), _clip(5)])
        times = np.asarray([[0.0, 0.25, 1.0], [0.6, 0.1, 0.85]], np.float32)
    else:
        x = _clip(2)
        times = np.asarray([0.0, 0.25, 1.0], np.float32)
    want = np.asarray(jax.jit(jm.apply)(params, x, times))
    with torch.inference_mode():
        got = pm(t(x), t(times)).numpy()
    assert got.shape == want.shape == (3, len(x), 4 * H, 4 * W, 3)
    np.testing.assert_allclose(got, want, atol=5e-5)


@pytest.mark.parametrize("times", [[0.0, 0.3, 1.0], [[0.1, 0.9], [0.6, 0.3]]])
def test_times_nb(times):
    """Query times (nt,) shared by the batch, or per sample (B, nt), as
    (nt, B)."""
    want = np.asarray(j_times_nb(jnp.asarray(times), 2, jnp.float32))
    got = _times_nb(times, 2, "cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_decode_pixelshuffle(params):
    jm, pm = _pair(params)
    feat = np.random.default_rng(3).standard_normal(
        (1, 3, H, W, CFG["nf"])).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda p, f: jm.apply(p, f, method=jm.decode_pixelshuffle))(
            params, feat))
    with torch.inference_mode():
        got = pm.decode_pixelshuffle(t(feat)).numpy()
    assert got.shape == want.shape == (1, 3, 4 * H, 4 * W, 3)
    np.testing.assert_allclose(got, want, atol=2e-5)
