"""The port's LunaTokis variants vs the JAX package on the CPU at the tiny
config (nf 8, groups 2, 1 + 1 residual blocks, LR 8x8) with identical
converted parameters and perturbed DCN offsets. Bars: encoder features
2e-5, every forward 5e-5 (those of ``tests/test_model_parity.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stif_tpu.models import luna_tokis_variants as j_variants

from stif_tpu_torch.models import luna_tokis_variants as variants
from stif_tpu_torch.models.luna_tokis import LunaTokis
from torch_parity import load_into_port, random_params, t

TINY = dict(nf=8, groups=2, front_RBs=1, back_RBs=1)
H = W = 8
TIMES = np.asarray([0.0, 0.4, 1.0], np.float32)
NAMES = ["LunaTokisTrain", "LunaTokisS", "LunaTokisNoFlow", "LunaTokisZSM"]


def _clip(seed, B=1, N=2):
    return np.random.default_rng(seed).random((B, N, H, W, 3)).astype(
        np.float32)


def _pair(name, seed, N=2):
    """(JAX model, its numpy-filled parameters, the port's model loaded
    with them strictly)."""
    jm = getattr(j_variants, name)(**TINY)
    args = (jnp.zeros((1, N, H, W, 3)),)
    kw = {}
    if name != "LunaTokisZSM":
        args += (jnp.asarray([0.0, 0.5]),)
        kw = dict(n_inputs=N)
    params = random_params(jm, *args, seed=seed)
    pm = load_into_port(getattr(variants, name)(**TINY, **kw), params)
    return jm, params, pm


def _both(name, jm, params, pm, x, times=TIMES, **kw):
    if name == "LunaTokisZSM":
        want = jax.jit(jm.apply)(params, x)
        with torch.inference_mode():
            got = pm(t(x))
    else:
        want = jax.jit(lambda p, x, tt: jm.apply(p, x, tt, **kw))(
            params, x, times)
        with torch.inference_mode():
            got = pm(t(x), t(times), **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("name", NAMES)
def test_forward(name):
    jm, params, pm = _pair(name, seed=21)
    x = _clip(3)
    got, want = _both(name, jm, params, pm, x)
    shape = ((1, 3, 4 * H, 4 * W, 3) if name == "LunaTokisZSM"
             else (len(TIMES), 1, 4 * H, 4 * W, 3))
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, atol=5e-5)
    n_jax = sum(v.size for v in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in pm.parameters()) == n_jax


@pytest.mark.parametrize("name", NAMES[:3])
def test_forward_batch_per_sample_times_out_size(name):
    """A batch of two clips, each with its own query times (B, nt), at a
    non-integer output size."""
    jm, params, pm = _pair(name, seed=22)
    x = np.concatenate([_clip(4), _clip(5)])
    times = np.asarray([[0.0, 0.25], [0.6, 0.9]], np.float32)
    got, want = _both(name, jm, params, pm, x, times, out_size=(27, 30))
    assert got.shape == want.shape == (2, 2, 27, 30, 3)
    np.testing.assert_allclose(got, want, atol=5e-5)


@pytest.mark.parametrize("name", ["LunaTokisTrain", "LunaTokisNoFlow"])
def test_forward_three_input_frames(name):
    """N = 3: the input-frame field has 9 channels, and the first-layer
    widths follow ``n_inputs``."""
    jm, params, pm = _pair(name, seed=23, N=3)
    got, want = _both(name, jm, params, pm, _clip(6, N=3))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_encoder_features():
    """``LunaTokisTrain.gen_feat``: the shared encoder under the
    ``encoder.`` prefix."""
    jm, params, pm = _pair("LunaTokisTrain", seed=24)
    x = _clip(7)
    want = np.asarray(jax.jit(
        lambda p, x: jm.apply(p, x, method=jm.gen_feat))(params, x))
    with torch.inference_mode():
        got = pm.gen_feat(t(x)).numpy()
    assert got.shape == want.shape == (1, 3, H, W, TINY["nf"])
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert all(k.startswith(("encoder.", "feat_imnet.", "flow_imnet.",
                             "encode_imnet.")) for k in pm.state_dict())


def test_encoder_is_the_flagships():
    """The variants' encoder and ``LunaTokis.gen_feat`` are one piece of
    code: the same weights give the same features, bit for bit."""
    torch.manual_seed(0)
    train = variants.LunaTokisTrain(**TINY).eval()
    flagship = LunaTokis(**TINY).eval()
    flagship.load_state_dict(
        {k[len("encoder."):]: v for k, v in train.state_dict().items()
         if k.startswith("encoder.")}, strict=False)
    x = t(_clip(8))
    with torch.inference_mode():
        assert torch.equal(train.gen_feat(x), flagship.gen_feat(x))


def test_train_decode_of_given_features():
    jm, params, pm = _pair("LunaTokisTrain", seed=25)
    x = _clip(9)
    feat = np.random.default_rng(10).standard_normal(
        (1, 3, H, W, TINY["nf"])).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, f, x, tt: jm.apply(
        p, f, x, tt, method=jm.decode))(params, feat, x, TIMES))
    with torch.inference_mode():
        got = pm.decode(t(feat), t(x), t(TIMES)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5)
