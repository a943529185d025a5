"""The port's ablation family vs the JAX package on the CPU at the tiny
config (nf 8, groups 2, 1 + 1 residual blocks, LR 8x8), identical converted
parameters, perturbed DCN offsets: every preset's forward and
``decode_mulfeat`` within 5e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stif_tpu.models import ablations as j_ablations

from stif_tpu_torch.models import ablations, make_model
from stif_tpu_torch.nn import Siren
from torch_parity import load_into_port, random_params, t

TINY = dict(nf=8, groups=2, front_RBs=1, back_RBs=1)
H = W = 8
TIMES = np.asarray([0.25, 0.75], np.float32)
PRESETS = sorted(j_ablations._PRESETS)


def _clip(seed, N=2):
    return np.random.default_rng(seed).random((1, N, H, W, 3)).astype(
        np.float32)


def _pair(preset, seed, N=2):
    jm = j_ablations.make_ablation(preset, **TINY)
    params = random_params(jm, jnp.zeros((1, N, H, W, 3)),
                           jnp.asarray([0.0, 0.5]), seed=seed)
    pm = load_into_port(ablations.make_ablation(preset, n_inputs=N, **TINY),
                        params)
    return jm, params, pm


def test_presets_are_the_jax_packages():
    assert ablations._PRESETS == j_ablations._PRESETS


@pytest.mark.parametrize("preset", PRESETS)
def test_forward(preset):
    jm, params, pm = _pair(preset, seed=31)
    x = _clip(1)
    want = np.asarray(jax.jit(jm.apply)(params, x, TIMES))
    with torch.inference_mode():
        got = pm(t(x), t(TIMES)).numpy()
    assert got.shape == want.shape == (2, 1, 4 * H, 4 * W, 3)
    np.testing.assert_allclose(got, want, atol=5e-5)
    n_jax = sum(v.size for v in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in pm.parameters()) == n_jax


@pytest.mark.parametrize("preset", ["continuous", "single"])
def test_decode_non_integer_out_size(preset):
    """``continuous`` regathers the HR field bilinearly at the clamped
    query coordinates (no identity shortcut); ``single`` ends in its
    2-conv head."""
    jm, params, pm = _pair(preset, seed=32)
    x = _clip(2)
    feat = np.random.default_rng(3).standard_normal(
        (1, 3, H, W, TINY["nf"])).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, f, x, tt: jm.apply(
        p, f, x, tt, (19, 22), method=jm.decode))(params, feat, x, TIMES))
    with torch.inference_mode():
        got = pm.decode(t(feat), t(x), t(TIMES), (19, 22)).numpy()
    assert got.shape == want.shape == (2, 1, 19, 22, 3)
    np.testing.assert_allclose(got, want, atol=5e-5)


@pytest.mark.parametrize("preset", ["test4", "test5"])
def test_decode_mulfeat(preset):
    """Four input frames, 7 feature maps, three windows at their own time
    grids: 7 frames out. ``test5`` reads the 12-channel input field, so its
    first-layer widths are those of ``n_inputs=4``."""
    jm, params, pm = _pair(preset, seed=33, N=4)
    x = _clip(4, N=4)
    want = np.asarray(jax.jit(lambda p, x: jm.apply(
        p, x, None, mulfeat=True))(params, x))
    with torch.inference_mode():
        got = pm(t(x), None, mulfeat=True).numpy()
    assert got.shape == want.shape == (7, 1, 4 * H, 4 * W, 3)
    np.testing.assert_allclose(got, want, atol=5e-5)
    with torch.inference_mode(), pytest.raises(ValueError):
        pm.decode_mulfeat(pm.gen_feat(t(x))[:, :5], t(x))


def test_decode_mulfeat_window_times():
    jm, params, pm = _pair("test4", seed=34, N=4)
    x = _clip(5, N=4)
    wt = ([0.1], [0.3, 0.6], [1.0])
    feat = np.asarray(jax.jit(
        lambda p, x: jm.apply(p, x, method=jm.gen_feat))(params, x))
    want = np.asarray(jm.apply(params, feat, x, wt, (16, 16),
                               method=jm.decode_mulfeat))
    with torch.inference_mode():
        got = pm.decode_mulfeat(t(feat), t(x), wt, (16, 16)).numpy()
    assert got.shape == want.shape == (4, 1, 16, 16, 3)
    np.testing.assert_allclose(got, want, atol=5e-5)


@pytest.mark.parametrize("preset", PRESETS)
def test_registered_and_never_fused(preset):
    """``LIIF_<preset>`` builds through the registry; the nets are built
    off the fused kernel, as the JAX ablations never ask for theirs."""
    m = make_model(f"LIIF_{preset}", **TINY)
    assert isinstance(m, ablations.LunaTokisAblation)
    nets = [s for s in m.modules() if isinstance(s, Siren)]
    assert len(nets) == 3 and not any(s.fused for s in nets)
