"""The port's TMNet vs the JAX package on the CPU at the tiny config
(nf 8, groups 2, 1 + 1 residual blocks, LR 8x8), identical converted
parameters, every DCN offset conv perturbed (``layersAtB`` / ``layersCtB``
included): forward with and without query times within 5e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stif_tpu.models.tmnet import TMB as JTMB
from stif_tpu.models.tmnet import TMNet as JTMNet

from stif_tpu_torch.models.tmnet import TMB, TMNet
from stif_tpu_torch.ops import siren_apply_fused
from torch_parity import load_into_port, random_params, t

TINY = dict(nf=8, groups=2, front_RBs=1, back_RBs=1)
H = W = 8


@pytest.fixture(scope="module")
def pair():
    jm = JTMNet(**TINY)
    params = random_params(jm, jnp.zeros((1, 2, H, W, 3)),
                           jnp.asarray([[0.5]]), seed=41)
    return jm, params, load_into_port(TMNet(**TINY), params)


def _clip(seed, B=1, N=2):
    return np.random.default_rng(seed).random((B, N, H, W, 3)).astype(
        np.float32)


def test_offsets_are_perturbed(pair):
    _, _, pm = pair
    for name in ("layersAtB", "layersCtB"):
        assert getattr(pm, name).conv_offset_mask.weight.abs().max() > 0.1
    keys = set(pm.state_dict())
    assert "pcd_align.TMB_A_l1.t_process.4.weight" in keys
    assert "pcd_align.TMB_B_l3.t_process.0.bias" not in keys  # bias-free
    assert {"layersFusion.6.bias", "layersAtBOffset.2.weight"} <= keys


@pytest.mark.parametrize("case", ["one_time", "four_frames_five_times",
                                  "batch_of_two"])
def test_forward_with_times(pair, case):
    jm, params, pm = pair
    B, N, times = {
        "one_time": (1, 2, [[0.3]]),
        "four_frames_five_times": (1, 4, [[i / 6 for i in range(1, 6)]]),
        "batch_of_two": (2, 3, [[0.25, 0.5], [0.9, 0.1]]),
    }[case]
    x = _clip(1, B, N)
    tt = np.asarray(times, np.float32)
    want = np.asarray(jax.jit(jm.apply)(params, x, tt))
    before = siren_apply_fused.launches
    with torch.inference_mode():
        got = pm(t(x), t(tt)).numpy()
    assert siren_apply_fused.launches == before
    T = N + (N - 1) * tt.shape[1]
    assert got.shape == want.shape == (B, T, 4 * H, 4 * W, 3)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_forward_without_times(pair):
    """No times: one aligned frame between each pair, no modulation."""
    jm, params, pm = pair
    x = _clip(2, 1, 3)
    want = np.asarray(jax.jit(lambda p, x: jm.apply(p, x))(params, x))
    with torch.inference_mode():
        got = pm(t(x)).numpy()
    assert got.shape == want.shape == (1, 5, 4 * H, 4 * W, 3)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_head_is_64_wide_whatever_nf(pair):
    _, _, pm = pair
    assert pm.upconv2.weight.shape == (256, TINY["nf"], 3, 3)
    assert pm.HRconv.weight.shape == (64, 64, 3, 3)


def test_tmb():
    """feature * MLP(t), t a (B, 1, 1, 1) map through bias-free 1x1 convs."""
    jm = JTMB(8)
    x = np.random.default_rng(3).standard_normal((2, 6, 5, 8)).astype(
        np.float32)
    tt = np.asarray([0.4, -0.7], np.float32).reshape(2, 1, 1, 1)
    params = random_params(jm, jnp.asarray(x), jnp.asarray(tt), seed=42)
    pm = load_into_port(TMB(8), params)
    want = np.asarray(jm.apply(params, x, tt))
    with torch.inference_mode():
        got = pm(t(x), t(tt)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
