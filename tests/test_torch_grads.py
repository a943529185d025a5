"""Gradients of the port's losses and ops against the JAX package on the
CPU: the pixel criteria (values rtol 1e-6, gradients rtol 1e-5), and the
DCN and bilinear ``grid_sample`` gradients with respect to input, offsets,
mask, weight and grid, in and out of bounds."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stif_tpu.ops.deform_conv import deform_conv2d as j_deform_conv2d
from stif_tpu.ops.grid_sample import grid_sample as j_grid_sample
from stif_tpu.train import losses as jl

from stif_tpu_torch.ops import deform_conv2d, grid_sample
from stif_tpu_torch.train import losses
from torch_parity import t


def _grad(fn, *xs):
    """Value and gradients of a scalar torch function of numpy inputs."""
    ts = [t(x).requires_grad_(True) for x in xs]
    out = fn(*ts)
    out.backward()
    return out.item(), [v.grad.numpy() for v in ts]


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize("name", ["l1", "l2", "cb", "lp"])
def test_pixel_criterion(rng, name):
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    y = rng.random((2, 32, 32, 3)).astype(np.float32)
    jfn = jl.make_pixel_criterion(name)
    want, want_g = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(x),
                                                           jnp.asarray(y))
    got, got_g = _grad(losses.make_pixel_criterion(name), x, y)
    np.testing.assert_allclose(got, float(want), rtol=1e-6)
    for g, w in zip(got_g, want_g):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


def test_lap_loss_levels_and_kernel(rng):
    x = rng.random((1, 16, 16, 3)).astype(np.float32)
    y = rng.random((1, 16, 16, 3)).astype(np.float32)
    want = float(jl.lap_loss(jnp.asarray(x), jnp.asarray(y), max_levels=3,
                             k_size=3, sigma=1.5))
    got = losses.lap_loss(t(x), t(y), max_levels=3, k_size=3,
                          sigma=1.5).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(losses._gauss_kernel(5, 2.0),
                                  jl._gauss_kernel(5, 2.0))
    with pytest.raises(ValueError):
        losses.make_pixel_criterion("l3")


@pytest.mark.parametrize("where", ["integer", "inside", "outside"])
def test_deform_conv_gradients(rng, where):
    """Gradients with respect to input, offset, mask and weight: at integer
    sample points (zero offsets, as a fresh DCN starts), at fractional
    points inside the map, and with offsets of up to 6 px that send taps
    out of bounds."""
    B, H, W, G, cin, cout, k = 2, 6, 7, 2, 8, 6, 3
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    if where == "integer":
        offset = np.zeros((B, H, W, G, k * k, 2), np.float32)
    else:
        r = 0.45 if where == "inside" else 6.0
        offset = rng.uniform(-r, r, (B, H, W, G, k * k, 2)).astype(np.float32)
    mask = rng.random((B, H, W, G, k * k)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    cot = rng.standard_normal((B, H, W, cout)).astype(np.float32)

    def jf(x_, o_, m_, w_):
        y = j_deform_conv2d(x_, o_, m_, w_, None, impl="patch")
        return jnp.sum(y * cot)

    want = jax.grad(jf, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(v) for v in (x, offset, mask, w)))
    _, got = _grad(lambda x_, o_, m_, w_: torch.sum(deform_conv2d(
        x_, o_, m_, w_.permute(3, 2, 0, 1)) * t(cot)), x, offset, mask, w)
    for name, g, wv in zip(("x", "offset", "mask", "weight"), got, want):
        wv = np.asarray(wv)
        np.testing.assert_allclose(g, wv, atol=2e-5 * max(1, np.abs(wv).max()),
                                   err_msg=name)


@pytest.mark.parametrize("where", ["inside", "outside"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_gradients(rng, where, align_corners):
    """Bilinear ``grid_sample`` gradients with respect to source and grid
    (the flow net's path through ``warp_grid``), zeros padding, with every
    query in the map or a third of them outside it."""
    x = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)
    lim = 0.95 if where == "inside" else 1.4
    grid = rng.uniform(-lim, lim, (2, 40, 2)).astype(np.float32)
    cot = rng.standard_normal((2, 40, 4)).astype(np.float32)

    def jf(x_, g_):
        y = j_grid_sample(x_, g_, mode="bilinear",
                          align_corners=align_corners)
        return jnp.sum(y * cot)

    want = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(grid))
    _, got = _grad(lambda x_, g_: torch.sum(grid_sample(
        x_, g_, align_corners=align_corners) * t(cot)), x, grid)
    for name, g, wv in zip(("source", "grid"), got, want):
        np.testing.assert_allclose(g, np.asarray(wv), atol=2e-5,
                                   err_msg=name)
