"""Port ops vs the JAX package on the CPU: coords, grid_sample, warp grids,
resamplers, pixel shuffle and the runtime's padding / window helpers.
Bar: atol 1e-5 (fp32; both sides compute the same formulas)."""

import numpy as np
import pytest

import jax.numpy as jnp

from stif_tpu.ops import resize as j_resize
from stif_tpu.ops.coords import make_coord as j_make_coord
from stif_tpu.ops.fold import fold3x3 as j_fold3x3
from stif_tpu.ops.grid_sample import grid_sample as j_grid_sample
from stif_tpu.ops.pixel_shuffle import pixel_shuffle as j_pixel_shuffle
from stif_tpu.ops.warp import warp_grid as j_warp_grid
from stif_tpu.runtime import pipeline as j_pipe

from stif_tpu_torch.ops import (
    grid_sample,
    imresize,
    imresize_to,
    make_coord,
    pixel_shuffle,
    resize_bilinear,
    warp_grid,
)
from stif_tpu_torch.ops.fold import fold3x3
from stif_tpu_torch.runtime import pad_to_multiple, window_plan
from torch_parity import t

ATOL = 1e-5


@pytest.mark.parametrize("shape,ranges,flatten", [
    ((5, 7), None, True),
    ((4, 6), ((-0.5, 1.0), (0.0, 2.0)), False),
    ((3, 2, 4), None, True),
])
def test_make_coord(shape, ranges, flatten):
    want = np.asarray(j_make_coord(shape, ranges, flatten=flatten))
    got = make_coord(shape, ranges, flatten=flatten).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _ties(n, align_corners, count):
    """Normalised coords whose unnormalised position is exactly k + 0.5."""
    k = np.arange(-1, n) + 0.5
    g = (k / (n - 1) * 2 - 1) if align_corners else ((2 * k + 1) / n - 1)
    return np.resize(g, count)


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("flat", [False, True])
def test_grid_sample(rng, mode, padding_mode, align_corners, flat):
    H, W = (8, 16) if not align_corners else (9, 17)
    x = rng.standard_normal((2, H, W, 5)).astype(np.float32)
    Hg, Wg = 6, 10
    n = Hg * Wg
    gx = rng.uniform(-1.3, 1.3, (2, n))
    gy = rng.uniform(-1.3, 1.3, (2, n))
    # exact half-pixel ties on a third of the points (nearest rounds half
    # to even on both sides)
    gx[:, ::3] = _ties(W, align_corners, gx[:, ::3].shape[1])
    gy[:, 1::3] = _ties(H, align_corners, gy[:, 1::3].shape[1])
    grid = np.stack([gx, gy], -1).astype(np.float32)
    grid = grid if flat else grid.reshape(2, Hg, Wg, 2)
    want = np.asarray(j_grid_sample(jnp.asarray(x), jnp.asarray(grid),
                                    mode=mode, padding_mode=padding_mode,
                                    align_corners=align_corners))
    got = grid_sample(t(x), t(grid), mode=mode, padding_mode=padding_mode,
                      align_corners=align_corners).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_grid_sample_rejects_unknown_mode(rng):
    x = t(rng.standard_normal((1, 4, 4, 2)).astype(np.float32))
    g = t(np.zeros((1, 3, 2), np.float32))
    with pytest.raises(ValueError):
        grid_sample(x, g, mode="bicubic")
    with pytest.raises(ValueError):
        grid_sample(x, g, padding_mode="reflection")


@pytest.mark.parametrize("hw", [(6, 9), (12, 4)])
def test_warp_grid(rng, hw):
    flow = rng.standard_normal((3,) + hw + (2,)).astype(np.float32) * 3
    want = np.asarray(j_warp_grid(jnp.asarray(flow)))
    got = warp_grid(t(flow)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("kw", [
    dict(scale_factor=2, align_corners=False),
    dict(scale_factor=4, align_corners=False),
    dict(size=(7, 5), align_corners=True),
    dict(size=(3, 13), align_corners=False),
])
def test_resize_bilinear(rng, kw):
    x = rng.standard_normal((2, 6, 8, 3)).astype(np.float32)
    want = np.asarray(j_resize.resize_bilinear(jnp.asarray(x), **kw))
    got = resize_bilinear(t(x), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("scale", [0.5, 0.25, 2.0, 4.0])
def test_imresize(rng, scale):
    x = rng.random((2, 16, 12, 3)).astype(np.float32)
    want = np.asarray(j_resize.imresize(jnp.asarray(x), scale))
    got = imresize(t(x), scale).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("out_hw", [(32, 48), (40, 20), (7, 30)])
def test_imresize_to(rng, out_hw):
    x = rng.random((1, 8, 12, 6)).astype(np.float32)
    want = np.asarray(j_resize.imresize_to(jnp.asarray(x), out_hw))
    got = imresize_to(t(x), out_hw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_resize_matrices_identical():
    """The port keeps its own copies of the matrix builders: they must be
    the JAX package's matrices, bit for bit."""
    from stif_tpu_torch.ops import resize as p_resize

    for args in [(16, 8, 0.5, True), (24, 96, 4.0, True), (9, 31, 31 / 9,
                                                          True)]:
        np.testing.assert_array_equal(p_resize._matlab_resize_matrix(*args),
                                      j_resize._matlab_resize_matrix(*args))
    for args in [(6, 12, False), (7, 3, True), (5, 5, False)]:
        np.testing.assert_array_equal(
            p_resize._bilinear_resize_matrix(*args),
            j_resize._bilinear_resize_matrix(*args))


@pytest.mark.parametrize("r", [2, 3])
def test_pixel_shuffle(rng, r):
    x = rng.standard_normal((2, 3, 5, 4 * r * r)).astype(np.float32)
    want = np.asarray(j_pixel_shuffle(jnp.asarray(x), r))
    got = pixel_shuffle(t(x), r).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(2, 5, 7, 27), (1, 1, 1, 9),
                                   (1, 2, 3, 18)])
def test_fold3x3(rng, shape):
    """Against the JAX function and against ``F.fold(kernel_size=3,
    padding=1)``, whose channel layout it keeps; bar 1e-6."""
    import torch.nn.functional as F

    x = rng.standard_normal(shape).astype(np.float32)
    got = fold3x3(t(x)).numpy()
    want = np.asarray(j_fold3x3(jnp.asarray(x)))
    B, H, W, C9 = shape
    assert got.shape == want.shape == (B, H, W, C9 // 9)
    np.testing.assert_allclose(got, want, atol=1e-6)
    cols = t(x).reshape(B, H * W, C9).transpose(1, 2)
    lib = F.fold(cols, (H, W), kernel_size=3, padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got, lib.numpy(), atol=1e-6)


@pytest.mark.parametrize("hw,multiple,bucket", [((5, 7), 4, 1),
                                                ((96, 150), 4, 16),
                                                ((16, 16), 4, 16)])
def test_pad_to_multiple(rng, hw, multiple, bucket):
    x = rng.random((2,) + hw + (3,)).astype(np.float32)
    want, want_hw = j_pipe.pad_to_multiple(x, multiple, bucket)
    got, got_hw = pad_to_multiple(x, multiple, bucket)
    assert got_hw == want_hw
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("n_out,len_in", [(7, 4), (7, 10), (5, 9), (3, 2)])
def test_window_plan(skip, n_out, len_in):
    assert window_plan(skip, n_out, len_in) == j_pipe.window_plan(
        skip, n_out, len_in)
