"""Port InferencePipeline vs the JAX pipeline on the CPU, small config,
deployed head (rgb_skip bicubic). Bar: 5e-5, as for the model forward."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stif_tpu.models import LunaTokis as JLunaTokis
from stif_tpu.runtime import InferencePipeline as JInferencePipeline

from stif_tpu_torch.models import LunaTokis
from stif_tpu_torch.runtime import InferencePipeline
from torch_parity import load_into_port, random_params

CFG = dict(nf=16, nframes=6, groups=4, front_RBs=2, back_RBs=2,
           rgb_skip=True, rgb_skip_bicubic=True)
TIMES = [0.0, 0.5]


@pytest.fixture(scope="module")
def pipes():
    jm = JLunaTokis(**CFG)
    params = random_params(jm, jnp.zeros((1, 2, 8, 8, 3)),
                           jnp.asarray(TIMES), seed=5, method=jm.full_init)
    pm = load_into_port(LunaTokis(**CFG), params)
    # every window below pads to 16x16 (bucket 16): one JAX compile
    return (JInferencePipeline(jm, params),
            InferencePipeline(pm, device="cpu"))


def _frames(n, h, w, seed):
    return np.random.default_rng(seed).random((n, h, w, 3)).astype(np.float32)


def test_render_window(pipes):
    jp, pp = pipes
    frames = _frames(2, 12, 14, 0)  # padded to 16x16, cropped after
    want = jp.render_window(frames, TIMES)
    got = pp.render_window(frames, TIMES)
    assert got.shape == want.shape == (2, 48, 56, 3)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_render_window_self_ensemble(pipes):
    jp, pp = pipes
    frames = _frames(2, 12, 14, 1)
    jp.self_ensemble = pp.self_ensemble = True
    try:
        want = jp.render_window(frames, TIMES)
        got = pp.render_window(frames, TIMES)
    finally:
        jp.self_ensemble = pp.self_ensemble = False
    np.testing.assert_allclose(got, want, atol=5e-5)


@pytest.mark.parametrize("mode", ["test_mode", "local_ensemble"])
def test_decode_mode_set_after_construction(pipes, mode):
    """A decode mode set on a built pipeline is read at the next window:
    it renders what a pipeline built with the mode renders."""
    _, pp = pipes
    frames = _frames(2, 12, 14, 3)
    built = InferencePipeline(pp.model, device="cpu", **{mode: True})
    setattr(pp, mode, True)
    try:
        got = pp.render_window(frames, TIMES)
    finally:
        setattr(pp, mode, False)
    np.testing.assert_array_equal(got, built.render_window(frames, TIMES))
    assert np.abs(got - pp.render_window(frames, TIMES)).max() > 0


def test_render_sequence(pipes):
    jp, pp = pipes
    frames = _frames(3, 12, 14, 2)
    want = jp.render_sequence(frames, n_times=len(TIMES))
    got = pp.render_sequence(frames, n_times=len(TIMES))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=5e-5)


def test_device_defaults_to_cuda(pipes):
    """With no device given, the pipeline runs on CUDA, and raises rather
    than carry on on the CPU when there is no GPU."""
    model = pipes[1].model
    if torch.cuda.is_available():
        assert InferencePipeline(model).device.type == "cuda"
        model.to("cpu")
    else:
        with pytest.raises(RuntimeError):
            InferencePipeline(model)
