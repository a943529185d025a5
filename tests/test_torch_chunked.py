"""Port ``ChunkedDecoder`` and ``render_pairs`` on the CPU at a small config
(nf=16, groups=4, 2/2 residual blocks, LR 8x12, output 32x48 = 1536
queries). Bars: chunked against the port's full decode and against the JAX
package's ``ChunkedDecoder`` 2e-5 (both get the same features);
``render_pairs`` against ``render_window`` of each pair 3e-5."""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stif_tpu.models import LunaTokis as JLunaTokis
from stif_tpu.runtime.chunked import ChunkedDecoder as JChunkedDecoder
from stif_tpu.runtime.chunked import _base_grid_xy as j_base_grid_xy

from stif_tpu_torch.models import LunaTokis
from stif_tpu_torch.runtime import ChunkedDecoder, InferencePipeline
from stif_tpu_torch.runtime.chunked import _base_grid_xy
from torch_parity import load_into_port, random_params, t

CFG = dict(nf=16, nframes=6, groups=4, front_RBs=2, back_RBs=2)
SKIP = dict(rgb_skip=True, rgb_skip_bicubic=True)
H, W = 8, 12
OUT = (4 * H, 4 * W)
TIMES = np.asarray([0.0, 0.3, 1.0], np.float32)
ATOL = 2e-5


@pytest.fixture(scope="module")
def setup():
    jm = JLunaTokis(**CFG)
    params = random_params(jm, jnp.zeros((1, 2, H, W, 3)),
                           jnp.asarray([0.0, 0.5]), seed=21,
                           method=jm.full_init)
    x = np.random.default_rng(6).random((2, 2, H, W, 3)).astype(np.float32)
    feat = np.array(jax.jit(  # a writable copy
        lambda p, x: jm.apply(p, x, method=jm.gen_feat))(params, x))
    return params, x, feat


def _port(params, **kw):
    return load_into_port(LunaTokis(**CFG, **kw), params)


def test_base_grid_xy():
    np.testing.assert_array_equal(_base_grid_xy(5, 7), j_base_grid_xy(5, 7))


# chunk sizes: one that divides Q = 1536, one that does not (padded last
# chunk), one larger than Q
@pytest.mark.parametrize("chunk", [512, 500, 4096])
@pytest.mark.parametrize("case", ["bicubic_skip", "no_skip", "test_mode",
                                  "stagec_nearest", "batch_of_two"])
def test_chunked_matches_full_decode(setup, case, chunk):
    params, x, feat = setup
    kw = {"no_skip": {}, "stagec_nearest": dict(stagec_nearest=True, **SKIP)
          }.get(case, SKIP)
    B = 2 if case == "batch_of_two" else 1
    test_mode = case == "test_mode"
    pm = _port(params, **kw)
    with torch.inference_mode():
        want = pm.decode(t(feat[:B]), t(x[:B]), t(TIMES), out_size=OUT,
                         hr_inp_upsample=test_mode).numpy()
    got = ChunkedDecoder(pm, chunk_size=chunk, device="cpu").decode(
        feat[:B], x[:B], TIMES, OUT, hr_inp_upsample=test_mode)
    assert isinstance(got, np.ndarray)
    assert got.shape == want.shape == (len(TIMES), B) + OUT + (3,)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("case", ["bicubic_skip", "test_mode",
                                  "stagec_nearest", "gather_dtype_bf16"])
def test_chunked_matches_jax_chunked(setup, case):
    """Chunk 500 does not divide Q = 1536: 4 steps, the last one padded."""
    params, x, feat = setup
    pkw, jkw = {
        "stagec_nearest": (dict(stagec_nearest=True),) * 2,
        "gather_dtype_bf16": (dict(gather_dtype=torch.bfloat16),
                              dict(gather_dtype=jnp.bfloat16)),
    }.get(case, ({}, {}))
    test_mode = case == "test_mode"
    want = JChunkedDecoder(JLunaTokis(**CFG, **SKIP, **jkw), params,
                           chunk_size=500).decode(
        jnp.asarray(feat[:1]), jnp.asarray(x[:1]), jnp.asarray(TIMES), OUT,
        hr_inp_upsample=test_mode)
    got = ChunkedDecoder(_port(params, **SKIP, **pkw), chunk_size=500,
                         device="cpu").decode(
        feat[:1], x[:1], TIMES, OUT, hr_inp_upsample=test_mode)
    assert got.shape == want.shape
    if case == "gather_dtype_bf16":
        # the HR feature field is rounded to bf16 ahead of the stage-C
        # gathers: a last-bit difference there is a bf16 step after it, so
        # the bar is the knob's own (2e-2) with 99 % within 2e-5
        assert (np.abs(got - want) <= ATOL).mean() >= 0.99
        np.testing.assert_allclose(got, want, atol=2e-2)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_chunked_per_sample_times(setup):
    """Per-sample (B, nt) query times through the chunked stages."""
    params, x, feat = setup
    times = np.asarray([[0.0, 0.6], [0.9, 0.2]], np.float32)
    pm = _port(params, **SKIP)
    with torch.inference_mode():
        want = pm.decode(t(feat), t(x), t(times), out_size=OUT).numpy()
    got = ChunkedDecoder(pm, chunk_size=700, device="cpu").decode(
        feat, x, times, OUT)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_chunked_takes_no_mesh():
    """A mesh whose ``model`` axis has size 1 is the same as no mesh (one
    device, ``n_par`` 1), as in the JAX package; without a GPU the default
    device raises."""
    from stif_tpu_torch.parallel import default_mesh

    assert list(inspect.signature(ChunkedDecoder.__init__).parameters) == [
        "self", "model", "chunk_size", "device", "mesh", "mesh_axis"]
    dec = ChunkedDecoder(torch.nn.Identity(), device="cpu",
                         mesh=default_mesh(2, device_type="cpu"))
    assert dec.mesh is None and dec.n_par == 1
    assert dec.devices == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ChunkedDecoder(torch.nn.Identity())


@pytest.mark.parametrize("test_mode", [False, True])
def test_render_pairs(setup, test_mode):
    """Two different pairs at once against ``render_window`` of each; frames
    of 7x10 pad to the 8x12 bucket and are cropped after."""
    params, _, _ = setup
    pipe = InferencePipeline(_port(params, **SKIP), bucket=4, device="cpu",
                             test_mode=test_mode)
    pairs = np.random.default_rng(8).random((2, 2, 7, 10, 3)).astype(
        np.float32)
    got = pipe.render_pairs(pairs, list(TIMES), chunk_size=600)
    assert got.shape == (2, len(TIMES), 28, 40, 3)
    for b in range(2):
        want = pipe.render_window(pairs[b], list(TIMES))
        np.testing.assert_allclose(got[b], want, atol=3e-5)
    assert np.abs(got[0] - got[1]).max() > 1e-3
