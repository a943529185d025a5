"""The reduced-precision and stage-C knobs of the port vs the JAX package on
the CPU.

Op level, identical inputs, atol 1e-5: ``grid_sample`` and ``deform_conv2d``
with bf16 and fp8 gather sources, ``Siren`` with ``compute_dtype`` and
``split_first``. Model level (nf=16, groups=2, 1/1 residual blocks, LR 8x8,
identical weights): each knob against the JAX model with the same knob at
the forward's 5e-5. Where a knob rounds values the model computed (a
last-bit difference ahead of a rounding is a whole step after it) the bar is
the knob's own, and for the gather sources 99 % of the output must still be
within 5e-5. Each knob is also held against the fp32 port under the JAX
package's own bars
(``tests/test_precision_modes.py``): bf16 gathers and bf16 MLP 2e-2,
split-K 1e-5, dedup bit-exact, nearest stage C in (0, 0.5), fp8 2e-1.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stif_tpu.models import LunaTokis as JLunaTokis
from stif_tpu.nn.siren import Siren as JSiren
from stif_tpu.ops.deform_conv import deform_conv2d as j_deform_conv2d
from stif_tpu.ops.grid_sample import grid_sample as j_grid_sample

from stif_tpu_torch.models import LunaTokis
from stif_tpu_torch.nn import Siren
from stif_tpu_torch.ops import deform_conv2d, grid_sample
from stif_tpu_torch.ops.precision import round_to
from torch_parity import load_into_port, random_params, t

DTYPES = {
    "bf16": (torch.bfloat16, jnp.bfloat16),
    "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
}
OP_ATOL = 1e-5


# ------------------------------------------------------------------ op level

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_round_to(rng, dtype):
    """Rounding to the narrow dtype and back agrees with the JAX cast value
    for value inside the dtype's range; fp8 saturates at +-448 beyond it."""
    td, jd = DTYPES[dtype]
    x = (rng.standard_normal(4096) * 20).astype(np.float32)
    want = np.asarray(jnp.asarray(x).astype(jd).astype(jnp.float32))
    np.testing.assert_array_equal(round_to(t(x), td).numpy(), want)
    assert round_to(t(x), None) is not None
    if dtype == "fp8":
        big = torch.tensor([1000.0, -500.0, 448.0, 465.0])
        np.testing.assert_array_equal(round_to(big, td).numpy(),
                                      [448.0, -448.0, 448.0, 448.0])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_source_dtype(rng, dtype, padding_mode):
    td, jd = DTYPES[dtype]
    x = rng.standard_normal((2, 7, 9, 5)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 40, 2)).astype(np.float32)
    want = np.asarray(j_grid_sample(jnp.asarray(x), jnp.asarray(grid),
                                    padding_mode=padding_mode,
                                    source_dtype=jd))
    got = grid_sample(t(x), t(grid), padding_mode=padding_mode,
                      source_dtype=td).numpy()
    np.testing.assert_allclose(got, want, atol=OP_ATOL)
    plain = grid_sample(t(x), t(grid), padding_mode=padding_mode).numpy()
    assert np.abs(got - plain).max() > 1e-4  # the source really was rounded


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_grid_sample_nearest_ignores_source_dtype(rng, dtype):
    td, jd = DTYPES[dtype]
    x = rng.standard_normal((1, 6, 6, 4)).astype(np.float32)
    grid = rng.uniform(-1, 1, (1, 30, 2)).astype(np.float32)
    got = grid_sample(t(x), t(grid), mode="nearest", source_dtype=td).numpy()
    np.testing.assert_array_equal(
        got, grid_sample(t(x), t(grid), mode="nearest").numpy())
    want = np.asarray(j_grid_sample(jnp.asarray(x), jnp.asarray(grid),
                                    mode="nearest", source_dtype=jd))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_deform_conv2d_gather_dtype(rng, dtype):
    td, jd = DTYPES[dtype]
    B, H, W, G, cin, cout, k = 2, 7, 9, 4, 16, 12, 3
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    offset = rng.uniform(-6, 6, (B, H, W, G, k * k, 2)).astype(np.float32)
    mask = rng.random((B, H, W, G, k * k)).astype(np.float32)
    w_hwio = rng.standard_normal((k, k, cin, cout)).astype(np.float32) * 0.1
    bias = rng.standard_normal(cout).astype(np.float32)
    want = np.asarray(j_deform_conv2d(
        jnp.asarray(x), jnp.asarray(offset), jnp.asarray(mask),
        jnp.asarray(w_hwio), jnp.asarray(bias), impl="patch",
        gather_dtype=jd))
    args = (t(offset), t(mask), t(w_hwio.transpose(3, 2, 0, 1)), t(bias))
    got = deform_conv2d(t(x), *args, gather_dtype=td).numpy()
    # the bar of the fp32 op (sums over K*Cin terms in another order)
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert np.abs(got - deform_conv2d(t(x), *args).numpy()).max() > 1e-4


SPLITS = [64, 64, 48, 48, 6, 6, 1]  # encode_imnet's fields at nf = 16


def _siren_pair(**kw):
    """A flax encode_imnet-shaped Siren and the port's with its weights;
    the port runs the plain version (``fused=False``)."""
    jkw = dict(kw)
    if "compute_dtype" in jkw:
        jkw["compute_dtype"] = jnp.bfloat16
    jm = JSiren([64, 64, 256, 256], 3, 3, outermost_linear=True, **jkw)
    params = jm.init(jax.random.PRNGKey(3),
                     jnp.zeros((1, sum(SPLITS)), jnp.float32))
    pm = load_into_port(torch.nn.ModuleDict({"encode_imnet": Siren(
        sum(SPLITS), [64, 64, 256, 256], 3, 3, fused=False, **kw)}),
        {"encode_imnet": params["params"]})["encode_imnet"]
    return jm, params, pm


@pytest.mark.parametrize("case", ["split_first", "compute_dtype",
                                  "compute_dtype_split_first"])
def test_siren_knobs(rng, case):
    kw = {}
    if "split_first" in case:
        kw["split_first"] = True
    if "compute_dtype" in case:
        kw["compute_dtype"] = torch.bfloat16
    jm, params, pm = _siren_pair(**kw)
    xs = [rng.uniform(-1, 1, (2, 40, c)).astype(np.float32) for c in SPLITS]
    want = np.asarray(jm.apply(params, tuple(jnp.asarray(x) for x in xs)))
    with torch.inference_mode():
        got = pm([t(x) for x in xs])
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=OP_ATOL)
    # against the fp32 plain version: the same up to fp32 sum order for
    # split-K, bf16-close under compute_dtype
    _, _, ref = _siren_pair()
    with torch.inference_mode():
        d = (got - ref([t(x) for x in xs])).abs().max().item()
    if "compute_dtype" in case:
        assert 1e-5 < d < 2e-2
    else:
        assert d < 1e-6


def test_siren_compute_dtype_single_tensor(rng):
    """A plain tensor input under ``split_first`` and ``compute_dtype``."""
    jm, params, pm = _siren_pair(split_first=True,
                                 compute_dtype=torch.bfloat16)
    x = rng.uniform(-1, 1, (30, sum(SPLITS))).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.inference_mode():
        got = pm(t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=OP_ATOL)


def test_siren_fused_split_first_raises():
    """The fused kernel has no split-K form: asking for both is an error,
    at construction and when ``fused`` is switched on later;
    ``compute_dtype`` takes precedence over ``fused`` and lifts it."""
    with pytest.raises(ValueError):
        Siren(20, [16, 16], 1, 3, split_first=True)
    with pytest.raises(ValueError):
        LunaTokis(nf=8, groups=2, front_RBs=1, back_RBs=1,
                  encode_splitk=True)
    net = Siren(20, [16, 16], 1, 3, fused=False, split_first=True)
    net.fused = True
    with pytest.raises(ValueError):
        net([torch.zeros(4, 12), torch.zeros(4, 8)])
    net = Siren(20, [16, 16], 1, 3, split_first=True,
                compute_dtype=torch.bfloat16)
    assert net([torch.zeros(4, 12), torch.zeros(4, 8)]).shape == (4, 3)


# --------------------------------------------------------------- model level

CFG = dict(nf=16, front_RBs=1, back_RBs=1, groups=2)
TIMES = np.asarray([0.25, 0.75], np.float32)

# knob -> (port kwargs, JAX kwargs, atol against the JAX model with the knob,
#          check of max|d| against the fp32 port); an atol above 5e-5 is the
#          knob's own bar, see the module docstring
KNOBS = {
    "gather_dtype_bf16": (dict(gather_dtype=torch.bfloat16),
                          dict(gather_dtype=jnp.bfloat16), 2e-2,
                          lambda d: 0 < d < 2e-2),
    "mlp_dtype_bf16": (dict(mlp_dtype=torch.bfloat16),
                       dict(mlp_dtype=jnp.bfloat16), 2e-2,
                       lambda d: 0 < d < 2e-2),
    "encode_splitk": (dict(encode_splitk=True, fused=False),
                      dict(encode_splitk=True), 5e-5, lambda d: d < 1e-5),
    "stagec_dedup": (dict(stagec_dedup=True), dict(stagec_dedup=True), 5e-5,
                     lambda d: d == 0.0),
    "stagec_nearest": (dict(stagec_nearest=True), dict(stagec_nearest=True),
                       5e-5, lambda d: 0 < d < 0.5),
    "stagec_dtype_fp8": (dict(stagec_dtype=torch.float8_e4m3fn),
                         dict(stagec_dtype=jnp.float8_e4m3fn), 2e-1,
                         lambda d: 0 < d < 2e-1),
}


@pytest.fixture(scope="module")
def tiny():
    jm = JLunaTokis(**CFG)
    x = np.random.default_rng(3).random((2, 2, 8, 8, 3)).astype(np.float32)
    params = random_params(jm, jnp.zeros((1, 2, 8, 8, 3)),
                           jnp.asarray(TIMES), seed=9, method=jm.full_init)
    pm = load_into_port(LunaTokis(**CFG), params)
    with torch.inference_mode():  # fp32 references at B = 1 and B = 2
        ref = {B: pm(t(x[:B]), t(TIMES)).numpy() for B in (1, 2)}
    return params, x, ref


@pytest.mark.parametrize("knob", list(KNOBS))
def test_model_knob(tiny, knob):
    params, x, ref = tiny
    port_kw, jax_kw, atol, within_bar = KNOBS[knob]
    pm = load_into_port(LunaTokis(**CFG, **port_kw), params)  # same schema
    with torch.inference_mode():
        got = pm(t(x[:1]), t(TIMES)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    d = float(np.abs(got - ref[1]).max())
    assert within_bar(d), d
    want = np.asarray(jax.jit(JLunaTokis(**CFG, **jax_kw).apply)(
        params, x[:1], TIMES))
    np.testing.assert_allclose(got, want, atol=atol)
    if knob != "mlp_dtype_bf16":
        assert (np.abs(got - want) <= 5e-5).mean() >= 0.99


def test_stagec_dedup_batched(tiny):
    """B = 2: the fold and unfold route each (time, batch) pair to its own
    queries; bit-equal to the tiled form."""
    params, x, ref = tiny
    pm = load_into_port(LunaTokis(**CFG, stagec_dedup=True), params)
    with torch.inference_mode():
        got = pm(t(x), t(TIMES)).numpy()
    np.testing.assert_array_equal(got, ref[2])


def test_stagec_nearest_skips_dedup(tiny):
    """With ``stagec_nearest`` the dedup fold is not taken, and both stage-C
    knobs are ignored in test mode (``hr_inp`` at HR resolution)."""
    params, x, _ = tiny

    def run(test=False, **kw):
        pm = load_into_port(LunaTokis(**CFG, **kw), params)
        with torch.inference_mode():
            return pm(t(x[:1]), t(TIMES), test=test).numpy()

    np.testing.assert_array_equal(
        run(stagec_nearest=True, stagec_dedup=True), run(stagec_nearest=True))
    np.testing.assert_array_equal(
        run(test=True, stagec_nearest=True, stagec_dedup=True),
        run(test=True))
