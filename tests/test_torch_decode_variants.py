"""Port decode variants vs the JAX package on the CPU at a small config
(nf=16, groups=4, 2/2 residual blocks, LR 8x8) with identical weights:
the local ensemble, test mode (``hr_inp_upsample``), both together, a
non-integer output size, a batch of two, zoom windows (``decode_zoom``) and
``full_init``. The decoders get the same encoder features (the JAX
package's), so the bar is the decoder's own: atol 5e-5, that of the model
forward; the forward-level cases run both encoders too."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stif_tpu.models import LunaTokis as JLunaTokis
from stif_tpu.ops.coords import make_coord_demo as j_make_coord_demo

from stif_tpu_torch.models import LunaTokis, make_model
from stif_tpu_torch.nn import Siren
from stif_tpu_torch.ops import make_coord_demo
from stif_tpu_torch.ops.siren_fused import _field_layout
from stif_tpu_torch.runtime import ChunkedDecoder
from torch_parity import load_into_port, random_params, t

CFG = dict(nf=16, nframes=6, groups=4, front_RBs=2, back_RBs=2)
SKIP = dict(rgb_skip=True, rgb_skip_bicubic=True)
H = W = 8
TIMES = np.asarray([0.0, 0.4, 1.0], np.float32)
ATOL = 5e-5


@pytest.fixture(scope="module")
def setup():
    """Parameters, a batch of two clips and the JAX encoder's features."""
    jm = JLunaTokis(**CFG)
    params = random_params(jm, jnp.zeros((1, 2, H, W, 3)),
                           jnp.asarray([0.0, 0.5]), seed=11,
                           method=jm.full_init)
    x = np.random.default_rng(4).random((2, 2, H, W, 3)).astype(np.float32)
    feat = np.asarray(jax.jit(
        lambda p, x: jm.apply(p, x, method=jm.gen_feat))(params, x))
    return params, x, feat


def _decode_both(params, x, feat, model_kw, **decode_kw):
    jm = JLunaTokis(**CFG, **model_kw)
    pm = load_into_port(LunaTokis(**CFG, **model_kw), params)
    want = np.asarray(jax.jit(lambda p, f, x, tt: jm.apply(
        p, f, x, tt, method=jm.decode, **decode_kw))(params, feat, x, TIMES))
    with torch.inference_mode():
        got = pm.decode(t(feat), t(x), t(TIMES), **decode_kw).numpy()
    return got, want


@pytest.mark.parametrize("case", [
    "local_ensemble", "local_ensemble_lr_skip", "test_mode",
    "test_mode_local_ensemble", "non_integer_out_size", "batch_of_two",
    "batch_of_two_local_ensemble"])
def test_decode(setup, case):
    params, x, feat = setup
    model_kw = {"local_ensemble_lr_skip": dict(rgb_skip=True)}.get(case, SKIP)
    decode_kw = {
        "local_ensemble": dict(local_ensemble=True),
        "local_ensemble_lr_skip": dict(local_ensemble=True),
        "test_mode": dict(hr_inp_upsample=True),
        "test_mode_local_ensemble": dict(hr_inp_upsample=True,
                                         local_ensemble=True),
        "non_integer_out_size": dict(out_size=(27, 30)),
        "batch_of_two": {},
        "batch_of_two_local_ensemble": dict(local_ensemble=True),
    }[case]
    B = 2 if case.startswith("batch_of_two") else 1
    got, want = _decode_both(params, x[:B], feat[:B], model_kw, **decode_kw)
    HH, WW = decode_kw.get("out_size", (4 * H, 4 * W))
    assert got.shape == want.shape == (len(TIMES), B, HH, WW, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("path", ["full", "local_ensemble", "test_mode",
                                  "zoom", "stagec_dedup", "stagec_nearest",
                                  "chunked", "chunked_test_mode"])
def test_fields_are_layouts_the_kernel_reads(setup, path, B):
    """Every field that a decode path hands to a SIREN net is one that the
    fused kernel's wrapper reads in place (``_field_layout`` raises on any
    other), so the path runs on a CUDA tensor without a copy. The CPU runs
    the plain version, which takes any layout: this holds what it cannot."""
    params, x, feat = setup
    kw = {k: True for k in ("stagec_dedup", "stagec_nearest") if k == path}
    pm = load_into_port(LunaTokis(**CFG, **SKIP, **kw), params)
    seen = []

    def hook(_net, args):
        fields = args[0]
        q = fields[0].shape[:-1].numel()
        seen.append((q, [_field_layout(v, q) for v in fields]))

    for net in (pm.feat_imnet, pm.flow_imnet, pm.encode_imnet):
        net.register_forward_pre_hook(hook)
    f, xx, tt = t(feat[:B]), t(x[:B]), t(TIMES)
    with torch.inference_mode():
        if path == "zoom":
            pm.decode_zoom(f, xx, tt, (32, 40), (5, 7), (0.1, 0.2))
        elif path.startswith("chunked"):
            ChunkedDecoder(pm, 300, device="cpu").decode(
                f, xx, tt, (4 * H, 4 * W),
                hr_inp_upsample=path == "chunked_test_mode")
        else:
            pm.decode(f, xx, tt, local_ensemble=path == "local_ensemble",
                      hr_inp_upsample=path == "test_mode")
    steps = {"local_ensemble": 4, "chunked": 4, "chunked_test_mode": 4}
    assert len(seen) == 3 * steps.get(path, 1)
    # feat_imnet's time-independent field stays broadcast over the times:
    # its row period is B * Q of the nt * B * Q rows
    rows, layouts = seen[0]
    assert layouts[0][2] * len(TIMES) == rows


# model of the zoo -> SIREN calls of one forward
ZOO = {"LunaTokisTrain": 3, "LunaTokisS": 2, "LunaTokisNoFlow": 1,
       **{f"LIIF_{p}": 3 for p in ("test2", "test3", "test4", "test5",
                                   "nomul", "single", "continuous")},
       "LIIF_test4/mulfeat": 9, "LIIF_test5/mulfeat": 9}


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("name", list(ZOO))
def test_fields_are_layouts_the_kernel_reads_zoo(name, B):
    """The same for every SIREN call of every model of the zoo, the
    ablations (built off the kernel) and ``decode_mulfeat`` included: a list
    of at most 8 views that ``_field_layout`` takes, the time-independent
    ones still broadcast over the times."""
    name, _, mulfeat = name.partition("/")
    N = 4 if mulfeat else 2
    torch.manual_seed(0)
    pm = make_model(name, nf=8, groups=2, front_RBs=1, back_RBs=1,
                    n_inputs=N).eval()
    seen = []

    def hook(_net, args):
        fields = args[0]
        assert isinstance(fields, list) and 1 <= len(fields) <= 8
        q = fields[0].shape[:-1].numel()
        seen.append((q, [_field_layout(v, q) for v in fields]))

    nets = [m for m in pm.modules() if isinstance(m, Siren)]
    for net in nets:
        assert net.fused == (not name.startswith("LIIF_"))
        net.register_forward_pre_hook(hook)
    x = torch.rand(B, N, H, W, 3)
    with torch.inference_mode():
        if mulfeat:
            pm(x, None, mulfeat=True)
        else:
            pm(x, t(TIMES))
    assert len(seen) == ZOO[name + ("/mulfeat" if mulfeat else "")]
    rows, layouts = seen[0]
    nt = 2 if mulfeat else len(TIMES)
    assert rows == nt * B * 16 * H * W
    assert layouts[0][2] * nt == rows  # period B * Q


# (window, centre): even, odd, and one that underflows -1 and is shifted
ZOOMS = {
    "even": ((6, 8), (0.1, -0.2)),
    "odd": ((5, 7), (-0.3, 0.25)),
    "underflow": ((6, 7), (-0.95, -0.9)),
}


@pytest.mark.parametrize("case", list(ZOOMS))
def test_make_coord_demo(case):
    window, center = ZOOMS[case]
    want = np.asarray(j_make_coord_demo((32, 40), window, center))
    got = make_coord_demo((32, 40), window, center).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert (got.min() < -1 + 1e-3) == (case == "underflow")


@pytest.mark.parametrize("case", list(ZOOMS))
@pytest.mark.parametrize("test_mode", [False, True])
def test_decode_zoom(setup, case, test_mode):
    """Zoom windows of a virtual 32x40 canvas; under ``rgb_skip_bicubic`` an
    explicit window takes the LR skip."""
    params, x, feat = setup
    window, center = ZOOMS[case]
    jm = JLunaTokis(**CFG, **SKIP)
    pm = load_into_port(LunaTokis(**CFG, **SKIP), params)
    want = np.asarray(jax.jit(lambda p, f, x, tt: jm.apply(
        p, f, x, tt, (32, 40), window, center, test_mode,
        method=jm.decode_zoom))(params, feat[:1], x[:1], TIMES))
    with torch.inference_mode():
        got = pm.decode_zoom(t(feat[:1]), t(x[:1]), t(TIMES), (32, 40),
                             window, center,
                             hr_inp_upsample=test_mode).numpy()
    assert got.shape == want.shape == (len(TIMES), 1) + window + (3,)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_forward_test_mode_local_ensemble(setup):
    """``forward(test=True, local_ensemble=True)`` through both encoders."""
    params, x, _ = setup
    jm = JLunaTokis(**CFG, **SKIP)
    pm = load_into_port(LunaTokis(**CFG, **SKIP), params)
    want = np.asarray(jax.jit(lambda p, x, tt: jm.apply(
        p, x, tt, test=True, local_ensemble=True))(params, x[:1], TIMES))
    with torch.inference_mode():
        got = pm(t(x[:1]), t(TIMES), test=True, local_ensemble=True).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_full_init(setup):
    """``full_init`` returns the forward and the legacy pixel-shuffle head;
    every parameter of the JAX tree has its counterpart (strict load)."""
    params, x, _ = setup
    jm = JLunaTokis(**CFG)
    pm = load_into_port(LunaTokis(**CFG), params)
    want_out, want_legacy = jax.jit(lambda p, x, tt: jm.apply(
        p, x, tt, method=jm.full_init))(params, x[:1], TIMES)
    with torch.inference_mode():
        out, legacy = pm.full_init(t(x[:1]), t(TIMES))
    assert legacy.shape == (1, 3, 4 * H, 4 * W, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=ATOL)
    np.testing.assert_allclose(legacy.numpy(), np.asarray(want_legacy),
                               atol=ATOL)
    n_jax = sum(v.size for v in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in pm.parameters()) == n_jax
