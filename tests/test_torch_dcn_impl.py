"""The port's DCN implementation layer against the JAX package on the CPU:
the ``DeformConv2dFunction`` (the op the kernels carry on the card; on the
CPU its plain versions) forward and gradients against ``jax.grad`` of
``deform_conv2d`` with ``impl="patch"`` and ``impl="dense"``, against torch
autograd through the plain forward, ``set_dcn_impl`` / ``impl="auto"``
dispatch, ``dcn_shift_stats``, ``DCNSep(impl=, shift_bound=)`` and the small
``LunaTokis`` through the Function.

Bars: forward atol 2e-5 (fp32 sums over K*Cin terms in another order),
gradients 2e-5 x max|g|; the model 5e-5 end to end (those of
``tests/test_model_parity.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stif_tpu.models import LunaTokis as JLunaTokis
from stif_tpu.nn.dcn import DCNSep as JDCNSep
from stif_tpu.ops import deform_conv as jdc

from stif_tpu_torch.models import LunaTokis
from stif_tpu_torch.nn import DCNSep
from stif_tpu_torch.ops import deform_conv as dc
from torch_parity import load_into_port, random_params, t

ATOL = 2e-5
GRAD_RTOL = 2e-5  # of the gradient's largest magnitude

# (B, H, W, G, Cin, stride, dilation, offsets): the shapes of
# tests/test_torch_deform_conv.py
CASES = {
    "integer": (2, 7, 9, 4, 16, 1, 1, 0.0),
    "inside": (2, 7, 9, 8, 32, 1, 1, 0.45),
    "outside": (2, 7, 9, 4, 16, 1, 1, 6.0),
    "stride2": (2, 7, 9, 8, 16, 2, 1, 6.0),
    "dilation2": (2, 7, 9, 4, 8, 1, 2, 3.0),
}


def _inputs(rng, B, H, W, G, cin, stride, dilation, scale, cout=12, k=3,
            pad=1, bias=True):
    Ho = (H + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    Wo = (W + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    offset = rng.uniform(-scale, scale,
                         (B, Ho, Wo, G, k * k, 2)).astype(np.float32)
    mask = rng.random((B, Ho, Wo, G, k * k)).astype(np.float32)
    w_hwio = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32) if bias else None
    cot = rng.standard_normal((B, Ho, Wo, cout)).astype(np.float32)
    return x, offset, mask, w_hwio, b, cot


def _jax_value_and_grads(x, offset, mask, w_hwio, b, cot, **kw):
    """JAX forward and the gradients of sum(y * cot) with respect to x,
    offset, mask, weight (as OIHW) and bias."""
    def f(x_, o_, m_, w_, b_):
        y = jdc.deform_conv2d(x_, o_, m_, w_, b_, **kw)
        return jnp.sum(y * cot), y

    args = [jnp.asarray(v) for v in (x, offset, mask, w_hwio, b)]
    (_, y), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2, 3, 4), has_aux=True))(*args)
    grads = [np.asarray(g) for g in grads]
    grads[3] = grads[3].transpose(3, 2, 0, 1)
    return np.asarray(y), grads


def _port_value_and_grads(op, x, offset, mask, w_hwio, b, cot, **kw):
    """``op``'s forward and the gradients of sum(y * cot), on the CPU."""
    ts = [t(v).requires_grad_(True) for v in
          (x, offset, mask, w_hwio.transpose(3, 2, 0, 1))]
    bias = None if b is None else t(b).requires_grad_(True)
    y = op(*ts, bias, **kw)
    (y * t(cot)).sum().backward()
    grads = [v.grad.numpy() for v in ts]
    grads.append(None if bias is None else bias.grad.numpy())
    return y.detach().numpy(), grads


def _close_grads(got, want, names=("x", "offset", "mask", "weight", "bias")):
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(g, w, atol=GRAD_RTOL * max(
            1.0, np.abs(w).max()), err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_function_against_jax_patch(rng, case):
    """Forward and every gradient of the Function, impl="patch", against
    ``jax.grad`` of the JAX package's patch path."""
    B, H, W, G, cin, stride, dil, scale = CASES[case]
    inp = _inputs(rng, B, H, W, G, cin, stride, dil, scale)
    kw = dict(stride=stride, padding=1, dilation=dil, impl="patch")
    want, want_g = _jax_value_and_grads(*inp, **kw)
    got, got_g = _port_value_and_grads(dc.deform_conv2d, *inp, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    _close_grads(got_g, want_g)


@pytest.mark.parametrize("case,impl,bias", [
    ("outside", "patch", True),
    ("stride2", "patch", False),
    ("inside", "dense", True),
    ("integer", "dense", False),
])
def test_function_against_autograd_of_plain(rng, case, impl, bias):
    """The Function's explicit backward against torch autograd through the
    plain forward, with and without a bias (``dense`` at bound 2, offsets
    beyond it where the case has them)."""
    B, H, W, G, cin, stride, dil, scale = CASES[case]
    inp = _inputs(rng, B, H, W, G, cin, stride, dil, scale, bias=bias)
    kw = dict(stride=stride, dilation=dil, impl=impl, shift_bound=2)
    want, want_g = _port_value_and_grads(dc.deform_conv2d_plain, *inp, **kw)
    got, got_g = _port_value_and_grads(dc.deform_conv2d, *inp, **kw)
    np.testing.assert_allclose(got, want, atol=ATOL)
    _close_grads(got_g, want_g)


@pytest.mark.parametrize("shift_bound", [None, 1])
def test_function_gradcheck(shift_bound):
    """``torch.autograd.gradcheck`` in float64 on a 1x4x5 map, positions
    away from integers (finite differences do not cross a corner)."""
    rng = np.random.default_rng(3)
    G, cin, cout = 2, 4, 3
    x = torch.tensor(rng.standard_normal((1, 4, 5, cin)), dtype=torch.float64,
                     requires_grad=True)
    frac = rng.uniform(0.2, 0.8, (1, 4, 5, G, 9, 2))
    shift = rng.integers(-2, 3, (1, 4, 5, G, 9, 2))
    off = torch.tensor(frac + shift, dtype=torch.float64, requires_grad=True)
    mask = torch.tensor(rng.random((1, 4, 5, G, 9)), dtype=torch.float64,
                        requires_grad=True)
    w = torch.tensor(rng.standard_normal((cout, cin, 3, 3)) * 0.3,
                     dtype=torch.float64, requires_grad=True)
    b = torch.tensor(rng.standard_normal(cout), dtype=torch.float64,
                     requires_grad=True)
    geom = (1, 1, 1, shift_bound)
    assert torch.autograd.gradcheck(
        lambda *a: dc.DeformConv2dFunction.apply(*a, geom),
        (x, off, mask, w, b), eps=1e-6, atol=1e-7)


@pytest.mark.parametrize("scale,shift_bound", [(0.7, 3), (4.0, 2)])
def test_dense_against_jax_dense(rng, scale, shift_bound):
    """``impl="dense"`` against the JAX package's dense shift contraction,
    forward and gradients, with offsets inside the bound and beyond it (the
    clamp then changes the result: both packages clamp alike)."""
    inp = _inputs(rng, 2, 8, 10, 2, 8, 1, 1, scale)
    kw = dict(impl="dense", shift_bound=shift_bound)
    want, want_g = _jax_value_and_grads(*inp, **kw)
    got, got_g = _port_value_and_grads(dc.deform_conv2d, *inp, **kw)
    np.testing.assert_allclose(got, want, atol=ATOL)
    _close_grads(got_g, want_g)
    exact = float(dc.dcn_shift_stats(t(inp[1]))) <= shift_bound
    patch = np.asarray(jdc.deform_conv2d(*map(jnp.asarray, inp[:5]),
                                         impl="patch"))
    assert np.allclose(got, patch, atol=ATOL) == exact


@pytest.fixture
def restore_impl():
    yield
    dc.set_dcn_impl("patch")
    jdc.set_dcn_impl("patch")


def test_auto_follows_set_dcn_impl(rng, restore_impl):
    """``impl="auto"`` reads the module-wide default; ``set_dcn_impl``'s
    bound overrides the call site's, as in the JAX package."""
    x, off, mask, w, b, _ = _inputs(rng, 1, 8, 10, 2, 8, 1, 1, 4.0)
    args = (t(x), t(off), t(mask), t(w.transpose(3, 2, 0, 1)), t(b))
    jargs = [jnp.asarray(v) for v in (x, off, mask, w, b)]
    with torch.no_grad():
        auto = dc.deform_conv2d(*args)
        np.testing.assert_array_equal(
            auto.numpy(), dc.deform_conv2d(*args, impl="patch").numpy())
        dc.set_dcn_impl("dense", shift_bound=2)
        jdc.set_dcn_impl("dense", shift_bound=2)
        dense = dc.deform_conv2d(*args, shift_bound=6).numpy()
        np.testing.assert_array_equal(
            dense, dc.deform_conv2d(*args, impl="dense",
                                    shift_bound=2).numpy())
    np.testing.assert_allclose(dense, np.asarray(jdc.deform_conv2d(*jargs)),
                               atol=ATOL)
    assert not np.allclose(dense, auto.numpy(), atol=1e-3)


def test_dense_default_falls_back_on_strided_calls(rng, restore_impl):
    """With ``dense`` as the default, a stride-2 call under ``auto`` runs
    the exact reads; named, ``dense`` raises there."""
    x, off, mask, w, b, _ = _inputs(rng, 1, 8, 8, 2, 8, 2, 1, 1.0)
    args = (t(x), t(off), t(mask), t(w.transpose(3, 2, 0, 1)), t(b))
    with torch.no_grad():
        want = dc.deform_conv2d(*args, stride=2, impl="patch")
        dc.set_dcn_impl("dense")
        got = dc.deform_conv2d(*args, stride=2)
        assert got.shape == (1, 4, 4, 12)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        with pytest.raises(ValueError, match="stride-1"):
            dc.deform_conv2d(*args, stride=2, impl="dense")


def test_window_is_patch(rng, restore_impl):
    """``window`` (named, or the default under ``auto``) gives the exact
    values, which the JAX package's window gather equals."""
    x, off, mask, w, b, _ = _inputs(rng, 2, 10, 12, 2, 8, 1, 1, 2.0)
    args = (t(x), t(off), t(mask), t(w.transpose(3, 2, 0, 1)), t(b))
    with torch.no_grad():
        patch = dc.deform_conv2d(*args, impl="patch").numpy()
        named = dc.deform_conv2d(*args, impl="window", window=(6, 6)).numpy()
        dc.set_dcn_impl("window", window=(6, 6))
        auto = dc.deform_conv2d(*args).numpy()
    np.testing.assert_array_equal(named, patch)
    np.testing.assert_array_equal(auto, patch)
    want = np.asarray(jdc.deform_conv2d(
        *map(jnp.asarray, (x, off, mask, w, b)), impl="window",
        window=(6, 6)))
    np.testing.assert_allclose(named, want, atol=ATOL)


def test_unknown_impl_raises(rng):
    x, off, mask, w, b, _ = _inputs(rng, 1, 6, 6, 2, 8, 1, 1, 1.0)
    with pytest.raises(ValueError, match="impl"):
        dc.deform_conv2d(t(x), t(off), t(mask),
                         t(w.transpose(3, 2, 0, 1)), impl="gather")
    with pytest.raises(ValueError, match="impl"):
        dc.set_dcn_impl("auto")


@pytest.mark.parametrize("k,dilation,scale", [(3, 1, 5.0), (3, 2, 0.5),
                                              (5, 1, 2.0)])
def test_dcn_shift_stats(rng, k, dilation, scale):
    off = rng.uniform(-scale, scale, (2, 6, 7, 4, k * k, 2)).astype(
        np.float32)
    want = float(jdc.dcn_shift_stats(jnp.asarray(off), k, dilation))
    got = dc.dcn_shift_stats(t(off), k, dilation)
    assert got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-7)


@pytest.mark.parametrize("impl,shift_bound", [
    ("auto", 6), ("patch", 6), ("dense", 6), ("dense", 1), ("window", 6),
])
def test_dcn_sep_impl(rng, impl, shift_bound):
    """``DCNSep(impl=, shift_bound=)`` against the JAX ``DCNSep`` with the
    same attributes, perturbed offsets (about +-3 px, beyond a bound of 1),
    forward and the gradient of the input."""
    nf, G = 16, 4
    jm = JDCNSep(nf, deformable_groups=G, impl=impl, shift_bound=shift_bound)
    x = rng.standard_normal((1, 8, 10, nf)).astype(np.float32)
    fea = rng.standard_normal((1, 8, 10, nf)).astype(np.float32)
    cot = rng.standard_normal((1, 8, 10, nf)).astype(np.float32)
    params = random_params(jm, jnp.asarray(x), jnp.asarray(fea), seed=11)
    def f(x_):
        y = jm.apply(params, x_, jnp.asarray(fea))
        return jnp.sum(y * cot), y

    (_, want), want_gx = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jnp.asarray(x))
    want, want_gx = np.asarray(want), np.asarray(want_gx)
    pm = load_into_port(DCNSep(nf, nf, deformable_groups=G, impl=impl,
                               shift_bound=shift_bound), params)
    xt = t(x).requires_grad_(True)
    got = pm(xt, t(fea))
    (got * t(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_gx,
                               atol=GRAD_RTOL * np.abs(want_gx).max())


def _function_nodes(out):
    """The ``DeformConv2dFunction`` nodes of ``out``'s autograd graph."""
    seen, stack, n = set(), [out.grad_fn], 0
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        n += type(fn).__name__ == "DeformConv2dFunctionBackward"
        stack.extend(f for f, _ in fn.next_functions)
    return n


def test_luna_tokis_through_the_function():
    """The small LunaTokis (tests/test_model_parity.py's config) with grad
    mode on, so that every DCN records its Function, and the output within
    5e-5 of the JAX model. A pair runs 13 alignments of 6 DCNs: one in
    ``gen_feat`` and two per ConvLSTM step in each direction; the port runs
    the two directions as one batch, so 7 x 6 = 42 calls."""
    cfg = dict(nf=16, nframes=6, groups=4, front_RBs=2, back_RBs=2)
    H = W = 8
    jm = JLunaTokis(**cfg)
    params = random_params(jm, jnp.zeros((1, 2, H, W, 3)),
                           jnp.asarray([0.0, 0.5]), seed=42,
                           method=jm.full_init)
    x = np.random.default_rng(2).random((1, 2, H, W, 3)).astype(np.float32)
    times = np.asarray([0.0, 0.25, 1.0], np.float32)
    want = np.asarray(jax.jit(jm.apply)(params, x, times))
    pm = load_into_port(LunaTokis(**cfg), params)
    got = pm(t(x), t(times))
    assert got.requires_grad and _function_nodes(got) == 7 * 6
    np.testing.assert_allclose(got.detach().numpy(), want, atol=5e-5)
