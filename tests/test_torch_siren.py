"""Port SIREN vs the JAX package on the CPU.

The plain ``siren_apply_fused`` (what the port's wrapper runs on a CPU
tensor) is held against the JAX Pallas kernel in interpret mode at the
decoder's real field splits, at atol 2e-5 (the bar of
``tests/test_siren_pallas.py``); the ``Siren`` module against the flax one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stif_tpu.nn.siren import Siren as JSiren
from stif_tpu.ops.siren_pallas import siren_apply_fused as j_siren_fused
from stif_tpu.ops.siren_pallas import siren_params_from_flax

from stif_tpu_torch.nn import Siren
from stif_tpu_torch.ops import siren_apply_fused, siren_apply_fused_plain
from stif_tpu_torch.ops.siren_fused import _field_layout
from torch_parity import load_into_port, t

ATOL = 2e-5

# the decoder's three nets: field splits, hidden widths, hidden layers, out
NETS = {
    "feat_imnet": ([200, 1], [64, 64, 256], 2, 64),
    "flow_imnet": ([64, 192, 6, 1], [64, 64, 256], 2, 4),
    "encode_imnet": ([64, 64, 192, 192, 6, 6, 1], [64, 64, 256, 256], 3, 3),
}


def _flax_net(name, seed):
    splits, hidden, n_hidden, out = NETS[name]
    model = JSiren(hidden, n_hidden, out, outermost_linear=True)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, sum(splits)), jnp.float32))
    return model, params, splits


@pytest.mark.parametrize("name", list(NETS))
@pytest.mark.parametrize("q", [333, 1024])
def test_plain_matches_pallas_interpret(rng, name, q):
    _, params, splits = _flax_net(name, seed=q)
    ws, bs = siren_params_from_flax(params["params"])
    xs = [rng.uniform(-1, 1, (q, c)).astype(np.float32) for c in splits]
    want = np.asarray(j_siren_fused([jnp.asarray(x) for x in xs], ws, bs,
                                    tile_q=256, interpret=True))
    before = siren_apply_fused.launches
    got = siren_apply_fused([t(x) for x in xs],
                            [t(np.asarray(w)) for w in ws],
                            [t(np.asarray(b)) for b in bs]).numpy()
    assert siren_apply_fused.launches == before  # CPU: plain, no launch
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("name", list(NETS))
def test_siren_module_matches_flax(rng, name):
    model, params, splits = _flax_net(name, seed=7)
    xs = [rng.uniform(-1, 1, (2, 50, c)).astype(np.float32) for c in splits]
    want = np.asarray(model.apply(params, jnp.concatenate(
        [jnp.asarray(x) for x in xs], -1)))
    _, hidden, n_hidden, out = NETS[name]
    pm = load_into_port(torch.nn.ModuleDict(
        {name: Siren(sum(splits), hidden, n_hidden, out)}),
        {name: params["params"]})[name]
    with torch.inference_mode():
        got = pm([t(x) for x in xs]).numpy()
        got_cat = pm(torch.cat([t(x) for x in xs], -1)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got_cat, got, atol=1e-6)


def test_broadcast_fields_equal_tiled(rng):
    """A field broadcast over a leading axis (the decoder's query-time
    tiling) is read in place: same result as the materialised tile."""
    nt, q = 3, 40
    base = t(rng.standard_normal((1, q, 200)).astype(np.float32))
    pe = t(rng.random((nt, 1, q, 1)).astype(np.float32))
    ws = [t(rng.standard_normal((201, 64)).astype(np.float32) * 0.05),
          t(rng.standard_normal((64, 5)).astype(np.float32) * 0.1)]
    bs = [t(rng.standard_normal(64).astype(np.float32)),
          t(rng.standard_normal(5).astype(np.float32))]
    got = siren_apply_fused([base.expand(nt, 1, q, 200), pe], ws, bs)
    want = siren_apply_fused_plain(
        [base.repeat(nt, 1, 1, 1), pe], ws, bs)
    assert got.shape == (nt, 1, q, 5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_field_layout():
    """(width, row_stride, period) the kernel is given for each field."""
    x = torch.zeros(2, 5, 7)
    assert _field_layout(x, 10) == (7, 7, 10)
    assert _field_layout(x.expand(3, 2, 5, 7), 30) == (7, 7, 10)
    c = torch.zeros(4, 6, 198)
    assert _field_layout(c[..., :192], 24) == (192, 198, 24)
    assert _field_layout(c[..., 192:], 24) == (6, 198, 24)
    with pytest.raises(ValueError):  # broadcast inside the rows
        _field_layout(torch.zeros(3, 1, 1).expand(3, 4, 1), 12)
    with pytest.raises(ValueError):  # column stride != 1
        _field_layout(torch.zeros(4, 6).t(), 6)


def test_no_fallback_off_cpu():
    """The wrapper computes the plain version only for CPU tensors; any
    other device launches the kernel or raises."""
    xs = [torch.zeros(4, 3, device="meta")]
    ws = [torch.zeros(3, 2, device="meta")]
    bs = [torch.zeros(2, device="meta")]
    with pytest.raises(ValueError):
        siren_apply_fused(xs, ws, bs)
