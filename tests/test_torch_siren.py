"""Port SIREN vs the JAX package on the CPU.

The plain ``siren_apply_fused`` (what the port's wrapper runs on a CPU
tensor) is held against the JAX Pallas kernel in interpret mode at the
decoder's real field splits, at atol 2e-5 (the bar of
``tests/test_siren_pallas.py``); the ``Siren`` module against the flax one.
The CUDA kernel's launch plan (``launch_plan``: the tile, each layer's
tensor-core tile width and K-chunks, shared memory) is pure Python and is
held here: its ragged edges, and that summing the first layer chunk by
chunk, as the kernel streams it, stays within 1e-6 of the plain version.
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
from stif_tpu_torch.ops.siren_fused import (
    MAX_SMEM_BYTES,
    _field_layout,
    chunk_rows,
    launch_plan,
)
from torch_parity import load_into_port, t

ATOL = 2e-5

# the decoder's three nets: field splits, hidden widths, hidden layers, out
NETS = {
    "feat_imnet": ([200, 1], [64, 64, 256], 2, 64),
    "flow_imnet": ([64, 192, 6, 1], [64, 64, 256], 2, 4),
    "encode_imnet": ([64, 64, 192, 192, 6, 6, 1], [64, 64, 256, 256], 3, 3),
}


# the model zoo's six nets (LunaTokisTrain's three, LunaTokisS's two,
# LunaTokisNoFlow's one) with the field splits their models hand over
ZOO_NETS = {
    "train_feat": ([200], [64, 64, 64, 256], 3, 128),
    "train_flow": ([128, 200, 1], [64, 64, 64, 256], 3, 4),
    "train_encode": ([128, 198, 128, 198], [64, 64, 64, 256, 256], 4, 27),
    "s_flow": ([200, 1], [64, 64, 256], 2, 4),
    "s_encode": ([192, 192, 6, 6], [64, 64, 256, 256], 3, 3),
    "noflow_feat": ([200, 1], [64, 64, 256, 256, 256], 4, 3),
}


def _flax_net(name, seed):
    splits, hidden, n_hidden, out = {**NETS, **ZOO_NETS}[name]
    model = JSiren(hidden, n_hidden, out, outermost_linear=True)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, sum(splits)), jnp.float32))
    return model, params, splits


@pytest.mark.parametrize("name", list(NETS) + list(ZOO_NETS))
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


# (field widths, layer widths with the input first): the decoder's nets,
# then odd ones
PLAN_CASES = {
    "feat_imnet": ([200, 1], [201, 64, 64, 256, 64]),
    "flow_imnet": ([64, 192, 6, 1], [263, 64, 64, 256, 4]),
    "encode_imnet": ([64, 64, 192, 192, 6, 6, 1],
                     [525, 64, 64, 256, 256, 3]),
    **{name: (splits, [sum(splits)] + hidden[:n_hidden + 1] + [out])
       for name, (splits, hidden, n_hidden, out) in ZOO_NETS.items()},
    "one_field_width_1": ([1], [1, 64, 3]),
    "k_under_one_chunk": ([3, 4], [7, 64, 64, 4]),
    "k_exact_chunks": ([100, 28], [128, 64, 256, 3]),
    "hidden_16": ([8], [8, 16, 4]),
    "out_5": ([200, 1], [201, 64, 5]),
    "first_layer_wide": ([20, 20], [40, 256, 256, 64]),
    "single_layer": ([9], [9, 3]),
    "width_128": ([33], [33, 128, 128, 4]),
    "width_27": ([5, 7], [12, 27, 27, 3]),
    "width_8": ([3], [3, 8, 8, 8]),
    "width_100": ([50, 51], [101, 100, 100, 2]),
    "ragged_chunks_27": ([9], [9, 27, 27, 27, 27]),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_launch_plan(case):
    splits, dims = PLAN_CASES[case]
    plan = launch_plan(splits, dims)
    n_layers = len(dims) - 1
    assert plan.tile_rows == 128 and plan.threads == 512
    assert len(plan.pitch) == len(plan.kc) == n_layers
    for l, (pitch, kc) in enumerate(zip(plan.pitch, plan.kc)):
        n = dims[l + 1]
        # every layer, a narrow last one too: its width rounded up to the
        # product's 8
        assert pitch % 8 == 0 and n <= pitch < n + 8
        assert kc == chunk_rows(pitch, max(plan.pitch))
        assert kc % 8 == 0 and 8 <= kc <= 32
        assert kc * pitch <= 2048  # one stage of the weight ring
    assert plan.tensor_core_layers == n_layers
    assert plan.smem_bytes <= MAX_SMEM_BYTES
    # each multiplier's activation slots: the widest layer, one per field
    slots = max([len(splits)] + [p // 8 for p in plan.pitch])
    assert plan.smem_bytes == 65664 + 2 * 2048 * slots
    flat = plan.flat()
    assert len(flat) == 3 + 2 * n_layers
    assert flat[:3] == [128, 512, plan.smem_bytes]
    assert flat[3::2] == list(plan.pitch) and flat[4::2] == list(plan.kc)


def test_launch_plan_decoder_nets_share_an_sm():
    """At the decoder's nets one block, two splitter and two multiplier
    warpgroups sharing the weights' stages, fits in an SM's 227 KB (less
    1 KB that the system keeps per block)."""
    for name in NETS:
        plan = launch_plan(*PLAN_CASES[name])
        assert plan.smem_bytes + 1024 <= 227 * 1024


def test_launch_plan_zoo_nets():
    """The six zoo nets: tile widths (each layer's own: a 128-wide last
    layer on a 128 tile, a 27-wide one on a 32 tile, 4 and 3 on an 8
    tile), K-chunks (16 rows, 8 at 256 wide: every net has a 256-wide
    layer), first-layer chunks (652 columns: 41, the last 12 wide) and the
    flagship's shared bytes, one block per SM."""
    want = {
        "train_feat": ((64, 64, 64, 256, 128), (16, 16, 16, 8, 16), 13),
        "train_flow": ((64, 64, 64, 256, 8), (16, 16, 16, 8, 16), 21),
        "train_encode": ((64, 64, 64, 256, 256, 32),
                         (16, 16, 16, 8, 8, 16), 41),
        "s_flow": ((64, 64, 256, 8), (16, 16, 8, 16), 13),
        "s_encode": ((64, 64, 256, 256, 8), (16, 16, 8, 8, 16), 25),
        "noflow_feat": ((64, 64, 256, 256, 256, 8),
                        (16, 16, 8, 8, 8, 16), 13),
    }
    for name, (pitch, kc, n_chunks) in want.items():
        splits, dims = PLAN_CASES[name]
        plan = launch_plan(splits, dims)
        assert (plan.pitch, plan.kc, -(-dims[0] // plan.kc[0])) == (
            pitch, kc, n_chunks), name
        assert plan.tensor_core_layers == len(pitch)
        assert plan.smem_bytes == 196736
        assert plan.smem_bytes + 1024 <= 227 * 1024
    assert PLAN_CASES["train_encode"][1][0] - 40 * 16 == 12


@pytest.mark.parametrize("splits,dims", [
    ([8], [8, 257, 4]),          # hidden width over 256
    ([8], [8, 16, 300]),         # output width over 256
    ([8], [9, 16, 4]),           # fields do not add up to the input width
    ([1] * 9, [9, 16, 4]),       # more than 8 fields
    ([8, 0], [8, 16, 4]),        # an empty field
    ([5000], [5000, 64, 4]),     # an input row wider than the kernel takes
])
def test_launch_plan_rejects(splits, dims):
    with pytest.raises(ValueError):
        launch_plan(splits, dims)


def _first_layer_chunk(xs, k0, kc):
    """Columns [k0, k0 + kc) of the concatenated row, gathered field by
    field as the kernel walks them (a column pair may straddle two)."""
    starts = np.cumsum([0] + [x.shape[1] for x in xs])
    cols = []
    for c in range(k0, min(k0 + kc, starts[-1])):
        f = int(np.searchsorted(starts, c, side="right")) - 1
        cols.append(xs[f][:, c - starts[f]])
    return torch.stack(cols, -1)


def test_chunked_first_layer_matches_plain(rng):
    """Summing the first layer chunk by chunk, kc[0] columns of the
    concatenated row at a time, each gathered from its fields as the kernel
    gathers it, changes only the summation order: within 1e-6 of the plain
    version at the three nets."""
    for name in NETS:
        splits, dims = PLAN_CASES[name]
        kc0 = launch_plan(splits, dims).kc[0]
        xs = [t(rng.uniform(-1, 1, (97, c)).astype(np.float32))
              for c in splits]
        ws, bs = [], []
        for i, (a, b) in enumerate(zip(dims, dims[1:])):
            bound = 1.0 / a if i == 0 else np.sqrt(6.0 / a) / 30.0
            ws.append(t(rng.uniform(-bound, bound, (a, b)).astype(np.float32)))
            bs.append(t((rng.uniform(-1, 1, b) / np.sqrt(a)).astype(
                np.float32)))
        h = torch.zeros(97, dims[1])
        k0 = 0
        while k0 < dims[0]:
            x = _first_layer_chunk(xs, k0, kc0)
            h = h + x @ ws[0][k0:k0 + x.shape[1]]
            k0 += x.shape[1]
        assert k0 == dims[0]
        h = torch.sin(30.0 * (h + bs[0]))
        got = siren_apply_fused_plain(h, ws[1:], bs[1:])
        want = siren_apply_fused_plain(xs, ws, bs)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
