"""The port's CUDA kernel on the card: builds, agrees with its plain
version, and raises rather than falling back. Marked ``cuda``; skipped
where there is no GPU. Needs no JAX: on a GPU host without it, run
``python -m pytest tests/test_torch_cuda.py -q --noconftest``."""

import numpy as np
import pytest
import torch

from stif_tpu_torch.ops import siren_apply_fused, siren_apply_fused_plain

pytestmark = pytest.mark.cuda

NETS = {
    "feat_imnet": ([200, 1], [64, 64, 256, 64]),
    "flow_imnet": ([64, 192, 6, 1], [64, 64, 256, 4]),
    "encode_imnet": ([64, 64, 192, 192, 6, 6, 1], [64, 64, 256, 256, 3]),
}


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _net(rng, splits, widths, device):
    dims = [sum(splits)] + widths
    ws, bs = [], []
    for i in range(len(widths)):
        n = dims[i]
        bound = 1.0 / n if i == 0 else np.sqrt(6.0 / n) / 30.0
        ws.append(torch.tensor(rng.uniform(-bound, bound, (n, dims[i + 1])),
                               dtype=torch.float32, device=device))
        bs.append(torch.tensor(rng.uniform(-1, 1, dims[i + 1]) / np.sqrt(n),
                               dtype=torch.float32, device=device))
    return ws, bs


@pytest.mark.parametrize("name", list(NETS))
@pytest.mark.parametrize("q", [4097, 65536])
def test_kernel_matches_plain(cuda, rng, name, q):
    splits, widths = NETS[name]
    ws, bs = _net(rng, splits, widths, cuda)
    xs = [torch.tensor(rng.uniform(-1, 1, (q, c)), dtype=torch.float32,
                       device=cuda) for c in splits]
    before = siren_apply_fused.launches
    got = siren_apply_fused(xs, ws, bs)
    torch.cuda.synchronize()
    assert siren_apply_fused.launches == before + 1
    want = siren_apply_fused_plain(xs, ws, bs)
    assert (got - want).abs().max().item() <= 1e-4


def _decoder_fields(name, nt, Q, device):
    """One net's fields laid out as the decoder hands them over: ``expand``
    views over the time axis (row period Q), column slices of 198-wide
    tensors (row stride 198 floats: 8-byte-aligned rows), contiguous ones."""
    def r(*shape):
        return torch.rand(*shape, device=device) * 2 - 1

    def tile_t(v):
        return v.expand(nt, *v.shape)

    pe = r(nt, Q, 1)
    if name == "feat_imnet":
        return [tile_t(r(Q, 200)), pe]
    if name == "flow_imnet":
        q_b = r(Q, 198)
        return [r(nt, Q, 64), tile_t(q_b[..., :192]), tile_t(q_b[..., 192:]),
                pe]
    c1, c2 = r(nt, Q, 198), r(nt, Q, 198)
    return [r(nt, Q, 64), r(nt, Q, 64), c1[..., :192], c2[..., :192],
            c1[..., 192:], c2[..., 192:], pe]


@pytest.mark.parametrize("name", list(NETS))
@pytest.mark.parametrize("nt", [1, 3])
@pytest.mark.parametrize("Q", [1, 63, 64, 65, 65537])
def test_kernel_matches_plain_decoder_layouts(cuda, rng, name, nt, Q):
    """Strided column slices, fields broadcast over time (nt = 3: row period
    < rows) and ragged row counts around the 64-row tile."""
    splits, widths = NETS[name]
    ws, bs = _net(rng, splits, widths, cuda)
    torch.manual_seed(0)
    xs = _decoder_fields(name, nt, Q, cuda)
    assert [x.shape[-1] for x in xs] == splits
    got = siren_apply_fused(xs, ws, bs)
    torch.cuda.synchronize()
    want = siren_apply_fused_plain(xs, ws, bs)
    assert got.shape == want.shape == (nt, Q, widths[-1])
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("case", ["hidden_16", "out_5", "first_layer_wide",
                                  "single_layer", "k_exact_chunks"])
def test_kernel_matches_plain_odd_widths(cuda, rng, case):
    """Widths off the 64 / 256 tiles run padded; a lone layer is tiled."""
    splits, widths = {
        "hidden_16": ([8], [16, 4]),
        "out_5": ([200, 1], [64, 5]),
        "first_layer_wide": ([20, 20], [256, 256, 64]),
        "single_layer": ([9], [3]),
        "k_exact_chunks": ([100, 28], [64, 256, 3]),
    }[case]
    ws, bs = _net(rng, splits, widths, cuda)
    xs = [torch.tensor(rng.uniform(-1, 1, (1000, c)), dtype=torch.float32,
                       device=cuda) for c in splits]
    got = siren_apply_fused(xs, ws, bs)
    torch.cuda.synchronize()
    want = siren_apply_fused_plain(xs, ws, bs)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("scale", [1e2, 1e5, 1e8])
def test_kernel_sine(cuda, scale):
    """The kernel's sine against a float64 sine of the same fp32 argument
    (bar 5e-7; ``sinf`` itself is good to 2 ulp): inside its fast range
    (|x| <= 105615) and beyond, where it hands over to ``sinf``."""
    w0 = torch.full((1, 4), 1.0 / 30.0, device=cuda)
    ws = [w0, torch.eye(4, device=cuda)]
    bs = [torch.zeros(4, device=cuda)] * 2
    torch.manual_seed(0)
    x = (torch.rand(1 << 18, 1, device=cuda) * 2 - 1) * scale
    got = siren_apply_fused([x], ws, bs)
    torch.cuda.synchronize()
    arg = 30.0 * (x * w0)
    err = (got.double() - torch.sin(arg.double())).abs().max().item()
    assert err <= 5e-7


def test_kernel_rejects_bad_inputs(cuda, rng):
    ws, bs = _net(rng, [8], [16, 4], cuda)
    x = torch.zeros(10, 8, device=cuda)
    with pytest.raises(ValueError):  # float64 field
        siren_apply_fused([x.double()], ws, bs)
    with pytest.raises(ValueError):  # non-contiguous weight
        siren_apply_fused([x], [ws[0].t().contiguous().t(), ws[1]], bs)
    with pytest.raises(ValueError):  # column-strided field
        siren_apply_fused([torch.zeros(8, 10, device=cuda).t()], ws, bs)
