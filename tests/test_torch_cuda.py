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


def test_kernel_rejects_bad_inputs(cuda, rng):
    ws, bs = _net(rng, [8], [16, 4], cuda)
    x = torch.zeros(10, 8, device=cuda)
    with pytest.raises(ValueError):  # float64 field
        siren_apply_fused([x.double()], ws, bs)
    with pytest.raises(ValueError):  # non-contiguous weight
        siren_apply_fused([x], [ws[0].t().contiguous().t(), ws[1]], bs)
    with pytest.raises(ValueError):  # column-strided field
        siren_apply_fused([torch.zeros(8, 10, device=cuda).t()], ws, bs)
