"""STIF's arbitrary-scale architecture (``LIIF_train``, the port's
``LunaTokisTrain``) on the CPU: the port against the benchmark's plain
reference (``benchmark/reference/liif_train.py``), the reference's fold
against the port's, the model served by ``InferencePipeline`` compiled and
eager, and the benchmark's count of its work.

Tiny config of ``tests/test_torch_variants.py`` (nf 8, groups 2, 1 + 1
residual blocks, LR 8x8), weights from ``torch_parity.random_params`` (DCN
offsets perturbed). Bars: port against reference 5e-5, the bar the port's
forwards are held to against the JAX package (``test_torch_variants.py``):
the two compute the same sums in other orders (fused gathers, the fold's
shifted slices, the SIREN on a field list, the encoder's convs); compiled
against eager and the two folds bitwise.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from stif_tpu.models import luna_tokis_variants as j_variants

from benchmark.reference import liif_train as ref
from benchmark.roofline import liif_train as work
from benchmark.roofline import model as model_work
from stif_tpu_torch.models.factory import define_g
from stif_tpu_torch.ops.fold import fold3x3
from stif_tpu_torch.runtime import InferencePipeline, ProgramCache
from torch_parity import load_into_port, random_params, replay_double

TINY = dict(nf=8, groups=2, front_RBs=1, back_RBs=1)
ARCH = {k: TINY[k] for k in ("nf", "groups", "front_RBs", "back_RBs")}
BAR = 5e-5


@pytest.fixture(scope="module")
def model():
    jm = j_variants.LunaTokisTrain(**TINY)
    params = random_params(jm, jnp.zeros((1, 2, 8, 8, 3)),
                           jnp.asarray([0.0, 0.5]), seed=31)
    return load_into_port(
        define_g({"network_G": {"which_model_G": "LIIF_train", **TINY}}),
        params)


def _clip(seed, B=1, h=8, w=8):
    return torch.from_numpy(np.random.default_rng(seed).random(
        (B, 2, h, w, 3)).astype(np.float32))


CASES = {
    "x4": (1, [0.0, 0.4, 1.0], None, 1 << 30),
    "blocks": (1, [0.3, 0.9], None, 100),
    "batch_per_sample_times_odd_size": (
        2, [[0.0, 0.25], [0.6, 0.9]], (27, 30), 200),
}


@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_reference(model, case):
    """The port's forward against the reference's, 5e-5; one case decodes
    in blocks, one at an output size no multiple of the LR size with a
    batch of two, each sample at its own times."""
    B, times, out_size, block = CASES[case]
    x = _clip(3, B)
    t = torch.tensor(times)
    with torch.inference_mode():
        got = model(x, t, out_size)
        want = ref.forward(model.state_dict(), ARCH, x, t,
                           out_size or (32, 32), block=block)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= BAR


@pytest.mark.parametrize("shape", [(1, 5, 7), (3, 12, 9), (2, 1, 1)])
def test_reference_fold_is_the_ports_bitwise(shape):
    """``F.fold(kernel_size=3, padding=1)`` on (B, 27, H*W) and the port's
    shifted-slice ``fold3x3`` on (B, H, W, 27) add each pixel's nine terms
    in one order: equal bit for bit."""
    B, H, W = shape
    p = torch.randn(B, H, W, 27, generator=torch.Generator().manual_seed(H))
    want = F.fold(p.reshape(B, H * W, 27).transpose(1, 2), (H, W),
                  kernel_size=3, padding=1).permute(0, 2, 3, 1)
    assert torch.equal(fold3x3(p), want)


def _pipes(model, **kw):
    return (InferencePipeline(model, device="cpu", bucket=4, compiled=
                              ProgramCache("cpu", capture=replay_double),
                              **kw),
            InferencePipeline(model, device="cpu", bucket=4, compiled=False,
                              **kw))


def test_pipeline_serves_it_compiled_as_eager(model):
    """``stage`` / ``stream`` and ``render_window`` through the program
    cache equal the eager pipeline bit for bit; the bucket's one program is
    captured on the first window and a warm bucket captures nothing."""
    comp, eager = _pipes(model)
    frames = [_clip(s, h=6, w=10)[0].numpy() for s in (4, 5, 6)]
    times = [0.0, 0.5, 0.75]
    want = list(eager.stream(eager.stage(f, times) for f in frames))
    got = list(comp.stream(comp.stage(f, times) for f in frames))
    assert comp.programs.captures == 1
    for g, w in zip(got, want):
        assert g.shape == (3, 24, 40, 3)
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(comp.render_window(frames[0], times),
                                  want[0])
    (program,) = comp.programs.programs.values()
    assert comp.programs.captures == 1 and program.replays == 4
    assert "local_ensemble" not in program.label


def test_pipeline_frames_are_the_models(model):
    """The pipeline's window is the model's forward at the padded size,
    cropped."""
    _, eager = _pipes(model)
    frames = _clip(7, h=6, w=10)[0].numpy()
    got = eager.render_window(frames, [0.25])
    x = torch.from_numpy(np.pad(frames, ((0, 0), (0, 2), (0, 2), (0, 0))))
    with torch.inference_mode():
        want = model(x[None], torch.tensor([0.25]), (32, 48))[:, 0]
    np.testing.assert_array_equal(got, want[:, :24, :40].numpy())


@pytest.mark.parametrize("mode", ["test_mode", "local_ensemble"])
def test_modes_it_lacks_are_refused_at_construction(model, mode):
    with pytest.raises(ValueError, match="test= or local_ensemble="):
        InferencePipeline(model, device="cpu", **{mode: True})


def test_work_by_hand():
    """``roofline/liif_train.py`` at LR 2x3, x2 (out 4x6), two times, nf 4,
    groups 1, 1 + 1 blocks: every FLOP and byte counted by hand."""
    arch = {"nf": 4, "groups": 1, "front_RBs": 1, "back_RBs": 1}
    unit = {"model": "liif_train", "arch": arch, "batch": 1, "lr": [2, 3],
            "nt": 2, "out": [4, 6]}
    q, rows = 24, 2 * 24
    # the nets: 3nf + 8 = 20 -> 64 -> 64 -> 64 -> 256 -> 128, once a query
    # (no time code); 128 + 20 + 1 = 149 -> ... -> 4 and 2 (128 + 18) = 292
    # -> 64 -> 64 -> 64 -> 256 -> 256 -> 27, once a query and time
    feat = 20 * 64 + 64 * 64 + 64 * 64 + 64 * 256 + 256 * 128
    macs = (149 * 64 + 64 * 64 + 64 * 64 + 64 * 256 + 256 * 4
            + 292 * 64 + 64 * 64 + 64 * 64 + 64 * 256 + 256 * 256 + 256 * 27)
    params = feat + macs + (64 * 3 + 256 + 128) + (64 * 3 + 256 + 4) + (
        64 * 3 + 256 * 2 + 27)
    fields = (q * 20 + rows * 128 + q * 20 + 2 + rows * (2 * 128 + 2 * 18))
    outs = q * 128 + rows * (4 + 27)
    flops = 2 * (q * feat + rows * macs)
    assert work.work_of(unit) == {"flops": flops,
                                  "bytes": 4 * (fields + outs + params)}
    # the encoder is the flagship's, counted by the same code; nothing of
    # the flagship's decoder (no bicubic skip)
    count, flagship = work.count(unit), model_work.stif(arch, 1, (2, 3), 2,
                                                         (4, 6))
    for part in ("convs", "dcn"):
        assert count.parts[part] == flagship.parts[part] > 0
    assert count.parts["resize"] == 0 and len(count.dcn_calls) == 42
    assert count.parts["siren"] == flops
    assert work.flops(unit) == count.flops
