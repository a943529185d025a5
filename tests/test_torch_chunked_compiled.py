"""The ``ChunkedDecoder``'s compiled passes (``runtime/chunked.py`` through
``runtime/compiled.py``) on the CPU.

The CPU has no CUDA graphs, so the decoder gets a ``ProgramCache`` whose
capture step is ``torch_parity.replay_double``: each replay runs the pass
again into the program's static outputs, reading its resident inputs in
place, as a graph reads them by address. Everything around the capture is
the code the card runs: the four programs and their keys, the copied and
resident inputs, the decoder's buffers kept per bucket, the per-chunk
copies, the one fetch at the end.

Small config of ``tests/test_torch_compiled.py`` (nf 16, groups 4, 2 + 2
residual blocks, ``rgb_skip`` bicubic), DCN offsets perturbed by
``torch_parity.random_params``, LR 8x12 -> 32x48 = 1536 queries. Bars:
compiled against eager bitwise; against the JAX ``ChunkedDecoder`` 5e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stif_tpu.models import LunaTokis as JLunaTokis
from stif_tpu.runtime.chunked import ChunkedDecoder as JChunkedDecoder

from stif_tpu_torch.models import LunaTokis
from stif_tpu_torch.nn import siren
from stif_tpu_torch.ops import capture, siren_apply_fused
from stif_tpu_torch.parallel import make_mesh
from stif_tpu_torch.runtime import (ChunkedDecoder, InferencePipeline,
                                    ProgramCache)
from torch_parity import load_into_port, random_params, replay_double

CFG = dict(nf=16, nframes=6, groups=4, front_RBs=2, back_RBs=2)
SKIP = dict(rgb_skip=True, rgb_skip_bicubic=True)
H, W = 8, 12
OUT = (4 * H, 4 * W)
TIMES = np.asarray([0.0, 0.3, 1.0], np.float32)
BAR = 5e-5


def double_cache():
    return ProgramCache("cpu", capture=replay_double)


@pytest.fixture(scope="module")
def setup():
    jm = JLunaTokis(**CFG, **SKIP)
    params = random_params(jm, jnp.zeros((1, 2, H, W, 3)),
                           jnp.asarray([0.0, 0.5]), seed=31,
                           method=jm.full_init)
    models = {k: load_into_port(LunaTokis(**CFG, **kw), params)
              for k, kw in (("skip", SKIP), ("no_skip", {}))}
    x = torch.from_numpy(np.random.default_rng(32).random(
        (2, 2, H, W, 3)).astype(np.float32))
    with torch.inference_mode():
        feat = models["skip"].gen_feat(x)
    return jm, params, models, feat, x


# case -> (model, batch, times, test mode, chunk); chunk 512 divides the
# 1536 queries (3 steps), 500 does not (4 steps, the last one padded)
CASES = {
    "b1": ("skip", 1, TIMES, False, 512),
    "b2": ("skip", 2, TIMES, False, 512),
    "per_sample_times": ("skip", 2, np.asarray([[0.0, 0.6], [0.9, 0.2]],
                                               np.float32), False, 512),
    "test_mode": ("skip", 1, TIMES, True, 512),
    "no_skip": ("no_skip", 1, TIMES, False, 512),
    "ragged_last_chunk": ("skip", 2, TIMES, False, 500),
}


def _decode(decoder, setup, case):
    _, _, _, feat, x = setup
    _, B, times, test, _ = CASES[case]
    return decoder.decode(feat[:B], x[:B], times, OUT, hr_inp_upsample=test)


@pytest.mark.parametrize("case", list(CASES))
def test_compiled_decode_equals_eager(setup, case):
    """Each case through the programs equals the eager decode bitwise on
    its first call (warm-ups, captures, replays) and on a second call of
    the bucket, which captures nothing: one program per pass (no skip
    program without the bicubic skip), each chunk a replay."""
    name, B, times, _, chunk = CASES[case]
    model = setup[2][name]
    eager = ChunkedDecoder(model, chunk, device="cpu", compiled=False)
    comp = ChunkedDecoder(model, chunk, device="cpu",
                          compiled=double_cache())
    want = _decode(eager, setup, case)
    assert want.shape == (times.shape[-1], B) + OUT + (3,)
    first = _decode(comp, setup, case)
    captures = comp.programs.captures
    assert captures == (3 if name == "no_skip" else 4)
    again = _decode(comp, setup, case)
    np.testing.assert_array_equal(first, want)
    np.testing.assert_array_equal(again, want)
    assert not np.shares_memory(first, again)  # not the decoder's buffer
    assert comp.programs.captures == captures
    steps = -(-OUT[0] * OUT[1] // chunk)
    replays = {st["key"].split()[0]: st["replays"]
               for st in comp.programs.stats()}
    assert replays == dict(prep=2, ab=2 * steps, cd=2 * steps,
                           **({} if name == "no_skip" else {"skip": 2}))


@pytest.mark.parametrize("test_mode", [False, True])
def test_compiled_decode_within_the_jax_bar(setup, test_mode):
    """The compiled decode against the JAX ``ChunkedDecoder`` on the same
    seeded parameters and features, chunk 500 (a padded last chunk)."""
    jm, params, models, feat, x = setup
    want = JChunkedDecoder(jm, params, chunk_size=500).decode(
        jnp.asarray(feat[:1].numpy()), jnp.asarray(x[:1].numpy()),
        jnp.asarray(TIMES), OUT, hr_inp_upsample=test_mode)
    got = ChunkedDecoder(models["skip"], 500, device="cpu",
                         compiled=double_cache()).decode(
        feat[:1], x[:1], TIMES, OUT, hr_inp_upsample=test_mode)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), atol=BAR)


def test_new_bucket_makes_new_programs(setup):
    """A new ``out_size`` is a new bucket: new programs and buffers, the old
    bucket's dropped; back to the first size captures again, and every
    decode equals the eager one. A decoder with another chunk has programs
    of its own."""
    _, _, models, feat, x = setup
    model = models["skip"]
    eager = ChunkedDecoder(model, 512, device="cpu", compiled=False)
    comp = ChunkedDecoder(model, 512, device="cpu", compiled=double_cache())
    small = (28, 40)
    for out_size, captures in ((OUT, 4), (small, 8), (OUT, 12)):
        got = comp.decode(feat[:1], x[:1], TIMES, out_size)
        np.testing.assert_array_equal(
            got, eager.decode(feat[:1], x[:1], TIMES, out_size))
        assert comp.programs.captures == captures
        assert len(comp.programs.programs) == 4
        held = comp.stats()["held_bytes"]
        nt_b, qp = len(TIMES), -(-out_size[0] * out_size[1] // 512) * 512
        # the field (nf 16 wide), flow and RGB fields are among the buffers
        assert held > nt_b * qp * (16 + 4 + 3) * 4
    assert eager.stats() == {"programs": None, "held_bytes": 0}
    other = ChunkedDecoder(model, 500, device="cpu", compiled=double_cache())
    np.testing.assert_array_equal(
        other.decode(feat[:1], x[:1], TIMES, OUT),
        eager.decode(feat[:1], x[:1], TIMES, OUT))
    assert other.programs.captures == 4
    assert any(st["key"].startswith("ab [(1, 500, 2)")
               for st in other.programs.stats())


class _Scale(torch.nn.Module):
    def forward(self, x, y):
        return x * y, x + y


def test_resident_input_at_a_new_address_is_a_new_key():
    """A resident input is read in place, not copied: a change to it in
    place shows in the next replay with no capture; the same values at
    another address make a new program. Both outputs of a tuple come back
    as the program's static outputs."""
    model, cache = _Scale(), double_cache()
    x = torch.arange(4.0)
    a, b = torch.full((4,), 2.0), torch.full((4,), 2.0)
    prod, total = cache.run("scale", model, (x,), model, resident=(a,))
    assert torch.equal(prod, x * 2) and torch.equal(total, x + 2)
    a.fill_(3.0)
    out = cache.run("scale", model, (x,), model, resident=(a,))
    assert torch.equal(out[0], x * 3) and out[0] is prod
    assert cache.captures == 1
    out = cache.run("scale", model, (x,), model, resident=(b,))
    assert torch.equal(out[0], x * 2) and cache.captures == 2
    cache.run("scale", model, (x,), model, resident=(a,))
    assert cache.captures == 2
    # a copied input of the same shape at a new address replays
    cache.run("scale", model, (x.clone(),), model, resident=(a,))
    assert cache.captures == 2


@pytest.fixture
def counted(monkeypatch):
    """The SIREN wrapper counting a launch per call, as it does on CUDA
    tensors (the CPU runs the plain version and counts none)."""
    def wrapper(*args, **kwargs):
        out = siren_apply_fused(*args, **kwargs)
        capture.launched(siren_apply_fused)
        return out

    monkeypatch.setattr(siren, "siren_apply_fused", wrapper)


def test_replays_add_three_launches_per_chunk_step(setup, counted):
    """The first decode counts its warm-ups (2 SIREN launches in A+B, 1 in
    C+D) and its replays; the captures none; each later decode 3 per chunk
    step, the programs' tallies, as the eager decode launches."""
    model = setup[2]["skip"]
    steps = 4  # chunk 500
    eager = ChunkedDecoder(model, 500, device="cpu", compiled=False)
    comp = ChunkedDecoder(model, 500, device="cpu", compiled=double_cache())
    n0 = siren_apply_fused.launches
    _decode(eager, setup, "ragged_last_chunk")
    assert siren_apply_fused.launches == n0 + 3 * steps
    n0 = siren_apply_fused.launches
    _decode(comp, setup, "ragged_last_chunk")
    assert siren_apply_fused.launches == n0 + 3 + 3 * steps
    launches = {st["key"].split()[0]: st["launches"]
                for st in comp.programs.stats()}
    assert launches == {"prep": {}, "ab": {"siren_apply_fused": 2},
                        "skip": {}, "cd": {"siren_apply_fused": 1}}
    for k in (1, 2):
        _decode(comp, setup, "ragged_last_chunk")
        assert siren_apply_fused.launches == n0 + 3 + 3 * steps * (1 + k)


def test_compiled_option_and_the_mesh(setup):
    """None and False decode eagerly on the CPU, True raises there; under a
    mesh of size > 1 the decode is eager with None and raises with True or
    a cache; a mesh of size 1 is no mesh and takes a cache."""
    model = setup[2]["skip"]
    assert ChunkedDecoder(model, device="cpu").programs is None
    assert ChunkedDecoder(model, device="cpu", compiled=False).programs is None
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        ChunkedDecoder(model, device="cpu", compiled=True)
    mesh = make_mesh({"model": 2}, [torch.device("cpu")] * 2)
    assert ChunkedDecoder(model, mesh=mesh).programs is None
    for compiled in (True, double_cache()):
        with pytest.raises(NotImplementedError, match="item 20"):
            ChunkedDecoder(model, mesh=mesh, compiled=compiled)
    one = make_mesh({"model": 1}, [torch.device("cpu")])
    cache = double_cache()
    assert ChunkedDecoder(model, device="cpu", mesh=one,
                          compiled=cache).programs is cache


def test_mesh_decode_equals_one_device(setup):
    """The eager mesh decode (two handles of the CPU) assembles the fields
    and the RGB in the decoder's buffers: bitwise the single-device
    compiled decode."""
    _, _, models, feat, x = setup
    mesh = make_mesh({"model": 2}, [torch.device("cpu")] * 2)
    got = ChunkedDecoder(models["skip"], 300, mesh=mesh).decode(
        feat, x, TIMES, OUT)
    want = ChunkedDecoder(models["skip"], 300, device="cpu",
                          compiled=double_cache()).decode(feat, x, TIMES, OUT)
    np.testing.assert_array_equal(got, want)


def test_failed_capture_raises_without_fallback(setup):
    """A capture that fails raises out of the decode; nothing is cached and
    no eager frames are handed back."""
    def broken(fn, inputs, cache):
        raise RuntimeError("capture failed")

    decoder = ChunkedDecoder(setup[2]["skip"], 512, device="cpu",
                             compiled=ProgramCache("cpu", capture=broken))
    with pytest.raises(RuntimeError, match="capture failed"):
        _decode(decoder, setup, "b1")
    assert decoder.programs.programs == {}
    assert decoder.programs.captures == 0
    assert capture.current() is None


def test_render_pairs_keeps_its_decoder(setup):
    """``render_pairs`` keeps one decoder across calls (its second call
    captures nothing), makes a new one when the chunk size changes, and a
    pipeline built with ``compiled=False`` decodes eagerly; every call
    equals the eager pipeline's frames bitwise."""
    model = setup[2]["skip"]
    comp = InferencePipeline(model, bucket=4, device="cpu",
                             compiled=double_cache())
    eager = InferencePipeline(model, bucket=4, device="cpu", compiled=False)
    pairs = np.random.default_rng(33).random((2, 2, 7, 10, 3)).astype(
        np.float32)
    times = list(TIMES)
    want = eager.render_pairs(pairs, times, chunk_size=600)
    assert eager._chunked.programs is None
    np.testing.assert_array_equal(
        comp.render_pairs(pairs, times, chunk_size=600), want)
    decoder = comp._chunked
    assert decoder.programs is not comp.programs
    assert decoder.programs.captures == 4
    np.testing.assert_array_equal(
        comp.render_pairs(pairs, times, chunk_size=600), want)
    assert comp._chunked is decoder and decoder.programs.captures == 4
    np.testing.assert_array_equal(
        comp.render_pairs(pairs, times, chunk_size=500),
        eager.render_pairs(pairs, times, chunk_size=500))
    assert comp._chunked is not decoder
    assert comp._chunked.programs.captures == 4
    assert comp.programs.captures == 1  # gen_feat, one bucket
