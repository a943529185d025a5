"""The per-bucket compiled programs (``runtime/compiled.py``) on the CPU.

The CPU has no CUDA graphs, so these tests hand the pipeline a
``ProgramCache`` whose capture step is a test double
(``torch_parity.replay_double``): a program that replays the callable into
its static output buffers with ``copy_``, as a graph replays its kernels
into the same addresses. Everything around the
capture is the code the card runs: the keys and routes, the static inputs,
the warm-up, the capture scope (store tensors held, launches tallied), the
copy out of the static output, the stale programs dropped.

Small config of ``tests/test_model_parity.py`` (nf 16, groups 4, 2 + 2
residual blocks, ``rgb_skip`` bicubic), DCN offsets perturbed by
``torch_parity.random_params``; TMNet at the tiny config of
``tests/test_torch_tmnet.py``. Bars: compiled against eager bitwise; against
the JAX pipeline 5e-5 (window and TMNet), as the eager port is held.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stif_tpu.models import LunaTokis as JLunaTokis
from stif_tpu.models.tmnet import TMNet as JTMNet
from stif_tpu.runtime import InferencePipeline as JInferencePipeline

from stif_tpu_torch.models import LunaTokis
from stif_tpu_torch.models.tmnet import TMNet
from stif_tpu_torch.nn.dcn import set_dcn_kernel
from stif_tpu_torch.nn.siren import set_fused
from stif_tpu_torch.ops import (capture, constants, dcn_forward,
                                set_dcn_impl, siren_apply_fused)
from stif_tpu_torch.runtime import InferencePipeline, ProgramCache, bench
from stif_tpu_torch.runtime.compiled import program_cache
from torch_parity import load_into_port, random_params, replay_double

CFG = dict(nf=16, nframes=6, groups=4, front_RBs=2, back_RBs=2,
           rgb_skip=True, rgb_skip_bicubic=True)
TINY_TM = dict(nf=8, groups=2, front_RBs=1, back_RBs=1)
TIMES = [0.0, 0.5]
BAR = 5e-5


def double_cache():
    return ProgramCache("cpu", capture=replay_double)


@pytest.fixture(scope="module")
def luna():
    jm = JLunaTokis(**CFG)
    params = random_params(jm, jnp.zeros((1, 2, 8, 8, 3)),
                           jnp.asarray(TIMES), seed=5, method=jm.full_init)
    return jm, params, load_into_port(LunaTokis(**CFG), params)


@pytest.fixture(scope="module")
def tmnet():
    jm = JTMNet(**TINY_TM)
    params = random_params(jm, jnp.zeros((1, 2, 8, 8, 3)),
                           jnp.asarray([[0.5]]), seed=41)
    return jm, params, load_into_port(TMNet(**TINY_TM), params)


def _frames(n, h, w, seed):
    return np.random.default_rng(seed).random((n, h, w, 3)).astype(np.float32)


def _pipes(model, **kw):
    """(compiled through the double, eager) pipelines of one model."""
    return (InferencePipeline(model, device="cpu", compiled=double_cache(),
                              **kw),
            InferencePipeline(model, device="cpu", compiled=False, **kw))


# 12x20 pads to 16x32: the self-ensemble's transpose makes a second bucket
PATHS = {"window": ({}, 1), "local_ensemble": ({"local_ensemble": True}, 1),
         "test_mode": ({"test_mode": True}, 1),
         "self_ensemble": ({"self_ensemble": True}, 2)}


@pytest.mark.parametrize("path", list(PATHS))
def test_compiled_window_equals_eager(luna, path):
    """Each window path through the cache equals the eager pipeline
    bitwise, on its first call (warm-up, capture, replay) and on a replay,
    with one program per bucket."""
    kw, buckets = PATHS[path]
    comp, eager = _pipes(luna[2], **kw)
    frames = _frames(2, 12, 20, 0)
    want = eager.render_window(frames, TIMES)
    first = comp.render_window(frames, TIMES)
    again = comp.render_window(frames, TIMES)
    np.testing.assert_array_equal(first, want)
    np.testing.assert_array_equal(again, want)
    assert comp.programs.captures == len(comp.programs.programs) == buckets
    assert sum(p.replays for p in comp.programs.programs.values()) == (
        2 * 8 if path == "self_ensemble" else 2)


def test_compiled_render_pairs_equals_eager(luna):
    """``render_pairs``' ``gen_feat`` through the cache (one program of the
    batch's bucket), the chunked decode through its own: bitwise."""
    comp, eager = _pipes(luna[2])
    pairs = np.stack([_frames(2, 12, 14, 3), _frames(2, 12, 14, 4)])
    want = eager.render_pairs(pairs, TIMES, chunk_size=100)
    for _ in range(2):
        np.testing.assert_array_equal(
            comp.render_pairs(pairs, TIMES, chunk_size=100), want)
    (program,) = comp.programs.programs.values()
    assert program.label.startswith("gen_feat [(2, 2, 16, 16, 3)]")
    assert program.replays == 2


def test_compiled_tmnet_equals_eager_and_jax(tmnet):
    """``render_window_tmnet`` through the cache, key ("tmnet", shape, t_N):
    bitwise the eager pipeline's, within 5e-5 of the JAX pipeline's."""
    jm, params, pm = tmnet
    comp, eager = _pipes(pm, bucket=4)
    frames = _frames(3, 8, 12, 5)
    times = [0.25, 0.75]
    want = eager.render_window_tmnet(frames, times)
    got = comp.render_window_tmnet(frames, times)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(comp.render_window_tmnet(frames, times),
                                  want)
    ref = JInferencePipeline(jm, params, bucket=4).render_window_tmnet(
        frames, times)
    assert got.shape == ref.shape == (7, 32, 48, 3)
    np.testing.assert_allclose(got, ref, atol=BAR)
    (program,) = comp.programs.programs.values()
    assert program.label.startswith("tmnet [(1, 3, 8, 12, 3), (1, 2)]")


def test_compiled_window_within_the_jax_bar(luna):
    """The compiled window and sequence against the JAX pipeline, 5e-5."""
    jm, params, pm = luna
    comp, _ = _pipes(pm)
    jp = JInferencePipeline(jm, params)
    frames = _frames(3, 12, 14, 6)
    np.testing.assert_allclose(comp.render_window(frames[:2], TIMES),
                               jp.render_window(frames[:2], TIMES), atol=BAR)
    for got, want in zip(comp.render_sequence(frames, n_times=2),
                         jp.render_sequence(frames, n_times=2)):
        np.testing.assert_allclose(got, want, atol=BAR)


def test_sequence_and_stream_equal_the_windows_bitwise(luna):
    """``render_sequence`` and ``stream`` over 4 distinct pairs launch
    window i + 1, whose replay writes over the program's output, before
    they fetch window i: each window's frames are copied out first, so they
    equal ``render_window`` pair by pair, bitwise."""
    comp, eager = _pipes(luna[2])
    frames = _frames(5, 12, 14, 7)
    want = [eager.render_window(frames[i:i + 2], TIMES) for i in range(4)]
    seq = comp.render_sequence(frames, n_times=2)
    streamed = list(comp.stream(comp.stage(frames[i:i + 2], TIMES)
                                for i in range(4)))
    assert len(seq) == len(streamed) == 4
    for i in range(4):
        np.testing.assert_array_equal(seq[i], want[i])
        np.testing.assert_array_equal(streamed[i], want[i])
        np.testing.assert_array_equal(
            comp.render_window(frames[i:i + 2], TIMES), want[i])
    assert comp.programs.captures == 1


def test_buckets_replayed_out_of_capture_order(luna):
    """Three buckets captured in one order and replayed in others give the
    eager frames."""
    comp, eager = _pipes(luna[2])
    clips = [_frames(2, h, w, 8 + i)
             for i, (h, w) in enumerate([(12, 14), (20, 14), (12, 30)])]
    want = [eager.render_window(c, TIMES) for c in clips]
    for order in ([0, 1, 2], [2, 0, 1], [1, 2, 0, 2, 1]):
        for i in order:
            np.testing.assert_array_equal(comp.render_window(clips[i], TIMES),
                                          want[i])
    assert comp.programs.captures == 3


def test_program_holds_store_tensors_past_the_store_bound(luna):
    """With the store bounded to one entry, the constants a program's
    capture read are dropped from the store but live as long as the
    program: its graph would read them by address."""
    store = constants.STORE
    bound = store.max_bytes
    store.clear()
    store.max_bytes = 1
    try:
        comp, eager = _pipes(luna[2])
        frames = _frames(2, 12, 14, 9)
        want = eager.render_window(frames, TIMES)
        np.testing.assert_array_equal(comp.render_window(frames, TIMES), want)
        (program,) = comp.programs.programs.values()
        assert len(program.held) > 4
        assert store.stats()["cpu"]["entries"] == 1
        refs = [weakref.ref(v) for v in program.held]
        store.clear()
        gc.collect()
        assert all(r() is not None for r in refs)
        np.testing.assert_array_equal(comp.render_window(frames, TIMES), want)
        del comp, program
        gc.collect()
        assert all(r() is None for r in refs)
    finally:
        store.max_bytes = bound
        store.clear()


class _Counting(torch.nn.Module):
    """Says it launched one SIREN and two DCN kernels per call."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((3,), 2.0))

    def forward(self, x):
        capture.launched(siren_apply_fused)
        capture.launched(dcn_forward)
        capture.launched(dcn_forward)
        return x * self.w


def test_launch_counters_count_replays_not_captures():
    """The warm-up's launches count (they run), the capture's do not (its
    tally goes to the program), and each replay adds the tally."""
    model, cache = _Counting(), double_cache()
    x = torch.ones(3)

    def counts():
        return siren_apply_fused.launches, dcn_forward.launches

    s0, d0 = counts()
    out = cache.run("count", model, (x,), model)
    (program,) = cache.programs.values()
    assert program.launches == {siren_apply_fused: 1, dcn_forward: 2}
    assert counts() == (s0 + 2, d0 + 4)  # warm-up + first replay
    for k in range(1, 4):
        cache.run("count", model, (x,), model)
        assert counts() == (s0 + 2 + k, d0 + 4 + 2 * k)
    assert torch.equal(out, torch.full((3,), 2.0))
    assert program.replays == 4


@pytest.mark.parametrize("switch", ["set_fused", "set_dcn_impl",
                                    "set_dcn_kernel", "to"])
def test_route_switch_makes_a_new_key(luna, switch):
    """A switch after a capture (a graph holds the old kernels and
    pointers) makes the next call capture anew; the stale program is
    dropped; the frames equal the eager pipeline's."""
    model = luna[2]
    comp, eager = _pipes(model)
    frames = _frames(2, 12, 14, 10)
    want = eager.render_window(frames, TIMES)
    comp.render_window(frames, TIMES)
    old = [p.data for p in model.parameters()]
    if switch == "set_fused":
        set_fused(model, True)
    elif switch == "set_dcn_impl":
        set_dcn_impl("patch")
    elif switch == "set_dcn_kernel":
        set_dcn_kernel(model, True)
    else:  # new pointers, the same values: the old tensors are kept alive
        model.to(torch.float64).to(torch.float32)
        assert all(p.data_ptr() != o.data_ptr()
                   for p, o in zip(model.parameters(), old))
    np.testing.assert_array_equal(comp.render_window(frames, TIMES), want)
    assert comp.programs.captures == 2
    assert len(comp.programs.programs) == 1


def test_load_state_dict_keeps_the_key_and_shows_new_weights(luna):
    """Weights loaded in place keep their addresses: no new capture, and
    the next window shows the new weights."""
    model = LunaTokis(**CFG)
    model.load_state_dict(luna[2].state_dict())
    comp, eager = _pipes(model)
    frames = _frames(2, 12, 14, 11)
    before = comp.render_window(frames, TIMES)
    rng = np.random.default_rng(12)
    state = {k: v * torch.from_numpy(
        rng.uniform(0.9, 1.1, tuple(v.shape)).astype(np.float32))
        for k, v in model.state_dict().items()}
    model.load_state_dict(state)
    got = comp.render_window(frames, TIMES)
    np.testing.assert_array_equal(got, eager.render_window(frames, TIMES))
    assert np.abs(got - before).max() > 1e-3
    assert comp.programs.captures == 1


def test_failed_capture_raises_without_fallback(luna):
    """A capture that fails raises out of the pipeline; nothing is cached
    and no eager frames are handed back."""
    def broken(fn, inputs, cache):
        raise RuntimeError("capture failed")

    pipe = InferencePipeline(luna[2], device="cpu",
                             compiled=ProgramCache("cpu", capture=broken))
    with pytest.raises(RuntimeError, match="capture failed"):
        pipe.render_window(_frames(2, 12, 14, 13), TIMES)
    assert pipe.programs.programs == {} and pipe.programs.captures == 0
    assert capture.current() is None


def test_compiled_option():
    """None: graphs on a CUDA device, eager on the CPU; False: eager; True
    off a CUDA device raises; a cache is used as it is."""
    model = _Counting()
    assert program_cache("cpu") is None
    assert program_cache("cpu", False) is None
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        program_cache("cpu", True)
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        InferencePipeline(model, device="cpu", compiled=True)
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        ProgramCache("cpu")
    cache = double_cache()
    assert program_cache("cpu", cache) is cache
    assert InferencePipeline(model, device="cpu").programs is None
    assert isinstance(program_cache("cuda:0"), ProgramCache)


@pytest.mark.parametrize("mode", ["full", "tsplit"])
def test_bench_batched_through_the_cache(luna, mode):
    """The bench's batched ``full`` / ``tsplit`` through a program cache:
    each group's frames are its own (copied out before the next replay)
    and equal the eager mode's bitwise."""
    model = luna[2]
    groups = bench.draw_pairs(np.random.default_rng(14), 3, (16, 16), 2)
    want = bench.bench_batched(model, groups, TIMES, mode, warmup=0,
                               compiled=False)
    got = bench.bench_batched(model, groups, TIMES, mode, warmup=1,
                              compiled=double_cache())
    assert want["programs"] is None
    (stats,) = got["programs"]
    assert stats["key"].startswith(f"batched {mode}") and stats["replays"] == 4
    for g, w in zip(got["outs"], want["outs"]):
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got["outs"][0], got["outs"][1])


def test_bench_b1_through_the_cache(luna):
    """The bench's b1 stream through the pipeline's programs: the eager
    uint8 frames bitwise, one capture (in the warm-up)."""
    model = luna[2]
    pairs = bench.draw_pairs(np.random.default_rng(15), 3, (16, 16))[:, 0]
    want = bench.bench_b1(model, pairs, TIMES, warmup=1, compiled=False)
    got = bench.bench_b1(model, pairs, TIMES, warmup=1,
                         compiled=double_cache())
    (stats,) = got["programs"]
    assert stats["replays"] == 4 and stats["pool_bytes"] is None
    for g, w in zip(got["outs"], want["outs"]):
        np.testing.assert_array_equal(g, w)


def test_bench_chunked_through_the_cache(luna):
    """The bench's chunked mode through a program cache: its ``gen_feat``
    one program of the cache, its decoder's four passes programs of a
    sibling; the frames equal the eager mode's bitwise, and the line's
    ``programs`` lists all five."""
    model = luna[2]
    groups = bench.draw_pairs(np.random.default_rng(16), 3, (16, 16), 2)
    want = bench.bench_batched(model, groups, TIMES, "1000", warmup=0,
                               compiled=False)
    got = bench.bench_batched(model, groups, TIMES, "1000", warmup=1,
                              compiled=double_cache())
    assert want["programs"] is None
    keys = [st["key"].split()[0] for st in got["programs"]]
    assert keys[0] == "batched" and sorted(keys[1:]) == [
        "ab", "cd", "prep", "skip"]
    replays = {st["key"].split()[0]: st["replays"] for st in got["programs"]}
    steps = -(-64 * 64 // 1000)
    assert replays == {"batched": 4, "prep": 4, "skip": 4, "ab": 4 * steps,
                       "cd": 4 * steps}
    for g, w in zip(got["outs"], want["outs"]):
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got["outs"][0], got["outs"][1])


def test_capture_runs_with_the_garbage_collected():
    """A program left in a reference cycle is collected before the next
    capture, and the cyclic collector is off while it runs: destroying a
    graph in the middle of a capture would invalidate the capture. The
    collector is on again after it, and after a failed one."""
    import gc

    class Holder:
        pass

    seen = []

    def step(fn, inputs, cache):
        seen.append((alive(), gc.isenabled()))
        return replay_double(fn, inputs, cache)

    model, x = _Counting(), torch.ones(3)
    old = Holder()
    old.cache = ProgramCache("cpu", capture=replay_double)
    old.cache.run("count", model, (x,), model)
    old.self = old  # a cycle: only the collector frees it
    alive = weakref.ref(old.cache)
    del old
    cache = ProgramCache("cpu", capture=step)
    cache.run("count", model, (x,), model)
    assert seen == [(None, False)] and gc.isenabled()

    def broken(fn, inputs, cache):
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        ProgramCache("cpu", capture=broken).run("count", model, (x,), model)
    assert gc.isenabled()
