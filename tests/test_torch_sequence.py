"""The double-buffered ``InferencePipeline.render_sequence`` on the CPU at
nf 8, groups 2, 1 + 1 blocks, with DCN offsets perturbed: bitwise equal to
``render_window`` of each pair back to back, and within 5e-5 of the JAX
package's ``render_sequence``; and the data loader's rank shares, which
together make up the global batch of one process."""

import numpy as np
import pytest

import jax.numpy as jnp

from stif_tpu.models import LunaTokis as JLunaTokis
from stif_tpu.runtime import InferencePipeline as JInferencePipeline

from stif_tpu_torch.data.loader import DataLoader, ShardedIterSampler
from stif_tpu_torch.data.synthetic import SyntheticVideoDataset
from stif_tpu_torch.models import LunaTokis
from stif_tpu_torch.runtime import InferencePipeline
from torch_parity import load_into_port, random_params

CFG = dict(nf=8, nframes=6, groups=2, front_RBs=1, back_RBs=1,
           rgb_skip=True, rgb_skip_bicubic=True)


@pytest.fixture(scope="module")
def pipes():
    jm = JLunaTokis(**CFG)
    params = random_params(jm, jnp.zeros((1, 2, 8, 8, 3)),
                           jnp.asarray([0.0, 0.5]), seed=12,
                           method=jm.full_init)
    pm = load_into_port(LunaTokis(**CFG), params)
    return (JInferencePipeline(jm, params),
            InferencePipeline(pm, device="cpu"))


def _frames(n, h, w, seed):
    return np.random.default_rng(seed).random((n, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("n_frames,n_times", [(5, 3), (2, 2), (3, 1)])
def test_render_sequence_is_the_windows_bitwise(pipes, n_frames, n_times):
    """Pairs launched ahead of their fetch give the back-to-back windows'
    frames bit for bit (12x14 frames pad to 16x16 and are cropped after),
    each pair in memory of its own."""
    _, pp = pipes
    frames = _frames(n_frames, 12, 14, n_frames)
    times = [i / n_times for i in range(n_times)]
    got = pp.render_sequence(frames, n_times=n_times)
    assert len(got) == n_frames - 1
    for i, out in enumerate(got):
        want = pp.render_window(frames[i:i + 2], times)
        assert out.shape == (n_times, 48, 56, 3)
        np.testing.assert_array_equal(out, want)
    for a in got:
        assert not any(np.shares_memory(a, b) for b in got if b is not a)


def test_render_sequence_matches_jax(pipes):
    jp, pp = pipes
    frames = _frames(5, 12, 14, 9)
    want = jp.render_sequence(frames, n_times=4)
    got = pp.render_sequence(frames, n_times=4)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=5e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_rank_shares_make_the_global_batch(world):
    """Each rank's loader (every ``world``-th sampler index, batch 8 /
    world) holds a share of the global batch of one process, and renders it
    at the global batch's scale bucket."""
    ds = SyntheticVideoDataset(n_items=24, gt_size=32, scale=4, nt=2,
                               seed=5, scale_plan=[[4, 8], [2, 16], [8, 4]])

    def batches(rank, ws):
        loader = DataLoader(ds, batch_size=8 // ws, collate=None,
                            sampler=ShardedIterSampler(len(ds), ratio=2,
                                                       world_size=ws,
                                                       rank=rank))
        gen = loader.epoch(1)
        out = [next(gen) for _ in range(3)]
        gen.close()
        return out

    whole = batches(0, 1)
    shares = [batches(r, world) for r in range(world)]
    for b, glob in enumerate(whole):
        parts = [s[b] for s in shares]
        assert {p["scale"] for p in parts} == {glob["scale"]}
        keys = [k for p in parts for k in p["key"]]
        assert sorted(keys) == sorted(glob["key"])
        order = {k: i for i, k in enumerate(glob["key"])}
        for p in parts:
            for j, k in enumerate(p["key"]):
                np.testing.assert_array_equal(p["GT"][j],
                                              glob["GT"][order[k]])
                np.testing.assert_array_equal(p["times"][j],
                                              glob["times"][order[k]])
    assert len({g["scale"] for g in whole}) > 1
