"""The forward's per-bucket constants (``stif_tpu_torch/ops/constants.py``)
on the CPU, at a small config (nf 8, groups 2, 1 + 1 blocks, LR 8x8,
``rgb_skip`` bicubic, DCN offsets perturbed):

- outputs, and a train step's loss and gradients, are bitwise the same with
  the store cold and warm, and the JAX parity bars (features 2e-5, end to
  end 5e-5) hold through the cached path;
- a second window of a bucket builds nothing, a new bucket builds its own;
- a render under inference mode, then a train step, works;
- no cached tensor is written: each one's ``_version`` holds across a
  window, a local-ensemble window, a chunked decode and a train step;
- keys split by dtype and device, the table keeps its bound, a failed
  build raises and leaves nothing behind.

The card's side (``cuda`` and ``cuda:0`` one key, no host sync in the model
call after a warm-up) is in ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stif_tpu.models import LunaTokis as JLunaTokis

from stif_tpu_torch.models import LunaTokis
from stif_tpu_torch.ops import constants, make_coord
from stif_tpu_torch.ops.constants import STORE, ConstantStore, vector
from stif_tpu_torch.ops.coords import _coord_np, make_coord_cached
from stif_tpu_torch.runtime import ChunkedDecoder, InferencePipeline
from stif_tpu_torch.train import trainer
from torch_parity import load_into_port, random_params, t

CFG = dict(nf=8, nframes=6, groups=2, front_RBs=1, back_RBs=1,
           rgb_skip=True, rgb_skip_bicubic=True)
H = W = 8
TIMES = [0.0, 0.5]
TRAIN = dict(lr=1e-4, warmup_iter=-1, T_period=(100,), restarts=(),
             restart_weights=(), eta_min=1e-7)


@pytest.fixture(scope="module")
def params():
    jm = JLunaTokis(**CFG)
    return random_params(jm, jnp.zeros((1, 2, H, W, 3)),
                         jnp.asarray(TIMES), seed=13, method=jm.full_init)


@pytest.fixture
def cold():
    """An empty store before and after the test."""
    STORE.clear()
    yield STORE
    STORE.clear()


def _port(params, **kw):
    return load_into_port(LunaTokis(**CFG, **kw), params)


def _frames(seed, h=H, w=W):
    return np.random.default_rng(seed).random((2, h, w, 3)).astype(
        np.float32)


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    return {"lqs": t(rng.random((2, 2, H, W, 3)).astype(np.float32)),
            "gt": t(rng.random((2, 2, 4 * H, 4 * W, 3)).astype(np.float32)),
            "times": t(np.asarray([[0.0, 0.5], [0.875, 0.25]], np.float32))}


def _train_step(model, batch):
    """One train step of ``model``: (loss, grad norm, {name: grad})."""
    model.train()
    cfg = trainer.TrainConfig(**TRAIN)
    opt, _ = trainer.make_optimizer(model.parameters(), cfg)
    out = trainer.make_train_step(model, opt, cfg)(batch, 0)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.eval()
    return out["loss"], out["grad_norm"], grads


MODES = {"full": {}, "local_ensemble": dict(local_ensemble=True),
         "test_mode": dict(test_mode=True)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_window_bitwise_cold_and_warm(params, cold, mode):
    """The window with every constant just built equals the window that
    reads them from the store, bit for bit."""
    pipe = InferencePipeline(_port(params), device="cpu", **MODES[mode])
    frames = _frames(0)
    first = pipe.render_window(frames, TIMES)
    assert cold.stats()["cpu"]["builds"] > 0
    hits = cold.stats()["cpu"]["hits"]
    second = pipe.render_window(frames, TIMES)
    assert cold.stats()["cpu"]["hits"] > hits
    np.testing.assert_array_equal(first, second)


def test_train_step_bitwise_cold_and_warm(params, cold):
    """A train step's loss, grad norm and every gradient are bitwise the
    same with the store cold and warm."""
    batch = _batch()
    loss0, norm0, grads0 = _train_step(_port(params, fused=False), batch)
    builds = cold.stats()["cpu"]["builds"]
    assert builds > 0
    loss1, norm1, grads1 = _train_step(_port(params, fused=False), batch)
    assert cold.stats()["cpu"]["builds"] == builds
    assert torch.equal(loss0, loss1) and torch.equal(norm0, norm1)
    assert grads0.keys() == grads1.keys() and grads0
    for name, g in grads0.items():
        assert torch.equal(g, grads1[name]), name


@pytest.mark.parametrize("what", ["gen_feat", "forward"])
def test_jax_parity_through_cached_path(params, cold, what):
    """The JAX package's bars (``tests/test_model_parity.py``: features
    2e-5, end to end 5e-5), held by the port's second call of the bucket,
    which reads every constant from the store."""
    jm, pm = JLunaTokis(**CFG), _port(params)
    x = np.random.default_rng(1).random((1, 2, H, W, 3)).astype(np.float32)
    times = np.asarray([0.0, 0.25, 1.0], np.float32)
    if what == "gen_feat":
        want = np.asarray(jax.jit(
            lambda p, x: jm.apply(p, x, method=jm.gen_feat))(params, x))
        run, bar = (lambda: pm.gen_feat(t(x))), 2e-5
    else:
        want = np.asarray(jax.jit(jm.apply)(params, x, times))
        run, bar = (lambda: pm(t(x), t(times))), 5e-5
    with torch.inference_mode():
        run()
        builds = cold.stats()["cpu"]["builds"]
        got = run().numpy()
    assert cold.stats()["cpu"]["builds"] == builds > 0
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=bar)


def test_second_window_builds_nothing(params, cold):
    """A bucket's first window builds its constants; a second window of it
    builds none; a window of another bucket builds its own set, once."""
    pipe = InferencePipeline(_port(params), device="cpu", bucket=4)
    pipe.render_window(_frames(0), TIMES)
    first = cold.stats()["cpu"]
    pipe.render_window(_frames(1), [0.25, 0.75, 1.0])  # other pair, times
    again = cold.stats()["cpu"]
    assert first["builds"] > 0 and again["builds"] == first["builds"]
    assert again["hits"] > first["hits"]
    pipe.render_window(_frames(2, 12, 16), TIMES)  # a new bucket
    other = cold.stats()["cpu"]
    assert other["builds"] > first["builds"]
    pipe.render_window(_frames(3, 12, 16), TIMES)
    assert cold.stats()["cpu"]["builds"] == other["builds"]


def test_render_then_train_step(params, cold):
    """A render under inference mode builds the constants; a train step on
    the same model then reads them and can save them for its backward: no
    constant is an inference tensor or requires grad."""
    model = _port(params, fused=False)
    InferencePipeline(model, device="cpu").render_window(_frames(0), TIMES)
    for v in cold.tensors():
        assert not v.is_inference() and not v.requires_grad
    loss, norm, grads = _train_step(model, _batch())
    assert torch.isfinite(loss) and torch.isfinite(norm) and grads


PATHS = ("window", "local_ensemble", "chunked", "train_step")


def _drive(path, model):
    if path == "train_step":
        _train_step(model, _batch())
        return
    if path == "chunked":
        x = t(_frames(0)[None])
        times = torch.tensor(TIMES)
        with torch.inference_mode():
            feat = model.gen_feat(x)
        ChunkedDecoder(model, 200, device="cpu").decode(
            feat, x, times, (4 * H, 4 * W))
        return
    InferencePipeline(model, device="cpu",
                      local_ensemble=path == "local_ensemble").render_window(
        _frames(0), TIMES)


@pytest.mark.parametrize("path", PATHS)
def test_cached_tensors_never_written(params, cold, path):
    """Every cached tensor's ``_version`` and values are the same after the
    path ran again (and after every other path ran) as after its first
    run."""
    model = _port(params, fused=path != "train_step")
    _drive(path, model)
    held = [(v, v._version, v.clone()) for v in cold.tensors()]
    assert held
    _drive(path, model)
    for other in PATHS:
        _drive(other, _port(params, fused=other != "train_step"))
    for v, version, value in held:
        assert v._version == version
        assert torch.equal(v, value)


def test_make_coord_owned_and_cached():
    """``make_coord`` hands the caller a tensor of its own at each call;
    ``make_coord_cached`` one shared tensor; the values are the same."""
    a, b = make_coord((6, 10)), make_coord((6, 10))
    assert a.data_ptr() != b.data_ptr()
    c = make_coord_cached((6, 10), device="cpu")
    assert make_coord_cached((6, 10), device="cpu") is c
    assert torch.equal(a, c)
    fa = make_coord((5, 7), flatten=False)
    assert torch.equal(fa, make_coord_cached((5, 7), flatten=False))


@pytest.mark.parametrize("values", [(96, 160), (270, 480),
                                    (1 / 96 + 1e-6, -1 / 160 + 1e-6),
                                    ((640 - 1.0) / 2.0, (384 - 1.0) / 2.0)])
def test_vector_is_torch_tensor_bitwise(cold, values):
    """The small vectors (``rel``'s scale, the local ensemble's shift, a
    field's half sizes) equal ``torch.tensor`` of the same numbers bit for
    bit."""
    want = torch.tensor(list(values), dtype=torch.float32)
    assert torch.equal(vector(*values), want)
    assert vector(*values).dtype == torch.float32


def test_keys_split_by_dtype_and_device(cold):
    """One key per (builder, arguments, device, dtype): float32 and float64
    are two entries; ``cpu`` as a string, a ``torch.device`` or None is
    one."""
    a = constants.constant(_coord_np, (4, 6), None, True, device="cpu")
    assert constants.constant(_coord_np, (4, 6), None, True,
                              device=torch.device("cpu")) is a
    assert constants.constant(_coord_np, (4, 6), None, True) is a
    d = constants.constant(_coord_np, (4, 6), None, True, device="cpu",
                           dtype=torch.float64)
    assert d is not a and d.dtype == torch.float64 and a.dtype == torch.float32
    assert torch.equal(d.float(), a)
    assert cold.stats() == {"cpu": {"builds": 2, "hits": 2,
                                    "bytes": a.nbytes + d.nbytes,
                                    "entries": 2}}


def test_store_keeps_its_bound():
    """Under many buckets the table holds at most its bound, evicting the
    least recently used; an evicted constant is built again when asked."""
    store = ConstantStore()
    store.max_bytes = 4096
    first = store.get(_coord_np, (8, 8), None, True)  # 512 B
    for n in range(4, 20):
        store.get(_coord_np, (n, n), None, True)
        store.get(_coord_np, (8, 8), None, True)  # kept recent
        assert store.stats()["cpu"]["bytes"] <= 4096
    assert store.get(_coord_np, (8, 8), None, True) is first
    builds = store.stats()["cpu"]["builds"]
    store.get(_coord_np, (4, 4), None, True)  # evicted long ago
    assert store.stats()["cpu"]["builds"] == builds + 1
    big = store.get(_coord_np, (64, 64), None, True)  # 32 KiB, over bound
    assert store.tensors() == [big]


def test_failed_build_raises():
    """A builder that fails raises through the store, and nothing is
    cached in its place."""
    store = ConstantStore()

    def broken(n):
        raise ValueError(f"cannot build {n}")

    with pytest.raises(ValueError, match="cannot build 3"):
        store.get(broken, 3)
    assert store.tensors() == []
    assert store.stats()["cpu"]["builds"] == 0
