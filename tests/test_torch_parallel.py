"""The port's parallelism on the CPU: meshes and placements against
``stif_tpu.parallel``; the mesh-parallel ``ChunkedDecoder`` over two CPU
handles against the JAX ``decode``; and, in two processes spawned over
gloo (``tests/torch_gloo_worker.py``, one spawn for the whole file), the
data-parallel train step against single-process steps on the same global
batch for a sum- and a mean-reduced criterion, ``train_torch.py``'s
``run(parallel=True)`` against the same run in one process, tensor
parallelism and ``shard_queries``. Bars: decoder 2e-5 (as
``tests/test_data_runtime.py``), train step loss rtol 1e-5, grad norm rtol
1e-4, params 1e-5, tensor-parallel output 1e-5."""

import multiprocessing
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from stif_tpu.models import LunaTokis as JLunaTokis
from stif_tpu.parallel import make_mesh as j_make_mesh
from stif_tpu.parallel import param_shardings as j_param_shardings

from stif_tpu_torch.convert import jax_params_to_state_dict
from stif_tpu_torch.models import LunaTokis
from stif_tpu_torch.parallel import (batch_sharding, default_mesh,
                                     make_mesh, param_shardings, replicated,
                                     shard_queries)
from stif_tpu_torch.parallel.distributed import free_port
from stif_tpu_torch.runtime import ChunkedDecoder
from torch_parity import load_into_port, random_params
import torch_gloo_worker as worker

TINY = dict(nf=8, groups=2, front_RBs=1, back_RBs=1)
CPU = torch.device("cpu")
WORLD = 2


def test_mesh_construction():
    mesh = make_mesh({"data": 4, "model": 2}, [CPU] * 8)
    assert mesh.shape == {"data": 4, "model": 2} and mesh.size == 8
    mesh2 = default_mesh(8, model_parallel=2, device_type="cpu")
    assert mesh2.shape["model"] == 2 and mesh2.shape["data"] == 4
    assert mesh2.axis_devices("model") == [CPU, CPU]
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        make_mesh({"data": 4, "model": 2}, [CPU] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            default_mesh()
        with pytest.raises(ValueError, match="have 0"):
            make_mesh({"data": 1})


@pytest.fixture(scope="module")
def tiny_params():
    jm = JLunaTokis(**TINY)
    params = random_params(jm, jnp.zeros((1, 2, 8, 12, 3)),
                           jnp.asarray([0.0, 0.5]), seed=4,
                           method=jm.full_init)
    return jm, params


def test_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_mesh({"data": 4, "model": 2}, [CPU] * 8)
    assert replicated(mesh) == (Replicate(), Replicate())
    assert batch_sharding(mesh, 5) == (Shard(0), Replicate())
    assert batch_sharding(mesh, 3, axis=-2, mesh_axis="model") == (
        Replicate(), Shard(1))


@pytest.mark.parametrize("tp,mp", [(True, 2), (False, 2), (True, 1)])
def test_param_shardings_match_jax(tiny_params, tp, mp):
    """The same parameters sharded as the JAX rules shard them: a marker
    tree (1 where JAX shards a leaf) converted to the port's state dict."""
    from torch.distributed.tensor import Shard

    jm, params = tiny_params
    jmesh = j_make_mesh({"data": 8 // mp, "model": mp})
    jspecs = j_param_shardings(jmesh, params, tensor_parallel=tp)
    marks = jax.tree.map(
        lambda p, s: np.full(p.shape, float(s.spec != P()), np.float32),
        params, jspecs)
    want = {k for k, v in jax_params_to_state_dict(marks).items()
            if float(v.max()) == 1.0}
    state = LunaTokis(**TINY).state_dict()
    mesh = make_mesh({"data": 8 // mp, "model": mp}, [CPU] * 8)
    got = param_shardings(mesh, state, tensor_parallel=tp)
    assert got.keys() == state.keys()
    sharded = {k for k, p in got.items() if p[1] == Shard(0)}
    assert sharded == want
    assert bool(sharded) == (tp and mp > 1)


def test_chunked_decoder_mesh_matches_jax_decode(tiny_params):
    """Q = 32 * 48, chunk 128 over two CPU handles (6 steps of 2 chunks)
    against the JAX ``decode`` on the same params and features, and equal
    to the single-device chunked decode."""
    jm, params = tiny_params
    x = np.random.default_rng(2).random((1, 2, 8, 12, 3)).astype(np.float32)
    times = np.asarray([0.0, 0.5], np.float32)
    feat = np.array(jax.jit(
        lambda p, x: jm.apply(p, x, method=jm.gen_feat))(params, x))
    want = np.asarray(jm.apply(params, feat, x, times, method=jm.decode))
    pm = load_into_port(LunaTokis(**TINY), params)
    mesh = make_mesh({"model": 2}, [CPU, CPU])
    dec = ChunkedDecoder(pm, chunk_size=128, mesh=mesh)
    assert dec.n_par == 2 and dec.devices == [CPU, CPU]
    got = dec.decode(feat, x, times, (32, 48))
    np.testing.assert_allclose(got, want, atol=2e-5)
    one = ChunkedDecoder(pm, chunk_size=128, device="cpu").decode(
        feat, x, times, (32, 48))
    np.testing.assert_allclose(got, one, atol=1e-6)


def test_shard_queries_without_a_model_axis():
    mesh = default_mesh(2, device_type="cpu")  # model axis 1: unchanged
    x = torch.ones(2, 5, 3)
    assert shard_queries(x, mesh) is x


# ------------------------------------------------- two ranks over gloo


def _spawn(out_dir) -> list:
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=worker.main, args=(r, WORLD, port,
                                                   str(out_dir)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
        if p.is_alive():
            p.kill()
    codes = [p.exitcode for p in procs]
    outs = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]
    assert codes == [0] * WORLD, (codes, [sorted(o) for o in outs])
    return outs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("gloo")
    env = {"OMP_NUM_THREADS": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return out_dir, _spawn(out_dir)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("criterion", ["cb", "l1"])
def test_data_parallel_step_matches_single_process(ranks, criterion):
    """Two DDP steps at world size 2, each rank on its half of the global
    batch (B 4, per-sample times), against two steps of one process on the
    whole batch, for 'cb' (summed: the
    local loss is scaled by the world size) and 'l1' (averaged)."""
    _, outs = ranks
    r0 = outs[0][criterion]
    for rank in outs:
        got = rank[criterion]
        for g, w in zip(got["logs"], r0["ref_logs"]):
            assert abs(g["loss"] - w["loss"]) <= 1e-5 * abs(w["loss"])
            assert abs(g["grad_norm"] - w["grad_norm"]) <= (
                1e-4 * abs(w["grad_norm"]))
        for k, v in r0["ref_params"].items():
            np.testing.assert_allclose(got["params"][k], v, atol=1e-5,
                                       err_msg=k)
        # parameters no forward uses get no gradient and no Adam state,
        # as in one process
        assert got["state_keys"] == r0["ref_state_keys"]


def test_parallel_run_matches_one_process(ranks, tmp_path):
    """``train_torch.run(parallel=True)`` on two ranks (each loader takes
    its half of every global batch; the scale bucket is the global
    batch's) ends where the same run in one process ends; its checkpoints
    carry no ``module.`` prefix and resume in one process, strictly."""
    out_dir, outs = ranks
    assert [o["run_last"] for o in outs] == [3, 3]
    assert all(o["group_from_env"] for o in outs)
    train = worker.load_script("train_torch")
    single = worker.run_opt(str(tmp_path / "one"))
    assert train.run(single, steps=3, device="cpu") == 3
    par_dir = out_dir / "par"
    par = torch.load(par_dir / "checkpoint_3.pth", weights_only=True)
    one = torch.load(tmp_path / "one" / "checkpoint_3.pth",
                     weights_only=True)
    assert not any(k.startswith("module.") for k in par["params"])
    assert par["params"].keys() == one["params"].keys()
    for k, v in one["params"].items():
        torch.testing.assert_close(par["params"][k], v, atol=1e-5, rtol=0)
    assert par["opt_state"]["state"].keys() == one["opt_state"]["state"].keys()
    log = (par_dir / "train.log").read_text()
    assert "checkpoint @ 2" in log and "done at step 3" in log
    # resume the parallel run in one process
    opt = worker.run_opt(str(par_dir))
    assert train.run(opt, steps=4, resume=True, device="cpu") == 4
    log = (par_dir / "train.log").read_text()
    assert "resumed at step 3" in log and "done at step 4" in log


def test_parallel_checkpoint_loads_strictly(ranks):
    """The parallel run's weights-only EMA snapshot and checkpoint load
    into a single-process net with ``strict=True``."""
    from stif_tpu_torch.convert import load_pth
    from stif_tpu_torch.models.factory import define_g
    from stif_tpu_torch.train.checkpoints import load_params

    out_dir, _ = ranks
    net = define_g({"network_G": dict(worker.NET)})
    load_pth(net, str(out_dir / "par" / "ema_params_3.pth"))
    ck = load_params(str(out_dir / "par" / "checkpoint_3.pth"))
    net.load_state_dict(ck["params"], strict=True)


def test_tensor_parallel_output(ranks):
    """Decoder layers sharded over a model axis of 2 give the unsharded
    output; the kernel's wrapper refuses a DTensor operand, and a sharded
    SIREN refuses ``compute_dtype`` and ``split_first``."""
    _, outs = ranks
    for o in outs:
        tp = o["tp"]
        assert tp["layers"] and all("imnet" in n for n in tp["layers"])
        assert "encode_imnet.net.4" not in tp["layers"]  # 3 outputs: whole
        assert tp["local_rows"] == 32  # 64 output rows, half on each rank
        assert tp["fused"] and not any(tp["fused"])
        np.testing.assert_allclose(tp["got"], tp["want"], atol=1e-5)
        assert "DTensor" in tp["refused"] and tp["refused_bias"]
        assert len(tp["conflicts"]) == 2
        assert all("tensor-parallel" in e for e in tp["conflicts"])


def test_shard_queries_round_trip(ranks):
    _, outs = ranks
    for o in outs:
        q = o["queries"]
        np.testing.assert_array_equal(q["local"], q["want_local"])
        assert q["full_equal"]
