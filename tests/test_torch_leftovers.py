"""The port's last host-side modules against their ``stif_tpu``
counterparts on the CPU: the warp ops (1e-6), the lmdb reader / writer and
the memcached client / server (and databases written by one package read
by the other), the Vimeo7 lmdb and mc backends against the folder backend
(bitwise), the native frame ops (1e-5 against ``imresize_np``), the misc /
video / visualize utilities, ``deform_psroi_pool`` (1e-5), the training
supervisor on stub trainers and ``test_video_torch.py --params``."""

import importlib.util
import io
import json
import logging
import os.path as osp
import pickle
import random
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stif_tpu.data import lmdb_io as j_lmdb_io
from stif_tpu.data.datasets import Vimeo7Dataset as JVimeo7Dataset
from stif_tpu.ops import psroi_pool as j_psroi_pool
from stif_tpu.ops import warp as j_warp
from stif_tpu.ops.resize import imresize_np
from stif_tpu.utils import misc as j_misc
from stif_tpu.utils import video as j_video
from stif_tpu.utils import visualize as j_visualize

from stif_tpu_torch.data import datasets, native
from stif_tpu_torch.data.lmdb_io import PAGE, LmdbReader, write_lmdb
from stif_tpu_torch.data.memcache import MemcachedClient, MiniMemcachedServer
from stif_tpu_torch.ops import backward_warp, warp_grid_coords
from stif_tpu_torch.ops.psroi_pool import deform_psroi_pool
from stif_tpu_torch.utils import AverageMeter, ProgressBar, misc, video
from stif_tpu_torch.utils import visualize
from torch_parity import t  # importing it caps PyTorch's threads

cv2 = pytest.importorskip("cv2")

ROOT = Path(__file__).resolve().parents[1]


def _script(name):
    path = ROOT / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _main(name):
    return _script(name).main


# ------------------------------------------------------------------- warp

@pytest.mark.parametrize("hw,fhw", [((9, 13), (9, 13)), ((12, 10), (7, 5))])
def test_backward_warp(rng, hw, fhw):
    x = rng.random((2,) + hw + (4,)).astype(np.float32)
    flow = (rng.standard_normal((2,) + fhw + (2,)) * 3).astype(np.float32)
    want = np.asarray(j_warp.backward_warp(jnp.asarray(x), jnp.asarray(flow)))
    got = backward_warp(t(x), t(flow)).numpy()
    assert got.shape == want.shape == (2,) + fhw + (4,)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_warp_grid_coords(rng):
    coords = rng.uniform(-1, 1, (2, 50, 2)).astype(np.float32)
    flow = (rng.standard_normal((2, 50, 2)) * 4).astype(np.float32)
    want = np.asarray(j_warp.warp_grid_coords(jnp.asarray(coords),
                                              jnp.asarray(flow), 11, 17))
    got = warp_grid_coords(t(coords), t(flow), 11, 17).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.abs(got).max() <= 1 - 1e-6 and np.abs(got).max() > 0.99


# ------------------------------------------------------------------- lmdb

def test_lmdb_roundtrip_small_values(tmp_path):
    items = {f"k{i:04d}".encode(): f"value-{i}".encode() for i in range(50)}
    stats = write_lmdb(str(tmp_path / "db"), items.items())
    assert stats["entries"] == 50
    r = LmdbReader(str(tmp_path / "db"))
    assert r.entries == 50
    for k, v in items.items():
        assert r.get(k) == v
    assert r.get(b"absent") is None and r.keys() == sorted(items)
    r.close()


def test_lmdb_roundtrip_overflow_and_deep_tree(tmp_path):
    rng = np.random.default_rng(0)
    sizes = [PAGE // 4 + 1, PAGE - 16, PAGE, 3 * PAGE + 7, 64 * 1024]
    items = [(f"blob{i}".encode(), rng.integers(0, 256, s, np.uint8).tobytes())
             for i, s in enumerate(sizes)]
    items += [(f"key-{i:06d}".encode(), f"v{i}".encode() * 7)
              for i in range(5000)]
    random.Random(0).shuffle(items)
    stats = write_lmdb(str(tmp_path / "db"), items)
    assert stats["overflow_pages"] > 0 and stats["depth"] >= 2
    r = LmdbReader(str(tmp_path / "db"))
    for k, v in random.Random(1).sample(items, 300) + items[:5]:
        assert r.get(k) == v
    assert r.get(b"key-0000005x") is None and len(r.keys()) == 5005
    r.close()


def test_lmdb_cross_package(tmp_path):
    """A database written by the JAX package's writer reads back here, and
    the other way round; the two writers give the same bytes."""
    rng = np.random.default_rng(3)
    items = [(f"x{i:03d}".encode(),
              rng.integers(0, 256, (i * 97) % 9000, np.uint8).tobytes())
             for i in range(300)]
    j_lmdb_io.write_lmdb(str(tmp_path / "jax"), items)
    write_lmdb(str(tmp_path / "port"), items)
    assert (tmp_path / "jax" / "data.mdb").read_bytes() == (
        tmp_path / "port" / "data.mdb").read_bytes()
    mine = LmdbReader(str(tmp_path / "jax"))
    theirs = j_lmdb_io.LmdbReader(str(tmp_path / "port"))
    for k, v in items:
        assert mine.get(k) == v and theirs.get(k) == v
    mine.close()
    theirs.close()


def _write_septuplets(tmp_path, scale=4, gt_hw=(32, 48)):
    """Two septuplet folders, the same frames as lmdb databases (the
    reference's schema) and as PNGs for memcached (whole, and GT split into
    single-channel planes)."""
    rng = np.random.default_rng(7)
    h, w = gt_hw
    gt_root, lq_root = tmp_path / "gt", tmp_path / "lq"
    gt_items, lq_items, mc = [], [], {}
    for a, b in [("00001", "0001"), ("00001", "0002")]:
        (gt_root / a / b).mkdir(parents=True)
        (lq_root / a / b).mkdir(parents=True)
        for i in range(1, 8):
            gt = rng.integers(0, 256, (h, w, 3), np.uint8)
            lq = rng.integers(0, 256, (h // scale, w // scale, 3), np.uint8)
            cv2.imwrite(str(gt_root / a / b / f"im{i}.png"), gt)
            cv2.imwrite(str(lq_root / a / b / f"im{i}.png"), lq)
            gt_items.append((f"{a}_{b}_{i}".encode(), gt.tobytes()))
            lq_items.append((f"{a}_{b}_{i}".encode(), lq.tobytes()))
            rel = osp.join(a, b, f"im{i}.png")
            mc[osp.join(str(gt_root), rel)] = cv2.imencode(".png", gt)[1]
            mc[osp.join(str(lq_root), rel)] = cv2.imencode(".png", lq)[1]
            for ch, suffix in enumerate(("_B", "_G", "_R")):
                mc[osp.join(str(gt_root) + suffix, rel)] = cv2.imencode(
                    ".png", gt[..., ch])[1]
    write_lmdb(str(tmp_path / "gt.lmdb"), gt_items)
    write_lmdb(str(tmp_path / "lq.lmdb"), lq_items)
    return str(gt_root), str(lq_root), {k: v.tobytes() for k, v in mc.items()}


def _same_samples(a, b, n=2):
    for i in range(n):
        x, y = a[i], b[i]
        assert x["key"] == y["key"]
        for k in ("LQs", "GT", "times"):
            np.testing.assert_array_equal(x[k], y[k])


def test_vimeo7_lmdb_backend(tmp_path):
    """The lmdb backend equals the folder backend and the JAX lmdb backend
    sample by sample; ``create_train_dataset`` infers it from the roots'
    suffix and reads a pickled key cache."""
    gt_root, lq_root, _ = _write_septuplets(tmp_path)
    common = dict(n_frames=7, gt_size=16, scale=4, seed=3)
    db = dict(data_type="lmdb", gt_shape=(3, 32, 48), **common)
    ds_db = datasets.Vimeo7Dataset(str(tmp_path / "gt.lmdb"),
                                   str(tmp_path / "lq.lmdb"), **db)
    assert ds_db.keys == ["00001_0001", "00001_0002"]
    _same_samples(ds_db, datasets.Vimeo7Dataset(gt_root, lq_root, **common))
    _same_samples(datasets.Vimeo7Dataset(str(tmp_path / "gt.lmdb"),
                                         str(tmp_path / "lq.lmdb"), **db),
                  JVimeo7Dataset(str(tmp_path / "gt.lmdb"),
                                 str(tmp_path / "lq.lmdb"), **db))
    keys = [f"00001_0001_{i}" for i in range(1, 8)] + ["00001_0002_4"]
    with open(tmp_path / "keys.pkl", "wb") as f:
        pickle.dump(keys, f)
    opt = {"scale": 4, "datasets": {"train": {
        "mode": "Vimeo7", "dataroot_GT": str(tmp_path / "gt.lmdb"),
        "dataroot_LQ": str(tmp_path / "lq.lmdb"),
        "cache_keys": str(tmp_path / "keys.pkl"), "N_frames": 7,
        "GT_size": 16, "gt_shape": [3, 32, 48]}}}
    ds, collate = datasets.create_train_dataset(opt)
    assert ds.data_type == "lmdb" and callable(collate)
    assert ds.keys == ["00001_0001", "00001_0002"]
    assert ds[0]["GT"].shape == (7, 16, 16, 3)


def test_memcache_client_server():
    with MiniMemcachedServer() as srv:
        c = MemcachedClient(port=srv.port)
        assert c.get("absent") is None
        payload = bytes(range(256)) * 300  # binary-safe, holds \r\n
        c.set("a/b/im1.png", payload)
        assert c.get("a/b/im1.png") == payload
        c.set("a/b/im1.png", b"overwritten")
        c2 = MemcachedClient(port=srv.port)
        c2.set("empty", b"")
        assert c2.get("empty") == b"" and c2.get("a/b/im1.png") == (
            b"overwritten")
        c.close()
        c2.close()
    with pytest.raises(ValueError):
        MemcachedClient(port=1).get("has space")
    with pytest.raises(ValueError):
        MemcachedClient(port=1).set("x" * 251, b"v")


def test_memcache_cross_package():
    """The port's client against the JAX package's server and the other
    way round."""
    from stif_tpu.data.memcache import MemcachedClient as JClient
    from stif_tpu.data.memcache import MiniMemcachedServer as JServer

    with JServer() as jsrv, MiniMemcachedServer() as srv:
        MemcachedClient(port=jsrv.port).set("k", b"from the port")
        assert JClient(port=jsrv.port).get("k") == b"from the port"
        JClient(port=srv.port).set("k", b"from jax")
        assert MemcachedClient(port=srv.port).get("k") == b"from jax"


@pytest.mark.parametrize("channel_split", [False, True])
def test_vimeo7_mc_backend(tmp_path, channel_split):
    """The mc backend (GT whole or merged from its B / G / R planes) equals
    the folder backend; ``create_train_dataset`` passes the mc options."""
    gt_root, lq_root, values = _write_septuplets(tmp_path)
    keys = ["00001_0001", "00001_0002"]
    common = dict(n_frames=7, gt_size=16, scale=4, seed=5, keys=keys)
    with MiniMemcachedServer() as srv:
        c = MemcachedClient(port=srv.port)
        for k, v in values.items():
            c.set(k, v)
        c.close()
        ds_mc = datasets.Vimeo7Dataset(gt_root, lq_root, data_type="mc",
                                       mc_port=srv.port,
                                       mc_channel_split=channel_split,
                                       **common)
        _same_samples(ds_mc, datasets.Vimeo7Dataset(gt_root, lq_root,
                                                    **common))
        with open(tmp_path / "keys.pkl", "wb") as f:
            pickle.dump(keys, f)
        ds, _ = datasets.create_train_dataset({"scale": 4, "datasets": {
            "train": {"mode": "Vimeo7", "data_type": "mc",
                      "dataroot_GT": gt_root, "dataroot_LQ": lq_root,
                      "cache_keys": str(tmp_path / "keys.pkl"),
                      "N_frames": 7, "GT_size": 16, "mc_port": srv.port,
                      "mc_channel_split": channel_split}}})
        assert ds.data_type == "mc" and ds.mc_channel_split == channel_split
        assert ds[0]["GT"].shape == (7, 16, 16, 3)


# ----------------------------------------------------------------- native

@pytest.mark.parametrize("shape,scale", [
    ((20, 28, 3), 0.25), ((17, 23, 3), 4.0), ((2, 3, 20, 28, 3), 0.5),
    ((31, 17, 6), 1 / 3), ((12, 12, 3), 2.0)])
def test_native_imresize(rng, shape, scale):
    """The native library (built here with g++) against the JAX package's
    NumPy resize and the port's plain version."""
    x = rng.random(shape).astype(np.float32)
    got = native.host_imresize(x, scale)
    np.testing.assert_allclose(got, imresize_np(x, scale), atol=1e-5)
    np.testing.assert_allclose(got, datasets.host_imresize(x, scale),
                               atol=1e-5)
    assert native.available()


def test_native_frame_ops(rng):
    img = rng.integers(0, 256, (40, 52, 3), np.uint8)
    np.testing.assert_allclose(native.bgr_u8_to_rgb(img),
                               img[..., ::-1].astype(np.float32) / 255.0,
                               atol=1e-7)
    want = imresize_np(img[5:37, 9:41, ::-1].astype(np.float32) / 255.0,
                       0.25)
    np.testing.assert_allclose(native.degrade_u8(img, 5, 9, 32, 0.25), want,
                               atol=1e-5)


FAKE_CXX = """#!/bin/sh
# a g++ without an OpenMP runtime{always}
for a in "$@"; do
  if [ "$a" = "-fopenmp" ] || [ -n "{fail}" ]; then
    echo "fatal error: cannot read spec file 'libgomp.spec'" >&2
    exit 1
  fi
done
exec g++ "$@"
"""


@pytest.mark.parametrize("always", [False, True])
def test_native_build_without_openmp(tmp_path, monkeypatch, always):
    """A compiler without an OpenMP runtime builds the library with all
    its threads (``std::thread``, no ``-fopenmp``; same results); a
    compiler that builds nothing raises with its output."""
    from stif_tpu_torch.ops import cuda_build

    cxx = tmp_path / "cxx"
    cxx.write_text(FAKE_CXX.format(always=", failing" if always else "",
                                   fail="yes" if always else ""))
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setenv("OMP_NUM_THREADS", "3")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_loaded", {})
    x = np.random.default_rng(1).random((19, 26, 3)).astype(np.float32)
    if always:
        with pytest.raises(RuntimeError, match="libgomp.spec"):
            native.host_imresize(x, 0.5)
        assert not list((tmp_path / "build").glob("*.so"))
        return
    assert "-fopenmp" not in cuda_build.HOST_FLAGS
    assert native.num_threads() == 3
    got = native.host_imresize(x, 0.5)
    np.testing.assert_allclose(got, imresize_np(x, 0.5), atol=1e-5)
    # the threads split rows: one thread gives the same bits
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert native.num_threads() == 1
    np.testing.assert_array_equal(native.host_imresize(x, 0.5), got)


# ------------------------------------------------------------------- misc

def test_average_meter():
    got, want = AverageMeter(), j_misc.AverageMeter()
    for v, n in [(3.0, 1), (5.0, 2), (-1.5, 4)]:
        got.update(v, n)
        want.update(v, n)
    assert vars(got) == vars(want)
    got.reset()
    assert got.count == 0 and got.avg == 0.0


@pytest.mark.parametrize("task_num", [0, 3])
def test_progress_bar(monkeypatch, task_num):
    """The same text as the JAX package's bar, on a clock that ticks one
    second per reading."""
    texts = []
    for mod in (misc, j_misc):
        clock = iter(range(100))
        monkeypatch.setattr(time, "time", lambda: float(next(clock)))
        out = io.StringIO()
        bar = mod.ProgressBar(task_num, stream=out)
        for i in range(3):
            bar.update(f"item {i}")
        texts.append(out.getvalue())
    assert texts[0] == texts[1] and "3" in texts[0]
    assert ProgressBar is misc.ProgressBar


def test_logger_and_dirs(tmp_path):
    log = misc.setup_logger("port_test", str(tmp_path / "a" / "x.log"),
                            screen=False)
    log.info("hello %d", 3)
    for h in log.handlers:
        h.flush()
    text = (tmp_path / "a" / "x.log").read_text()
    assert " - INFO: hello 3" in text
    jlog = j_misc.setup_logger("jax_test", str(tmp_path / "b.log"),
                               screen=False)
    assert log.handlers[0].formatter._fmt == jlog.handlers[0].formatter._fmt
    for lg in (log, jlog):
        for h in list(lg.handlers):
            lg.removeHandler(h)
            h.close()
    exp = tmp_path / "exp"
    exp.mkdir()
    (exp / "f").write_text("x")
    misc.mkdir_and_rename(str(exp))
    assert exp.is_dir() and not list(exp.iterdir())
    assert [p.name for p in tmp_path.iterdir()
            if p.name.startswith("exp_archived_")]


def test_trace_span(caplog):
    """A ``record_function`` span in a profiler trace, and the wall-clock
    line in the 'base' log."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with caplog.at_level(logging.INFO, logger="base"):
            with misc.trace_span("decode_chunk", log=True):
                torch.ones(8).sum()
    assert any(e.key == "decode_chunk" for e in prof.key_averages())
    assert any(r.getMessage().startswith("decode_chunk: ")
               for r in caplog.records)


# ------------------------------------------------------- video, visualize

def test_video_round_trip(tmp_path, rng):
    frames = [rng.integers(0, 256, (16, 24, 3), np.uint8) for _ in range(4)]
    folder = tmp_path / "frames"
    folder.mkdir()
    for i, f in enumerate(frames):
        cv2.imwrite(str(folder / f"{i:06d}.png"), f[..., ::-1])
    got = video.read_seq_imgs(str(folder))
    np.testing.assert_array_equal(got, j_video.read_seq_imgs(str(folder)))
    np.testing.assert_allclose(got, np.stack(frames) / 255.0, atol=1e-7)
    out = str(tmp_path / "clip.mp4")
    video.create_video_cv2(frames, out, fps=10)
    cap = cv2.VideoCapture(out)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    assert n == len(frames)
    assert video.has_ffmpeg() == j_video.has_ffmpeg()
    if not video.has_ffmpeg():
        with pytest.raises(RuntimeError, match="ffmpeg"):
            video.create_video_ffmpeg(str(folder), str(tmp_path / "x.mp4"))
        with pytest.raises(RuntimeError, match="ffmpeg"):
            video.extract_frames(out, str(tmp_path / "x"))


def test_visualize(rng):
    flow = (rng.standard_normal((9, 11, 2)) * 5).astype(np.float32)
    flow[0, 0] = np.nan
    flow[1, 1] = 2e7  # unknown flow
    np.testing.assert_array_equal(visualize.flow_to_image(flow),
                                  j_visualize.flow_to_image(flow))
    np.testing.assert_array_equal(visualize.make_color_wheel(),
                                  j_visualize.make_color_wheel())


# -------------------------------------------------------------- psroi pool

@pytest.mark.parametrize("with_trans", [False, True])
def test_deform_psroi_pool(rng, with_trans):
    """Against the JAX op on the inputs of ``tests/test_psroi_pool.py``."""
    B, C, H, W = 2, 16, 12, 14
    G, P, output_dim, s = 2, 4, 4, 3
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    rois = np.array([[0, 1, 1, 8, 9], [1, 0, 2, 13, 11], [0, 3, 3, 5, 5],
                     [1, -4, 6, 30, 9]], np.float32)
    trans = (rng.standard_normal((4, 1, 2, P, P)).astype(np.float32)
             if with_trans else None)
    kw = dict(spatial_scale=1.0, pooled_size=P, output_dim=output_dim,
              group_size=G, sample_per_part=s,
              trans_std=0.1 if with_trans else 0.0)
    want, wcnt = j_psroi_pool.deform_psroi_pool(
        jnp.asarray(x), jnp.asarray(rois),
        None if trans is None else jnp.asarray(trans), **kw)
    got, gcnt = deform_psroi_pool(t(x), t(rois),
                                  None if trans is None else t(trans), **kw)
    assert got.shape == (4, P, P, output_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(gcnt.numpy(), np.asarray(wcnt))


# -------------------------------------------------------------- supervisor

STUB = '''
import sys, time
sys.argv.index("-opt")
log = {log!r}
with open(log, "a") as f:
    f.write("start resume=%s\\n" % ("--resume" in sys.argv))
    f.flush()
    if {mode!r} == "finish" or ("--resume" in sys.argv and {mode!r} == "die"):
        f.write("done at step 3\\n")
        sys.exit(0)
if {mode!r} == "die":
    sys.exit(1)
time.sleep(600)
'''


@pytest.mark.parametrize("mode,code,starts", [
    ("stall", 1, ["False", "True", "True"]),  # killed, relaunched twice
    ("die", 0, ["False", "True"]),            # crashed, resumed, finished
    ("finish", 0, ["False"])])
def test_supervisor(tmp_path, capsys, monkeypatch, mode, code, starts):
    models = tmp_path / "models"
    cfg = tmp_path / "opt.json"
    cfg.write_text(json.dumps({"path": {"models": str(models)}}))
    stub = tmp_path / "stub_trainer.py"
    stub.write_text(STUB.format(log=str(models / "train.log"), mode=mode))
    supervisor = _script("train_supervisor_torch")
    monkeypatch.setattr(supervisor, "TRAINER", str(stub))
    got = supervisor.main([
        "-opt", str(cfg), "--poll", "0.1", "--stall-timeout", "1",
        "--max-restarts", "2"])
    assert got == code
    lines = (models / "train.log").read_text().splitlines()
    assert [ln.split("=")[1] for ln in lines if ln.startswith("start")] == (
        starts)
    out = capsys.readouterr().out
    if mode == "stall":
        assert out.count("no progress") == 3
        assert "max restarts exceeded" in out
    else:
        assert "training finished" in out


# ------------------------------------------------- test_video_torch --params

def test_video_script_params(tmp_path):
    """``--params`` reads the weights the port's trainer writes, as a
    weights-only file and inside a full checkpoint: the same frames."""
    from stif_tpu_torch.models import LunaTokis
    from stif_tpu_torch.train.checkpoints import CheckpointManager

    folder = tmp_path / "in" / "clip"
    folder.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(2):
        cv2.imwrite(str(folder / f"{i:03d}.png"),
                    (rng.random((16, 16, 3)) * 255).astype(np.uint8))
    torch.manual_seed(3)
    state = LunaTokis().state_dict()
    ck = CheckpointManager(str(tmp_path / "models"))
    files = [ck.save_params_only(state, 7),
             ck.path(ck.save(7, state, {"state": {}, "param_groups": []}))]
    main = _main("test_video_torch")
    outs = []
    for i, path in enumerate(files):
        main(["--input", str(tmp_path / "in"), "--output",
              str(tmp_path / f"out{i}"), "--times", "2", "--params", path,
              "--device", "cpu"])
        outs.append([cv2.imread(str(tmp_path / f"out{i}" / "clip" / "HR"
                                    / f"{k}.jpg")) for k in range(2)])
    for a, b in zip(*outs):
        assert a.shape == (32, 32, 3)
        np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match="Missing key"):
        torch.save({"bogus": torch.zeros(1)}, tmp_path / "bad.pth")
        main(["--input", str(tmp_path / "in"), "--output",
              str(tmp_path / "bad"), "--params", str(tmp_path / "bad.pth"),
              "--device", "cpu"])
