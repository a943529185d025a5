"""The port's data pipeline against the JAX package's on the CPU: the
sampler, the threaded loader and ``SyntheticVideoDataset`` give the same
batches from the same seed (bitwise, except frames made by the MATLAB
bicubic resize, whose sums run in another order: within 1e-6); the
collates, ``augment_stack``, the Vimeo7 and Adobe folder datasets on PNGs
written here, the natural-photo scenes (on a photo written here), the
config-driven factory, and TensorBoard events."""

import os
import random

import numpy as np
import pytest

from stif_tpu.data import collate as jcollate
from stif_tpu.data import datasets as jdatasets
from stif_tpu.data import loader as jloader
from stif_tpu.data import natural as jnatural
from stif_tpu.data import synthetic as jsynthetic
from stif_tpu.data import transforms as jtransforms
from stif_tpu.utils import tb as jtb

from stif_tpu_torch.data import collate, datasets, loader, natural, synthetic
from stif_tpu_torch.data import transforms
from stif_tpu_torch.utils import tb
import torch_parity  # noqa: F401  (caps PyTorch's threads)

RESIZED = ("LQs",)  # keys whose frames come through the bicubic resize


def _write_png(path, arr):
    import cv2

    os.makedirs(os.path.dirname(path), exist_ok=True)
    cv2.imwrite(path, arr)


def _same(got, want, resized=RESIZED):
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, (list, str, int, tuple)):
            assert g == w, k
        elif k in resized:
            assert g.shape == w.shape and g.dtype == w.dtype, k
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
        else:
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.fixture(scope="module")
def vimeo_root(tmp_path_factory):
    gt_root = tmp_path_factory.mktemp("vimeo_gt")
    lq_root = tmp_path_factory.mktemp("vimeo_lq")
    rng = np.random.default_rng(0)
    for b in ["0001", "0002", "0003"]:
        for i in range(1, 8):
            img = (rng.random((32, 48, 3)) * 255).astype(np.uint8)
            _write_png(str(gt_root / "00001" / b / f"im{i}.png"), img)
            _write_png(str(lq_root / "00001" / b / f"im{i}.png"),
                       img[::4, ::4])
    return str(gt_root), str(lq_root)


@pytest.fixture(scope="module")
def adobe_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("adobe")
    rng = np.random.default_rng(1)
    for i in range(12):
        img = (rng.random((100, 140, 3)) * 255).astype(np.uint8)
        _write_png(str(root / "vid1" / f"{i}.png"), img)
    return str(root)


@pytest.fixture(scope="module")
def photo(tmp_path_factory):
    """A 'photograph' with broadband texture: smoothed noise plus edges."""
    rng = np.random.default_rng(2)
    img = rng.random((300, 360, 3))
    for _ in range(3):
        img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3
    img[::37] = 0.9
    path = str(tmp_path_factory.mktemp("photo") / "photo.png")
    _write_png(path, (img * 255).astype(np.uint8))
    return path


# ---------------------------------------------------------------- sampler

@pytest.mark.parametrize("world_size,rank", [(1, 0), (4, 1), (4, 3)])
def test_sampler(world_size, rank):
    args = dict(n_items=37, ratio=3, world_size=world_size, rank=rank,
                seed=5)
    got = loader.ShardedIterSampler(**args)
    want = jloader.ShardedIterSampler(**args)
    assert got.num_samples == want.num_samples
    for epoch in range(3):
        np.testing.assert_array_equal(got.epoch_indices(epoch),
                                      want.epoch_indices(epoch))


# ------------------------------------------------------------- synthetic

SYN = dict(n_items=50, gt_size=32, scale=4, nt=3, seed=11,
           interval_choices=[2, 2, 4], scale_plan=[[4, 8], [2, 8], [8, 4]])


@pytest.mark.parametrize("natural_frac", [0.0, 0.5])
def test_loader_batches_match(natural_frac, photo, monkeypatch):
    """Three batches of the loader over ``SyntheticVideoDataset`` with a
    bucket plan (one scale per batch), per-sample interval choices and
    times and, in one case, photographic scenes for half of the samples."""
    for mod in (natural, jnatural):
        monkeypatch.setattr(mod, "find_natural_textures", lambda: [photo])

    def batches(ds_cls, loader_mod):
        ds = ds_cls(natural_frac=natural_frac, **SYN)
        dl = loader_mod.DataLoader(
            ds, batch_size=3, collate=None,
            sampler=loader_mod.ShardedIterSampler(len(ds), ratio=2, seed=1))
        gen = dl.epoch(1)
        out = [next(gen) for _ in range(3)]
        gen.close()
        return out

    got = batches(synthetic.SyntheticVideoDataset, loader)
    want = batches(jsynthetic.SyntheticVideoDataset, jloader)
    assert {b["scale"] for b in want} > {4}  # more than one bucket drawn
    for g, w in zip(got, want):
        _same(g, w)
    assert got[0]["times"].shape == (3, 3)


def test_synthetic_items_eval_phase():
    """Per-sample items (no bucket plan) and the eval phase's evenly spaced
    times."""
    for phase in ("train", "val"):
        args = dict(n_items=10, gt_size=24, scale=3, nt=4, seed=2,
                    phase=phase)
        got = synthetic.SyntheticVideoDataset(**args)
        want = jsynthetic.SyntheticVideoDataset(**args)
        assert not got.use_load_batch
        for i in (0, 7):
            _same(got[i], want[i])


def test_loader_collates_and_stops(vimeo_root):
    """The per-sample path with ``collate_fixed``, ``__len__``, a last
    partial batch, and a consumer that stops early (the thread exits)."""
    gt_root, lq_root = vimeo_root

    def make(ds_mod, loader_mod, collate_mod, drop_last):
        ds = ds_mod.Vimeo7Dataset(gt_root, lq_root, gt_size=16, scale=4,
                                  seed=0)
        return loader_mod.DataLoader(ds, batch_size=2,
                                     collate=collate_mod.collate_fixed,
                                     drop_last=drop_last, seed=3)

    for drop_last in (True, False):
        got = make(datasets, loader, collate, drop_last)
        want = make(jdatasets, jloader, jcollate, drop_last)
        assert len(got) == len(want) == (1 if drop_last else 2)
        gb, wb = list(got.epoch(0)), list(want.epoch(0))
        assert len(gb) == len(wb) == len(got)
        for g, w in zip(gb, wb):
            _same(g, w, resized=())
    gen = make(datasets, loader, collate, False).epoch(0)
    next(gen)
    gen.close()  # must not hang


def test_loader_raises_what_the_dataset_raised():
    class Broken:
        use_load_batch = True

        def __len__(self):
            return 4

        def load_batch(self, idx):
            raise OSError("unreadable frame")

    dl = loader.DataLoader(Broken(), batch_size=2, collate=None)
    with pytest.raises(OSError, match="unreadable"):
        list(dl.epoch(0))


# ---------------------------------------------------------- folder datasets

def test_vimeo7(vimeo_root):
    gt_root, lq_root = vimeo_root
    for kw in (dict(), dict(interval_list=[1, 2], random_reverse=True,
                            n_frames=3), dict(phase="val")):
        got = datasets.Vimeo7Dataset(gt_root, lq_root, gt_size=16, scale=4,
                                     seed=4, **kw)
        want = jdatasets.Vimeo7Dataset(gt_root, lq_root, gt_size=16,
                                       scale=4, seed=4, **kw)
        assert got.keys == want.keys and len(got) == 3
        for i in (0, 2, 1, 0):
            _same(got[i], want[i], resized=())
    # memcached cannot list keys; an unknown backend is refused
    with pytest.raises(ValueError, match="explicit keys"):
        datasets.Vimeo7Dataset(gt_root, data_type="mc")
    with pytest.raises(ValueError, match="Wrong data type"):
        datasets.Vimeo7Dataset(gt_root, data_type="hdf5")


def test_adobe(adobe_root):
    got = datasets.AdobeDataset(adobe_root, gt_size=32, scale=4, seed=0)
    want = jdatasets.AdobeDataset(adobe_root, gt_size=32, scale=4, seed=0)
    assert got.file_list == want.file_list and len(got) == 4
    for i in (0, 2, 1):
        _same(got[i], want[i])


@pytest.mark.parametrize("buckets", [None, [2.0, 3.0]])
def test_adobe_arbitrary_collate(adobe_root, buckets):
    got_ds = datasets.AdobeArbitraryDataset(adobe_root, seed=0)
    want_ds = jdatasets.AdobeArbitraryDataset(adobe_root, seed=0)
    samples = [got_ds[0], got_ds[1]]
    jsamples = [want_ds[0], want_ds[1]]
    for s, j in zip(samples, jsamples):
        np.testing.assert_array_equal(s["times"], j["times"])
        for a, b in zip(s["GT_raw"], j["GT_raw"]):
            np.testing.assert_array_equal(a, b)
    got = collate.collate_arbitrary_scale(samples, lq_size=16,
                                          scale_buckets=buckets,
                                          rng=random.Random(3))
    want = jcollate.collate_arbitrary_scale(jsamples, lq_size=16,
                                            scale_buckets=buckets,
                                            rng=random.Random(3))
    _same(got, want, resized=("LQs", "GT"))


def test_augment_stack():
    rng = np.random.default_rng(0)
    imgs = [rng.random((2, 5, 7, 3)).astype(np.float32),
            rng.random((5, 7, 3)).astype(np.float32)]
    for seed in range(8):
        got = transforms.augment_stack(imgs, True, True, random.Random(seed))
        want = jtransforms.augment_stack(imgs, True, True,
                                         random.Random(seed))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.flags["C_CONTIGUOUS"]


def test_create_train_dataset(vimeo_root):
    """The factory from an options dict: Synthetic with a bucket plan (the
    loader's batch-level path) and Vimeo7 folders; the lmdb backend is
    inferred from the root's suffix (here a database that is not there)."""
    opt = {"scale": 4, "datasets": {"train": {
        "mode": "Synthetic", "n_items": 30, "GT_size": 32, "nt": 2,
        "seed": 9, "scale_plan": [[4, 8], [2, 8]]}}}
    ds, coll = datasets.create_train_dataset(opt)
    jds, _ = jdatasets.create_train_dataset(
        {"scale": 4, "datasets": {"train": dict(
            opt["datasets"]["train"], dataroot_GT=None)}})
    assert ds.use_load_batch and coll is collate.collate_fixed
    _same(ds.load_batch([3, 1]), jds.load_batch([3, 1]))
    gt_root, lq_root = vimeo_root
    vopt = {"scale": 4, "datasets": {"train": {
        "mode": "Vimeo7", "dataroot_GT": gt_root, "dataroot_LQ": lq_root,
        "GT_size": 16}}}
    ds, _ = datasets.create_train_dataset(vopt)
    assert isinstance(ds, datasets.Vimeo7Dataset) and len(ds) == 3
    vopt["datasets"]["train"]["dataroot_GT"] = gt_root + ".lmdb"
    with pytest.raises(FileNotFoundError, match="lmdb"):
        datasets.create_train_dataset(vopt)
    with pytest.raises(NotImplementedError):
        datasets.create_dataset("REDS")


def test_host_imresize(rng):
    from stif_tpu.data.native import host_imresize as j_host_imresize

    x = rng.random((2, 3, 20, 28, 3)).astype(np.float32)
    for scale in (0.25, 0.5, 1 / 3, 2.0):
        got = datasets.host_imresize(x, scale)
        want = j_host_imresize(x, scale)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ------------------------------------------------------------ natural scenes

def test_natural_scenes(photo, rng):
    """The layered scene sampler and renderer on a photo written here."""
    for seed in range(3):
        got = natural.sample_natural_scene(np.random.default_rng(seed),
                                           min_canvas=(96, 96),
                                           photos=[photo])
        want = jnatural.sample_natural_scene(np.random.default_rng(seed),
                                             min_canvas=(96, 96),
                                             photos=[photo])
        assert got.keys() == want.keys() and got["kind"] == "natural"
        for t in (0.0, 2.5):
            np.testing.assert_array_equal(
                natural.render_natural_frame(got, t, (40, 56), (20.5, 30)),
                jnatural.render_natural_frame(want, t, (40, 56), (20.5, 30)))
    img = (rng.random((60, 80, 3)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(
        natural.render_pan_sequence(img, 4, (20, 30), vel=(-2, 3)),
        jnatural.render_pan_sequence(img, 4, (20, 30), vel=(-2, 3)))


def test_natural_eval_sets(photo, tmp_path, monkeypatch):
    """Both eval-set functions write the JAX package's PNGs; with no photo
    they write nothing."""
    import cv2

    for mod in (natural, jnatural):
        monkeypatch.setattr(mod, "find_natural_textures", lambda: [photo])
    for build in ("build_natural_eval_set", "build_natural_eval_set_v2"):
        kw = dict(n_frames=4, size=(48, 64))
        if build.endswith("v2"):
            kw["n_scenes"] = 2
        got = getattr(natural, build)(str(tmp_path / "got"), **kw)
        want = getattr(jnatural, build)(str(tmp_path / "want"), **kw)
        assert got == want and got
        for name in got:
            files = sorted(os.listdir(tmp_path / "want" / name))
            assert sorted(os.listdir(tmp_path / "got" / name)) == files
            for f in files:
                np.testing.assert_array_equal(
                    cv2.imread(str(tmp_path / "got" / name / f)),
                    cv2.imread(str(tmp_path / "want" / name / f)))
    monkeypatch.setattr(natural, "find_natural_textures", lambda: [])
    assert natural.build_natural_eval_set(str(tmp_path / "none")) == []
    assert natural.build_natural_eval_set_v2(str(tmp_path / "none")) == []


# -------------------------------------------------------------- tensorboard

def test_tb_events_round_trip(tmp_path):
    w = tb.TBWriter(str(tmp_path / "tb"))
    for step, v in ((1, 0.5), (10, -2.25), (300, 1e6)):
        w.add_scalar("train/loss", v, step)
    w.close()
    for read in (tb.read_events, jtb.read_events):
        ev = read(w.path)
        assert ev[0]["file_version"] == "brain.Event:2"
        assert [(e["tag"], e["step"], e["value"]) for e in ev[1:]] == [
            ("train/loss", 1, 0.5), ("train/loss", 10, -2.25),
            ("train/loss", 300, 1e6)]
    assert tb.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    with open(w.path, "r+b") as f:  # a flipped byte fails its CRC
        f.seek(20)
        b = f.read(1)
        f.seek(20)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(ValueError):
        tb.read_events(w.path)
