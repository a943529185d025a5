"""Training datasets (port of ``stif_tpu/data/datasets.py``).

  * ``Vimeo7Dataset`` (``codes/data/Vimeo7_dataset.py``): Vimeo-90K
    septuplets; LQ = every 2nd of the N GT frames; temporal augmentation
    (random center index 2..6, random interval, random reverse); random GT
    crop with the matching LQ crop; flip / rot.
  * ``AdobeDataset`` (``codes/data/Adobe_dataset.py``): Adobe240fps windows;
    inputs = frame pair (i, i+8); GT = 1 random frame of the 9-frame window
    with its time = idx/8.
  * ``AdobeArbitraryDataset`` (``codes/data/Adobe_arbitrary.py``): the same
    scan; 3 random GT times per window; raw uint8 arrays, the scale
    augmentation left to the batch collate.

Backends of ``Vimeo7Dataset``: image folders read with cv2; an lmdb
backend with the reference's key / blob schema
(``codes/data/Vimeo7_dataset.py:70-109, 171, 185``: key ``{a}_{b}_{frame}``,
raw uint8 HWC blobs at a fixed size) served by the dependency-free reader
``data.lmdb_io``; and a memcached backend (PNG values by path key, with an
optional ``<root>_B/_G/_R`` single-channel split for memcached's 1 MB value
limit) through ``data.memcache``: the reference's ``mc`` branch with its
call-arity bug (``Vimeo7_dataset.py:168``) fixed, as in the JAX package.
Memcached keys are full paths ``<root>/<a>/<b>/im{i}.png`` (and
``<root>_B/_G/_R/...`` for the split), for LQ and GT alike: the JAX
package's scheme, since the reference's own is unreachable in its code.
Roots and lists are arguments: no hardcoded paths.
"""

from __future__ import annotations

import os
import os.path as osp
import random
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch


def host_imresize(img: np.ndarray, scale: float) -> np.ndarray:
    """MATLAB bicubic resize of (..., H, W, C) on the host: the port's
    ``ops.resize.imresize`` on CPU tensors, numpy in and out. Data workers
    and eval harnesses use it; it never touches the GPU."""
    from stif_tpu_torch.ops.resize import imresize

    x = torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32))
    return imresize(x, scale).numpy()


def _read_img(path: str) -> np.ndarray:
    """BGR HWC uint8 (cv2 convention, like the reference readers)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    return img[..., :3]


def _read_img_lmdb(env, key: str, size) -> np.ndarray:
    """Raw uint8 HWC blob by key (``data/util.py::_read_img_lmdb``)."""
    buf = env.get(key.encode("ascii"))
    if buf is None:
        raise KeyError(f"lmdb key not found: {key}")
    c, h, w = size
    return np.frombuffer(buf, np.uint8).reshape(h, w, c)


class Vimeo7Dataset:
    """Septuplets: ``root/<a>/<b>/im{1..7}.png`` (``data_type`` 'img'),
    lmdb blobs keyed ``<a>_<b>_<frame>`` ('lmdb') or PNGs in memcached
    ('mc', explicit ``keys`` needed).

    Returns dict with ``LQs`` (N_in, h, w, 3), ``GT`` (N_out, H, W, 3) float32
    RGB, NHWC, plus ``times`` and ``key``.
    """

    def __init__(self, gt_root: str, lq_root: Optional[str] = None,
                 n_frames: int = 7, gt_size: int = 192, scale: int = 4,
                 interval_list: Sequence[int] = (1,),
                 random_reverse: bool = False, use_flip: bool = True,
                 use_rot: bool = True, keys: Optional[List[str]] = None,
                 phase: str = "train", seed: Optional[int] = None,
                 data_type: str = "img", gt_shape=(3, 256, 448),
                 mc_host: str = "127.0.0.1", mc_port: int = 11211,
                 mc_channel_split: bool = False):
        if data_type not in ("img", "lmdb", "mc"):
            raise ValueError(f"Wrong data type: {data_type}")
        self.gt_root, self.lq_root = gt_root, lq_root or gt_root
        self.data_type = data_type
        self.mc_host, self.mc_port = mc_host, mc_port
        self.mc_channel_split = mc_channel_split
        # one memcached client per loader thread: a client's socket and
        # read buffer must not interleave two requests
        self._mc_local = threading.local()
        # the reference's blob sizes: GT (3, 256, 448), LQ = GT / scale
        # (Vimeo7_dataset.py:171, 185)
        self.gt_shape = tuple(gt_shape)
        self.lq_shape = (gt_shape[0], gt_shape[1] // scale,
                         gt_shape[2] // scale)
        self._gt_env = self._lq_env = None
        self.n_frames = n_frames
        self.half = n_frames // 2
        self.gt_size, self.scale = gt_size, scale
        self.interval_list = list(interval_list)
        self.random_reverse = random_reverse
        self.use_flip, self.use_rot = use_flip, use_rot
        self.phase = phase
        self.rng = random.Random(seed)
        if keys is None:
            if data_type == "mc":
                # memcached cannot list its keys; the reference loads a
                # pickled key cache (Vimeo7_dataset.py:60-66)
                raise ValueError("data_type='mc' requires explicit keys")
            if data_type == "lmdb":
                # the septuplet keys, recovered from the database's keys
                keys = sorted({k.decode("ascii").rsplit("_", 1)[0]
                               for k in self._env("gt").keys()})
            else:
                keys = []
                for a in sorted(os.listdir(gt_root)):
                    pa = osp.join(gt_root, a)
                    if not osp.isdir(pa):
                        continue
                    for b in sorted(os.listdir(pa)):
                        if osp.isdir(osp.join(pa, b)):
                            keys.append(f"{a}_{b}")
        self.keys = keys

    def _mc(self):
        """This thread's memcached client, connected at first use (the
        reference's ``_ensure_memcached``)."""
        client = getattr(self._mc_local, "client", None)
        if client is None:
            from stif_tpu_torch.data.memcache import MemcachedClient

            client = MemcachedClient(self.mc_host, self.mc_port)
            self._mc_local.client = client
        return client

    def _read_img_mc(self, key: str) -> np.ndarray:
        """PNG bytes by path key -> BGR HWC uint8 (``_read_img_mc``)."""
        import cv2

        buf = self._mc().get(key)
        if buf is None:
            raise KeyError(f"memcached key not found: {key}")
        img = cv2.imdecode(np.frombuffer(buf, np.uint8),
                           cv2.IMREAD_UNCHANGED)
        if img is None:
            raise ValueError(f"memcached value is not an image: {key}")
        return img

    def _read_img_mc_bgr(self, root: str, rel: str) -> np.ndarray:
        """One frame merged from single-channel PNGs under ``<root>_B``,
        ``_G`` and ``_R`` (the reference's ``_read_img_mc_BGR``, with its
        argument-arity bug fixed)."""
        import cv2

        return cv2.merge([self._read_img_mc(osp.join(root + suffix, rel))
                          for suffix in ("_B", "_G", "_R")])

    def _env(self, which: str):
        """The GT or LQ database, opened at first use (``_init_lmdb``)."""
        from stif_tpu_torch.data.lmdb_io import LmdbReader

        if which == "gt":
            if self._gt_env is None:
                self._gt_env = LmdbReader(self.gt_root)
            return self._gt_env
        if self._lq_env is None:
            self._lq_env = LmdbReader(self.lq_root)
        return self._lq_env

    def __len__(self):
        return len(self.keys)

    def _frames(self, key: str, neighbors, lq_idx):
        """GT frames ``neighbors`` and LQ frames ``lq_idx`` of septuplet
        ``key``, float32 BGR in [0, 1]."""
        name_a, name_b = key.split("_")
        if self.data_type == "mc":
            # GT through the channel split when it is on (the reference
            # always splits GT, Vimeo7_dataset.py:168); LQ as whole PNGs
            def read_gt(rel):
                if self.mc_channel_split:
                    return self._read_img_mc_bgr(self.gt_root, rel)
                return self._read_img_mc(osp.join(self.gt_root, rel))

            gt = [read_gt(osp.join(name_a, name_b, f"im{i}.png"))
                  for i in neighbors]
            lq = [self._read_img_mc(osp.join(self.lq_root, name_a, name_b,
                                             f"im{i}.png")) for i in lq_idx]
        elif self.data_type == "lmdb":
            gt = [_read_img_lmdb(self._env("gt"), f"{key}_{i}",
                                 self.gt_shape) for i in neighbors]
            lq = [_read_img_lmdb(self._env("lq"), f"{key}_{i}",
                                 self.lq_shape) for i in lq_idx]
        else:
            gt_dir = osp.join(self.gt_root, name_a, name_b)
            lq_dir = osp.join(self.lq_root, name_a, name_b)
            gt = [_read_img(osp.join(gt_dir, f"im{i}.png"))
                  for i in neighbors]
            lq = [_read_img(osp.join(lq_dir, f"im{i}.png")) for i in lq_idx]
        return ([im.astype(np.float32) / 255.0 for im in gt],
                [im.astype(np.float32) / 255.0 for im in lq])

    def __getitem__(self, index: int):
        from stif_tpu_torch.data.transforms import augment_stack

        key = self.keys[index]
        interval = self.rng.choice(self.interval_list)
        center = self.rng.randint(2, 6)
        while (center + self.half * interval > 7) or (
            center - self.half * interval < 1
        ):
            center = self.rng.randint(2, 6)
        neighbors = list(range(center - self.half * interval,
                               center + self.half * interval + 1, interval))
        if self.random_reverse and self.rng.random() < 0.5:
            neighbors.reverse()
        lq_idx = neighbors[::2]  # LQ frames = every 2nd GT frame (:52-54)
        img_gt, img_lq = self._frames(key, neighbors, lq_idx)

        if self.phase == "train":
            s = self.scale
            lh, lw = img_lq[0].shape[:2]
            lq_size = self.gt_size // s
            rh = self.rng.randint(0, max(0, lh - lq_size))
            rw = self.rng.randint(0, max(0, lw - lq_size))
            img_lq = [im[rh:rh + lq_size, rw:rw + lq_size] for im in img_lq]
            gh, gw = rh * s, rw * s
            img_gt = [im[gh:gh + self.gt_size, gw:gw + self.gt_size]
                      for im in img_gt]
            stack = augment_stack(img_lq + img_gt, self.use_flip,
                                  self.use_rot, self.rng)
            img_lq = stack[: len(img_lq)]
            img_gt = stack[len(img_lq):]

        lqs = np.stack(img_lq)[..., ::-1]  # BGR -> RGB
        gts = np.stack(img_gt)[..., ::-1]
        times = np.asarray(
            [i / (len(neighbors) - 1) for i in range(len(neighbors))],
            np.float32,
        )
        return {"LQs": np.ascontiguousarray(lqs),
                "GT": np.ascontiguousarray(gts), "times": times, "key": key}


def _scan_adobe(gt_root: str, video_list: Sequence[str], interval: int = 7):
    """Window scan of ``Adobe_arbitrary.py:90-108``: numerically sorted
    frames; windows [i, i+interval+1] advancing by 1."""
    file_list, gt_list = [], []
    for video in video_list:
        video = video.strip()
        frames = os.listdir(osp.join(gt_root, video))
        frames = sorted(int(f.rsplit(".", 1)[0]) for f in frames)
        frames = [f"{f}.png" for f in frames]
        index = 0
        while index + interval + 1 < len(frames):
            ins = [frames[index], frames[index + 1 + interval]]
            gts = [frames[i] for i in range(index, index + 2 + interval)]
            file_list.append([osp.join(video, f) for f in ins])
            gt_list.append([osp.join(video, f) for f in gts])
            index += 1
    return file_list, gt_list


class AdobeDataset:
    """x8 temporal windows with ONE random GT time per sample
    (``Adobe_dataset.py:189-196``). Returns crops at fixed x``scale``."""

    def __init__(self, gt_root: str,
                 video_list: Optional[Sequence[str]] = None,
                 gt_size: int = 192, scale: int = 4, use_flip: bool = True,
                 use_rot: bool = True, phase: str = "train",
                 seed: Optional[int] = None):
        self.gt_root = gt_root
        self.gt_size, self.scale = gt_size, scale
        self.use_flip, self.use_rot = use_flip, use_rot
        self.phase = phase
        self.rng = random.Random(seed)
        if video_list is None:
            video_list = sorted(
                d for d in os.listdir(gt_root)
                if osp.isdir(osp.join(gt_root, d))
            )
        self.file_list, self.gt_list = _scan_adobe(gt_root, video_list)

    def __len__(self):
        return len(self.file_list)

    def __getitem__(self, index: int):
        from stif_tpu_torch.data.transforms import augment_stack

        gt_idx = self.rng.randint(0, 8)
        in_paths = [osp.join(self.gt_root, p) for p in self.file_list[index]]
        gt_path = osp.join(self.gt_root, self.gt_list[index][gt_idx])
        imgs_in = [
            _read_img(p).astype(np.float32) / 255.0 for p in in_paths
        ]
        img_gt = _read_img(gt_path).astype(np.float32) / 255.0

        s = self.scale
        gh, gw = img_gt.shape[:2]
        g = self.gt_size
        rh = self.rng.randint(0, max(0, gh - g))
        rw = self.rng.randint(0, max(0, gw - g))
        img_gt = img_gt[rh:rh + g, rw:rw + g]
        crops_in = [im[rh:rh + g, rw:rw + g] for im in imgs_in]
        lqs = [host_imresize(c, 1.0 / s) for c in crops_in]
        if self.phase == "train":
            stack = augment_stack(lqs + [img_gt], self.use_flip, self.use_rot,
                                  self.rng)
            lqs, img_gt = stack[:-1], stack[-1]
        lqs = np.stack(lqs)[..., ::-1]
        gt = img_gt[None][..., ::-1]
        return {
            "LQs": np.ascontiguousarray(lqs),
            "GT": np.ascontiguousarray(gt),
            "times": np.asarray([gt_idx / 8], np.float32),
            "key": self.gt_list[index][gt_idx],
        }


class AdobeArbitraryDataset:
    """Raw windows for arbitrary-scale training: inputs (i, i+8) + 3 random
    GT times, as uint8 BGR arrays; the batch collate applies the random-scale
    degradation (``Adobe_arbitrary.py:189-202``)."""

    def __init__(self, gt_root: str,
                 video_list: Optional[Sequence[str]] = None,
                 seed: Optional[int] = None):
        self.gt_root = gt_root
        self.rng = random.Random(seed)
        if video_list is None:
            video_list = sorted(
                d for d in os.listdir(gt_root)
                if osp.isdir(osp.join(gt_root, d))
            )
        self.file_list, self.gt_list = _scan_adobe(gt_root, video_list)

    def __len__(self):
        return len(self.file_list)

    def __getitem__(self, index: int):
        sampled = sorted(self.rng.sample(range(len(self.gt_list[index])), 3))
        in_imgs = [
            _read_img(osp.join(self.gt_root, p)) for p in self.file_list[index]
        ]
        gt_imgs = [
            _read_img(osp.join(self.gt_root, self.gt_list[index][i]))
            for i in sampled
        ]
        times = np.asarray([i / 8 for i in sampled], np.float32)
        return {"LQs_raw": in_imgs, "GT_raw": gt_imgs, "times": times}


def create_dataset(mode: str, **kwargs):
    """Dispatch like the reference factory (``data/__init__.py:45-60``)."""
    if mode == "Vimeo7":
        return Vimeo7Dataset(**kwargs)
    if mode == "Adobe":
        return AdobeDataset(**kwargs)
    if mode == "Adobe_a":
        return AdobeArbitraryDataset(**kwargs)
    if mode == "Synthetic":
        from stif_tpu_torch.data.synthetic import SyntheticVideoDataset

        return SyntheticVideoDataset(**kwargs)
    raise NotImplementedError(f"Dataset [{mode}] is not recognized.")


def create_train_dataset(opt):
    """Config-driven train dataset + collate from a parsed options dict.

    Mirrors the reference's ``create_dataset(dataset_opt)`` path: backend
    selection follows ``options.py:27-38`` (lmdb inferred from a ``.lmdb``
    dataroot suffix, ``mc`` only when explicit) and ``cache_keys`` is the
    reference's pickled key list (``Vimeo7_dataset.py:60-66``; entries
    ``a_b`` or ``a_b_frame``) — here a config-relative path instead of a
    hardcoded meta_info dir. Returns ``(dataset, collate_fn)``.
    """
    from stif_tpu_torch.data.collate import (collate_arbitrary_scale,
                                             collate_fixed)

    dopt = opt["datasets"]["train"]
    mode = dopt["mode"]
    common = dict(gt_root=dopt.get("dataroot_GT"))
    if mode == "Vimeo7":
        data_type = dopt.get("data_type")
        if not data_type:
            roots = [dopt.get("dataroot_GT"), dopt.get("dataroot_LQ")]
            data_type = ("lmdb" if any(
                str(r).endswith("lmdb") for r in roots if r) else "img")
        keys = None
        if dopt.get("cache_keys"):
            import pickle

            with open(dopt["cache_keys"], "rb") as f:
                raw = pickle.load(f)
            keys = list(dict.fromkeys(
                "_".join(str(k).split("_")[:2]) for k in raw))
        extra = {}
        if data_type == "mc":
            extra = dict(mc_host=dopt.get("mc_host", "127.0.0.1"),
                         mc_port=int(dopt.get("mc_port", 11211)),
                         mc_channel_split=bool(dopt.get("mc_channel_split")))
        if dopt.get("gt_shape"):
            extra["gt_shape"] = tuple(dopt["gt_shape"])
        ds = create_dataset("Vimeo7", lq_root=dopt.get("dataroot_LQ"),
                            n_frames=int(dopt.get("N_frames", 7)),
                            gt_size=int(dopt.get("GT_size", 192)),
                            scale=int(opt.get("scale", 4)),
                            random_reverse=bool(dopt.get("random_reverse")),
                            interval_list=dopt.get("interval_list") or (1,),
                            use_flip=bool(dopt.get("use_flip", True)),
                            use_rot=bool(dopt.get("use_rot", True)),
                            data_type=data_type, keys=keys, **extra,
                            **common)
        return ds, collate_fixed
    if mode == "Adobe":
        ds = create_dataset("Adobe", gt_size=int(dopt.get("GT_size", 192)),
                            scale=int(opt.get("scale", 4)), **common)
        return ds, collate_fixed
    if mode == "Adobe_a":
        ds = create_dataset("Adobe_a", **common)
        return ds, (lambda samples: collate_arbitrary_scale(
            samples, lq_size=int(dopt.get("LQ_size", 64)),
            scale_buckets=dopt.get("scale_buckets"),
        ))
    if mode == "Synthetic":
        ds = create_dataset(
            "Synthetic",
            n_items=int(dopt.get("n_items", 20000)),
            gt_size=int(dopt.get("GT_size", 192)),
            scale=int(opt.get("scale", 4)),
            nt=int(dopt.get("nt", 3)),
            seed=int(dopt.get("seed", 0)),
            interval_choices=dopt.get("interval_choices"),
            # mixed-scale bucket plan [[scale, lq_size], ...]: a per-batch
            # random scale (the reference's collate_function2 recipe over
            # buckets); engages the loader's batch-level path
            scale_plan=dopt.get("scale_plan"),
            natural_frac=float(dopt.get("natural_frac", 0) or 0),
        )
        return ds, collate_fixed
    raise NotImplementedError(mode)
