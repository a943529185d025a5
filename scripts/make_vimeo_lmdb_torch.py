#!/usr/bin/env python
"""Build a Vimeo-style LMDB environment from septuplet image folders
(counterpart of ``tools/make_vimeo_lmdb.py``).

Writes a ``data.mdb`` with the reference's schema: key ``{a}_{b}_{frame}``
to a raw uint8 HWC BGR blob, every blob of one size (what the port's
``lmdb`` Vimeo7 backend reads), with the port's dependency-free writer
``stif_tpu_torch.data.lmdb_io.write_lmdb``.

    python scripts/make_vimeo_lmdb_torch.py --root FOLDERS --out ENV_DIR
        [--frames 7]
"""

import argparse
import os
import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))


def items(root: str, frames: int):
    """(key, blob) of every frame of ``root/<a>/<b>/im{1..frames}.png``, in
    sorted key order; every image must share one size."""
    import cv2

    shape = None
    for a in sorted(os.listdir(root)):
        pa = osp.join(root, a)
        if not osp.isdir(pa):
            continue
        for b in sorted(os.listdir(pa)):
            pb = osp.join(pa, b)
            if not osp.isdir(pb):
                continue
            for i in range(1, frames + 1):
                path = osp.join(pb, f"im{i}.png")
                img = cv2.imread(path, cv2.IMREAD_COLOR)
                if img is None:
                    raise FileNotFoundError(path)
                if shape is None:
                    shape = img.shape
                    print(f"blob shape (H, W, C) = {shape}")
                elif img.shape != shape:
                    raise ValueError(f"{path}: {img.shape} != {shape}; "
                                     "lmdb blobs must share one size")
                yield f"{a}_{b}_{i}".encode(), img.tobytes()


def main(argv=None):
    from stif_tpu_torch.data.lmdb_io import write_lmdb

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True,
                    help="septuplet tree: root/<a>/<b>/im{1..N}.png")
    ap.add_argument("--out", required=True, help="output env directory")
    ap.add_argument("--frames", type=int, default=7)
    args = ap.parse_args(argv)
    # sort=False streams pages to disk in O(page) memory, as a Vimeo-90K
    # scale tree needs; the folder walk yields keys in sorted order already
    # (the writer checks it)
    stats = write_lmdb(args.out, items(args.root, args.frames), sort=False)
    print(f"wrote {args.out}: {stats}")
    return stats


if __name__ == "__main__":
    main()
