"""Dependency-free LMDB file format reader/writer (the port's own copy of
``stif_tpu/data/lmdb_io.py``; pure Python).

Capability parity for the reference's lmdb dataset backend
(``codes/data/Vimeo7_dataset.py:70-109`` reads frame blobs from an LMDB
environment) in an image where the ``lmdb`` package does not exist: this
module implements the on-disk format (LMDB 0.9 ``data.mdb``) directly —
meta pages, branch/leaf B-tree pages, overflow (BIGDATA) pages — so
databases written by the real liblmdb are readable here and vice versa.

Scope: read-only access (``LmdbReader``) plus a batch writer
(``write_lmdb``) that builds the B-tree bottom-up in one transaction,
streaming pages to disk in O(page) memory — all the dataset pipeline
needs. No freelist, no nested DBs, no DUPSORT.

Layout constants follow lmdb.h (64-bit, little-endian, 4096-byte pages).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterable, List, Optional, Tuple

PAGE = 4096
MAGIC = 0xBEEFC0DE
VERSION = 1
HDRSZ = 16          # MDB_page header size (pgno 8 + pad 2 + flags 2 + 2 + 2)

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08

F_BIGDATA = 0x01    # node flag: data is an overflow pgno

# MDB_db: pad u32, flags u16, depth u16, branch u64, leaf u64, overflow u64,
# entries u64, root u64
_DB = struct.Struct("<IHHQQQQQ")
# MDB_meta prefix: magic u32, version u32, address u64, mapsize u64
_META_HEAD = struct.Struct("<IIQQ")
_META_TAIL = struct.Struct("<QQ")  # last_pg, txnid


def _node_pgno(lo: int, hi: int, flags: int) -> int:
    return lo | (hi << 16) | (flags << 32)


class LmdbReader:
    """Read-only LMDB environment over ``data.mdb`` (or a subdir path)."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self.path = path
        self._f = open(path, "rb")
        self._size = os.path.getsize(path)
        meta = []
        for pg in (0, 1):
            raw = self._page(pg)
            magic, ver, _, _ = _META_HEAD.unpack_from(raw, HDRSZ)
            if magic != MAGIC:
                continue
            off = HDRSZ + _META_HEAD.size + 2 * _DB.size
            last_pg, txnid = _META_TAIL.unpack_from(raw, off)
            main = _DB.unpack_from(raw, HDRSZ + _META_HEAD.size + _DB.size)
            meta.append((txnid, main, last_pg))
        if not meta:
            raise ValueError(f"{path}: not an LMDB data file")
        meta.sort()
        _, main, _ = meta[-1]
        self._root = main[7]
        self.entries = main[6]
        self.depth = main[2]

    def _page(self, pgno: int, npages: int = 1) -> bytes:
        self._f.seek(pgno * PAGE)
        return self._f.read(npages * PAGE)

    @staticmethod
    def _page_flags(raw: bytes) -> int:
        return struct.unpack_from("<H", raw, 10)[0]

    @staticmethod
    def _numkeys(raw: bytes) -> int:
        lower = struct.unpack_from("<H", raw, 12)[0]
        return (lower - HDRSZ) // 2

    @staticmethod
    def _node(raw: bytes, i: int) -> Tuple[int, int, int, bytes, int]:
        """Returns (lo, hi, flags, key, node_offset)."""
        ptr = struct.unpack_from("<H", raw, HDRSZ + 2 * i)[0]
        lo, hi, flags, ksize = struct.unpack_from("<HHHH", raw, ptr)
        key = raw[ptr + 8: ptr + 8 + ksize]
        return lo, hi, flags, key, ptr

    def get(self, key: bytes) -> Optional[bytes]:
        if isinstance(key, str):
            key = key.encode()
        if self._root == 0xFFFFFFFFFFFFFFFF:  # P_INVALID: empty db
            return None
        raw = self._page(self._root)
        while self._page_flags(raw) & P_BRANCH:
            n = self._numkeys(raw)
            child = None
            for i in range(n - 1, -1, -1):
                lo, hi, fl, k, _ = self._node(raw, i)
                if i == 0 or k <= key:
                    child = _node_pgno(lo, hi, fl)
                    break
            raw = self._page(child)
        n = self._numkeys(raw)
        for i in range(n):
            lo, hi, fl, k, ptr = self._node(raw, i)
            if k == key:
                dsize = lo | (hi << 16)
                if fl & F_BIGDATA:
                    (opg,) = struct.unpack_from(
                        "<Q", raw, ptr + 8 + len(k))
                    oraw = self._page(opg)
                    npages = struct.unpack_from("<I", oraw, 12)[0]
                    blob = self._page(opg, npages)
                    return blob[HDRSZ: HDRSZ + dsize]
                dof = ptr + 8 + len(k)
                return raw[dof: dof + dsize]
            if k > key:
                return None
        return None

    def keys(self) -> List[bytes]:
        """All keys in order (walks every leaf)."""
        out: List[bytes] = []
        if self._root == 0xFFFFFFFFFFFFFFFF:
            return out

        def walk(pgno):
            raw = self._page(pgno)
            n = self._numkeys(raw)
            if self._page_flags(raw) & P_BRANCH:
                for i in range(n):
                    lo, hi, fl, _, _ = self._node(raw, i)
                    walk(_node_pgno(lo, hi, fl))
            else:
                for i in range(n):
                    _, _, _, k, _ = self._node(raw, i)
                    out.append(k)

        walk(self._root)
        return out

    def close(self):
        self._f.close()


class _PageBuf:
    """One page under construction: nodes appended top-down."""

    def __init__(self, pgno: int, flags: int):
        self.pgno = pgno
        self.flags = flags
        self.ptrs: List[int] = []
        self.tail = bytearray()  # node storage, grows downward from PAGE
        self.upper = PAGE

    def free(self) -> int:
        return self.upper - (HDRSZ + 2 * len(self.ptrs)) - 2  # room for ptr

    def add(self, node: bytes):
        self.upper -= len(node)
        self.ptrs.append(self.upper)
        self.tail[0:0] = node  # prepend (nodes packed downward)

    def render(self) -> bytes:
        lower = HDRSZ + 2 * len(self.ptrs)
        out = bytearray(PAGE)
        struct.pack_into("<QHH", out, 0, self.pgno, 0, self.flags)
        struct.pack_into("<HH", out, 12, lower, self.upper)
        for i, p in enumerate(self.ptrs):
            struct.pack_into("<H", out, HDRSZ + 2 * i, p)
        out[self.upper:PAGE] = self.tail
        return bytes(out)


def _even(node: bytes) -> bytes:
    # liblmdb 2-byte-aligns every node (EVEN() in mdb_leaf_size /
    # mdb_branch_size); the pad byte sits after the data, so reader offsets
    # (data at ptr + 8 + ksize, true length in the dsize field) are unchanged.
    return node + b"\0" if len(node) & 1 else node


def _leaf_node(key: bytes, data: bytes, big_pgno: Optional[int]) -> bytes:
    dsize = len(data)
    if big_pgno is not None:
        body = struct.pack("<Q", big_pgno)
        flags = F_BIGDATA
    else:
        body = data
        flags = 0
    return _even(struct.pack("<HHHH", dsize & 0xFFFF, dsize >> 16, flags,
                             len(key)) + key + body)


def _branch_node(key: bytes, pgno: int) -> bytes:
    return _even(struct.pack("<HHHH", pgno & 0xFFFF, (pgno >> 16) & 0xFFFF,
                             (pgno >> 32) & 0xFFFF, len(key)) + key)


def write_lmdb(path: str, items: Iterable[Tuple[bytes, bytes]],
               map_size: int = 1 << 34, sort: bool = True) -> Dict[str, int]:
    """Write ``items`` ((key, value) pairs) as ``path/data.mdb``.

    Single bulk transaction, bottom-up B-tree build; values larger than a
    quarter page go to overflow pages (like liblmdb). Returns stats.

    The build is **streaming**: leaf and overflow pages are written to the
    file as soon as they are complete, only the current page plus one
    (first_key, pgno) pair per finished leaf/branch is buffered, and the two
    meta pages are patched at the end — so dataset-scale databases (hundreds
    of GB of frame blobs via ``tools/make_vimeo_lmdb.py``) build in O(page)
    memory.  With ``sort=True`` (default) the input is materialized and
    sorted first — convenient for small/test inputs; pass ``sort=False`` for
    large pre-sorted streams (key order is verified, ValueError on
    violation).
    """
    os.makedirs(path, exist_ok=True)
    fpath = os.path.join(path, "data.mdb")

    def _enc(x):
        return x.encode() if isinstance(x, str) else x

    if sort:
        items = sorted((_enc(k), _enc(v)) for k, v in items)

    f = open(fpath, "wb")
    try:
        next_pg = 2          # pgno 0/1 = meta, patched at the end
        n_overflow = 0
        n_entries = 0

        def alloc(n: int = 1) -> int:
            nonlocal next_pg
            pg = next_pg
            next_pg += n
            return pg

        def put(pgno: int, data: bytes):
            f.seek(pgno * PAGE)
            f.write(data)

        big_threshold = PAGE // 4  # liblmdb: values > pagesize/4 overflow

        # ---------------------------------------------------------- leaves
        first_keys: List[Tuple[bytes, int]] = []  # (first_key, pgno)/leaf
        leaf: Optional[_PageBuf] = None
        prev_key: Optional[bytes] = None
        for k, v in items:
            k, v = _enc(k), _enc(v)
            if not sort and prev_key is not None and k <= prev_key:
                raise ValueError(
                    f"write_lmdb(sort=False) requires strictly increasing "
                    f"keys: {k!r} after {prev_key!r}")
            prev_key = k
            n_entries += 1
            big = None
            if len(v) > big_threshold:
                npg = (HDRSZ + len(v) + PAGE - 1) // PAGE
                big = alloc(npg)
                hdr = bytearray(HDRSZ)
                struct.pack_into("<QHH", hdr, 0, big, 0, P_OVERFLOW)
                struct.pack_into("<I", hdr, 12, npg)
                # tail of the last overflow page stays zero: seek-past-EOF
                # gaps read back as zeros and truncate() at the end sizes it
                put(big, bytes(hdr) + v)
                n_overflow += npg
            node = _leaf_node(k, v, big)
            if leaf is None or leaf.free() < len(node):
                if leaf is not None:
                    put(leaf.pgno, leaf.render())
                leaf = _PageBuf(alloc(), P_LEAF)
                first_keys.append((k, leaf.pgno))
            leaf.add(node)
        if leaf is not None:
            put(leaf.pgno, leaf.render())

        # --------------------------------------------------------- branches
        # Only one level of (first_key, pgno) pairs is held at a time.
        level = first_keys
        n_leaf = len(first_keys)
        n_branch = 0
        depth = 1 if n_entries else 0
        while len(level) > 1:
            depth += 1
            nxt: List[Tuple[bytes, int]] = []
            buf: Optional[_PageBuf] = None
            for k, pg in level:
                node = _branch_node(b"" if buf is None else k, pg)
                if buf is not None and buf.free() < len(node):
                    put(buf.pgno, buf.render())
                    buf = None
                    node = _branch_node(b"", pg)
                if buf is None:
                    buf = _PageBuf(alloc(), P_BRANCH)
                    n_branch += 1
                    nxt.append((k, buf.pgno))
                buf.add(node)
            put(buf.pgno, buf.render())
            level = nxt
        root = level[0][1] if level else 0xFFFFFFFFFFFFFFFF

        # ------------------------------------------------------- meta pages
        total_pages = next_pg
        f.truncate(total_pages * PAGE)
        for mpg, txnid in ((0, 0), (1, 1)):
            meta = bytearray(PAGE)
            struct.pack_into("<QHH", meta, 0, mpg, 0, P_META)
            _META_HEAD.pack_into(meta, HDRSZ, MAGIC, VERSION, 0,
                                 max(map_size, total_pages * PAGE))
            dboff = HDRSZ + _META_HEAD.size
            # FREE_DBI: empty
            _DB.pack_into(meta, dboff, 0, 0, 0, 0, 0, 0, 0,
                          0xFFFFFFFFFFFFFFFF)
            # MAIN_DBI
            _DB.pack_into(meta, dboff + _DB.size, 0, 0, depth, n_branch,
                          n_leaf, n_overflow, n_entries, root)
            _META_TAIL.pack_into(meta, dboff + 2 * _DB.size,
                                 total_pages - 1, txnid)
            put(mpg, bytes(meta))
    finally:
        f.close()
    return {"entries": n_entries, "pages": total_pages,
            "leaf_pages": n_leaf, "branch_pages": n_branch,
            "overflow_pages": n_overflow, "depth": depth}
