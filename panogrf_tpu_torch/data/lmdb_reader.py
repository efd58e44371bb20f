"""Minimal read-only LMDB environment reader (pure Python).

Port of ``panogrf_tpu/data/lmdb_reader.py``, unchanged: it needs neither
JAX nor torch.  The reference pre-renders its habitat training data into
LMDB environments (its ``lmdb_rw_render/lmdb_write_render.py:159-248``):
one ``data.mdb`` whose keys are ``"{idx},{field}"`` ASCII strings and whose
values are raw ``numpy`` buffers.  The ``lmdb`` python package is not a
dependency, so this module implements the (stable, documented) LMDB
on-disk format directly — just enough to iterate key/value pairs of a
single-database environment:

* meta pages (0 and 1) — pick the one with the newer ``mm_txnid``;
* branch/leaf B+tree pages of the main DB;
* ``F_BIGDATA`` nodes whose values live on contiguous overflow pages.

Struct layouts follow the canonical ``mdb.c`` definitions (LMDB 0.9.x,
``MDB_DATA_VERSION == 1``); 64-bit little-endian files only (what CPython's
``lmdb`` wheel writes on x86-64/arm64 linux).

Not supported (not used by the reference writer): named sub-databases,
DUPSORT, LEAF2 pages, 32-bit environments.
"""

from __future__ import annotations

import io
import os
import struct
from pathlib import Path
from typing import Iterator, Tuple

MDB_MAGIC = 0xBEEFC0DE
PAGEHDRSZ = 16

# page flags
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

# node flags
F_BIGDATA = 0x01

_META = struct.Struct("<II Q Q")          # magic, version, address, mapsize
_DB = struct.Struct("<IHH QQQQQ")         # pad, flags, depth, branch/leaf/
                                          # overflow pages, entries, root
_TAIL = struct.Struct("<QQ")              # last_pg, txnid


class LMDBFormatError(RuntimeError):
    pass


class _Meta:
    def __init__(self, buf: bytes, off: int):
        magic, version, _addr, self.mapsize = _META.unpack_from(buf, off)
        if magic != MDB_MAGIC:
            raise LMDBFormatError(f"bad meta magic {magic:#x}")
        if version != 1:
            raise LMDBFormatError(f"unsupported LMDB data version {version}")
        off += _META.size
        dbs = []
        for _ in range(2):
            pad, flags, depth, br, lf, ov, ent, root = _DB.unpack_from(
                buf, off)
            dbs.append(dict(pad=pad, flags=flags, depth=depth,
                            branch_pages=br, leaf_pages=lf,
                            overflow_pages=ov, entries=ent, root=root))
            off += _DB.size
        self.free_db, self.main_db = dbs
        self.psize = self.free_db["pad"]
        self.last_pg, self.txnid = _TAIL.unpack_from(buf, off)


class LMDBReader:
    """Iterate (key, value) pairs of the main DB of an LMDB environment.

    :param path: environment directory (containing ``data.mdb``) or the
        data file itself (``subdir=False`` environments).
    """

    def __init__(self, path: str | Path):
        p = Path(path)
        if p.is_dir():
            p = p / "data.mdb"
        if not p.exists():
            raise FileNotFoundError(p)
        self._f = open(p, "rb")
        self._size = os.fstat(self._f.fileno()).st_size
        try:
            self._mm: memoryview | None = memoryview(
                __import__("mmap").mmap(self._f.fileno(), 0,
                                        prot=__import__("mmap").PROT_READ))
        except (ValueError, OSError):
            self._mm = None
        self.meta = self._read_meta()
        self.psize = self.meta.psize
        if self.psize < 512 or self.psize & (self.psize - 1):
            raise LMDBFormatError(f"implausible page size {self.psize}")

    # -- low level --------------------------------------------------------

    def _pread(self, off: int, n: int) -> bytes:
        if self._mm is not None:
            return bytes(self._mm[off:off + n])
        self._f.seek(off)
        return self._f.read(n)

    def _read_meta(self) -> _Meta:
        # page size is unknown before reading a meta; metas sit at file
        # offset 0 and psize.  Parse meta0 first, then re-read meta1 at its
        # actual offset — a fixed prefix would silently miss meta1 on
        # environments written with page size >= 16 KiB (64K-page hosts),
        # returning a one-transaction-stale root.
        m0 = _Meta(self._pread(0, 8192), PAGEHDRSZ)
        off1 = m0.psize + PAGEHDRSZ
        try:
            m1 = _Meta(self._pread(m0.psize, m0.psize), PAGEHDRSZ)
        except (LMDBFormatError, struct.error):
            return m0
        return m1 if m1.txnid > m0.txnid else m0

    def _page(self, pgno: int) -> bytes:
        return self._pread(pgno * self.psize, self.psize)

    @staticmethod
    def _page_flags(pg: bytes) -> int:
        return struct.unpack_from("<H", pg, 10)[0]

    @staticmethod
    def _num_keys(pg: bytes) -> int:
        lower = struct.unpack_from("<H", pg, 12)[0]
        return (lower - PAGEHDRSZ) >> 1

    @staticmethod
    def _node_off(pg: bytes, i: int) -> int:
        return struct.unpack_from("<H", pg, PAGEHDRSZ + 2 * i)[0]

    # -- node parsing -------------------------------------------------------

    def _leaf_node(self, pg: bytes, i: int) -> Tuple[bytes, int, int, bytes]:
        """-> (key, flags, datasize, inline data or 8-byte overflow pgno)."""
        off = self._node_off(pg, i)
        lo, hi, flags, ksize = struct.unpack_from("<HHHH", pg, off)
        dsize = lo | (hi << 16)
        key = pg[off + 8:off + 8 + ksize]
        data = pg[off + 8 + ksize:off + 8 + ksize +
                  (8 if flags & F_BIGDATA else dsize)]
        return key, flags, dsize, data

    def _branch_child(self, pg: bytes, i: int) -> int:
        off = self._node_off(pg, i)
        lo, hi, flags, _ksize = struct.unpack_from("<HHHH", pg, off)
        return lo | (hi << 16) | (flags << 32)

    def _overflow_value(self, opgno: int, dsize: int) -> bytes:
        start = opgno * self.psize + PAGEHDRSZ
        return self._pread(start, dsize)

    # -- public API ---------------------------------------------------------

    def __len__(self) -> int:
        return self.meta.main_db["entries"]

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """In-order (key, value) iteration over the main DB."""
        root = self.meta.main_db["root"]
        if root == 0xFFFFFFFFFFFFFFFF:  # P_INVALID: empty db
            return
        stack = [root]
        # depth-first, children pushed reversed for in-order traversal
        while stack:
            pg = self._page(stack.pop())
            flags = self._page_flags(pg)
            if flags & P_LEAF2:
                raise LMDBFormatError("LEAF2 pages unsupported")
            n = self._num_keys(pg)
            if flags & P_BRANCH:
                stack.extend(self._branch_child(pg, i)
                             for i in range(n - 1, -1, -1))
            elif flags & P_LEAF:
                for i in range(n):
                    key, nflags, dsize, data = self._leaf_node(pg, i)
                    if nflags & F_BIGDATA:
                        opgno = struct.unpack("<Q", data)[0]
                        yield key, self._overflow_value(opgno, dsize)
                    else:
                        yield key, data
            else:
                raise LMDBFormatError(f"unexpected page flags {flags:#x}")

    def get(self, key: bytes) -> bytes | None:
        """Point lookup by B+tree descent."""
        root = self.meta.main_db["root"]
        if root == 0xFFFFFFFFFFFFFFFF:
            return None
        pgno = root
        for _ in range(64):  # depth bound
            pg = self._page(pgno)
            flags = self._page_flags(pg)
            n = self._num_keys(pg)
            if flags & P_BRANCH:
                # find last child whose key <= target (node 0 key is empty)
                child = self._branch_child(pg, 0)
                for i in range(1, n):
                    off = self._node_off(pg, i)
                    ksize = struct.unpack_from("<H", pg, off + 6)[0]
                    k = pg[off + 8:off + 8 + ksize]
                    if k <= key:
                        child = self._branch_child(pg, i)
                    else:
                        break
                pgno = child
            elif flags & P_LEAF:
                for i in range(n):
                    k, nflags, dsize, data = self._leaf_node(pg, i)
                    if k == key:
                        if nflags & F_BIGDATA:
                            opgno = struct.unpack("<Q", data)[0]
                            return self._overflow_value(opgno, dsize)
                        return data
                return None
            else:
                raise LMDBFormatError(f"unexpected page flags {flags:#x}")
        raise LMDBFormatError("B+tree deeper than 64 levels")

    def close(self) -> None:
        if self._mm is not None:
            self._mm.release()
            self._mm = None
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# test-fixture writer
# ---------------------------------------------------------------------------

def write_minimal_lmdb(path: str | Path, items: dict[bytes, bytes],
                       psize: int = 4096) -> Path:
    """Write a minimal valid LMDB environment for round-trip tests.

    Produces the same on-disk structures ``mdb.c`` writes for a fresh env
    with one committed write txn: two meta pages, leaf page(s), and
    overflow pages for values that don't fit inline (> psize/4 heuristic,
    silently matching LMDB's node-size limit).  Only what the reader above
    needs — single leaf level (enough keys must fit one page) plus a branch
    root when they don't.
    """
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    keys = sorted(items)
    maxnode = (psize - PAGEHDRSZ) // 2  # conservative inline limit

    pages: list[bytes] = []          # pages from pgno 2 upward
    next_pg = 2

    def alloc(n=1):
        nonlocal next_pg
        pg = next_pg
        next_pg += n
        return pg

    # plan leaf contents: (key, flags, dsize, payload)
    nodes = []
    overflow: list[bytes] = []
    for k in keys:
        v = items[k]
        node_sz = 8 + len(k) + len(v)
        if node_sz > maxnode:
            npages = -(-(PAGEHDRSZ + len(v)) // psize)
            opg = alloc(npages)
            # overflow page header: pgno, pad, P_OVERFLOW, pb_pages
            hdr = struct.pack("<QHHI", opg, 0, P_OVERFLOW, npages)
            blob = hdr + v
            blob += b"\0" * (npages * psize - len(blob))
            overflow.append((opg, blob, npages))
            nodes.append((k, F_BIGDATA, len(v), struct.pack("<Q", opg)))
        else:
            nodes.append((k, 0, len(v), v))

    def build_leaf(pgno: int, leaf_nodes) -> bytes:
        buf = bytearray(psize)
        n = len(leaf_nodes)
        ptrs = []
        upper = psize
        for k, fl, dsz, payload in reversed(leaf_nodes):
            node = struct.pack("<HHHH", dsz & 0xFFFF, dsz >> 16, fl,
                               len(k)) + k + payload
            upper -= len(node)
            upper &= ~1  # even alignment
            buf[upper:upper + len(node)] = node
            ptrs.append(upper)
        ptrs.reverse()
        lower = PAGEHDRSZ + 2 * n
        if lower > upper:
            raise ValueError("leaf overflow — too many keys for one page")
        struct.pack_into("<QHHHH", buf, 0, pgno, 0, P_LEAF, lower, upper)
        for i, p in enumerate(ptrs):
            struct.pack_into("<H", buf, PAGEHDRSZ + 2 * i, p)
        return bytes(buf)

    # split nodes across leaves if needed
    leaves: list[list] = [[]]
    used = PAGEHDRSZ
    for nd in nodes:
        sz = 8 + len(nd[0]) + len(nd[3]) + 2 + 1  # node + ptr + align
        if used + sz > psize and leaves[-1]:
            leaves.append([])
            used = PAGEHDRSZ
        leaves[-1].append(nd)
        used += sz

    leaf_pgnos = [alloc() for _ in leaves]
    leaf_pages = [build_leaf(pg, nds) for pg, nds in zip(leaf_pgnos, leaves)]

    depth = 1
    root = leaf_pgnos[0] if leaves[0] else 0xFFFFFFFFFFFFFFFF
    branch_page = None
    if len(leaves) > 1:
        depth = 2
        root = alloc()
        buf = bytearray(psize)
        upper = psize
        ptrs = []
        entries = [(b"", leaf_pgnos[0])] + [
            (nds[0][0], pg) for nds, pg in zip(leaves[1:], leaf_pgnos[1:])]
        for k, child in reversed(entries):
            node = struct.pack("<HHHH", child & 0xFFFF,
                               (child >> 16) & 0xFFFF,
                               (child >> 32) & 0xFFFF, len(k)) + k
            upper -= len(node)
            upper &= ~1
            buf[upper:upper + len(node)] = node
            ptrs.append(upper)
        ptrs.reverse()
        lower = PAGEHDRSZ + 2 * len(entries)
        struct.pack_into("<QHHHH", buf, 0, root, 0, P_BRANCH, lower, upper)
        for i, p in enumerate(ptrs):
            struct.pack_into("<H", buf, PAGEHDRSZ + 2 * i, p)
        branch_page = bytes(buf)

    # assemble file: metas + pages in pgno order
    page_map = {}
    for pg, blob in zip(leaf_pgnos, leaf_pages):
        page_map[pg] = blob
    if branch_page is not None:
        page_map[root] = branch_page
    for opg, blob, npages in overflow:
        page_map[opg] = blob

    last_pg = next_pg - 1
    n_over = sum(np_ for _, _, np_ in overflow)

    def meta_page(pgno: int, txnid: int) -> bytes:
        buf = bytearray(psize)
        struct.pack_into("<QHHHH", buf, 0, pgno, 0, P_META, 0, 0)
        off = PAGEHDRSZ
        struct.pack_into("<IIQQ", buf, off, MDB_MAGIC, 1, 0,
                         max(len(page_map) + 2, 4) * psize)
        off += _META.size
        # free db (carries psize in pad)
        struct.pack_into("<IHH QQQQQ".replace(" ", ""), buf, off,
                         psize, 0, 0, 0, 0, 0, 0, 0xFFFFFFFFFFFFFFFF)
        off += _DB.size
        struct.pack_into("<IHH QQQQQ".replace(" ", ""), buf, off,
                         0, 0, depth, 1 if branch_page else 0,
                         len(leaf_pages), n_over, len(keys), root)
        off += _DB.size
        struct.pack_into("<QQ", buf, off, last_pg, txnid)
        return bytes(buf)

    out = io.BytesIO()
    out.write(meta_page(0, 0))
    out.write(meta_page(1, 1))
    for pg in range(2, next_pg):
        blob = page_map.get(pg)
        if blob is None:
            continue  # covered by a preceding multi-page overflow blob
        out.write(blob)
    (path / "data.mdb").write_bytes(out.getvalue())
    return path
