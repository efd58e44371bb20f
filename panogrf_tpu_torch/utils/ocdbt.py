"""A read-only OCDBT key-value store over a directory.

OCDBT is the b-tree format under orbax checkpoints (``use_ocdbt``).  A
directory holds ``manifest.ocdbt`` and data files under ``d/``; a
checkpoint's root manifest points at b-tree nodes whose values live in
``ocdbt.process_0/d/``.  The reader follows the latest version of the
manifest (the manifest always carries it inline; older versions, which
live in version-tree nodes, are not needed) down every interior node to
the leaves, and offers ``keys()`` and ``read(key)``.

Every manifest and node is ``magic (4 bytes, big-endian) | length (u64) |
format version (varint, 0) | compression (varint: 0 none, 1 zstd) | body
| CRC-32C of all before (u32)``; bodies are column-major tables of
varints (``_Cursor``).  Node keys are prefix-compressed: each node's keys
are relative to the prefix its parent entry names, and within a node each
key shares ``prefix_length`` bytes with the one before.  Values are
inline, or ``(data file, offset, length)`` in a data file whose path is a
base path plus a relative path from the node's data-file table.

The column order within format version 0 is tensorstore's
(``CHECKED_WITH`` names the release the tests hold the reader to); every
manifest and node must end where its last field does, so a layout that
differs raises rather than being read wrongly.  A format version,
manifest kind or compression this reader does not know, a bad checksum,
bytes past the last field or truncated data raise ``ValueError``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from panogrf_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_EMPTY_ROOT = (1 << 64) - 1         # a version's root offset for an empty tree
CHECKED_WITH = "tensorstore 0.1.80 (orbax-checkpoint 0.11.32)"


def _crc32c_table() -> list:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli), the checksum of OCDBT files."""
    c = 0xFFFFFFFF
    t = _CRC_TABLE
    for b in bytes(data):
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Cursor:
    """Reads varints and bytes from a body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def fail(self, msg: str) -> ValueError:
        return ValueError(f"ocdbt: {self.what}: {msg} at body byte "
                          f"{self.pos}")

    def varint(self) -> int:
        v = shift = 0
        while True:
            if self.pos >= len(self.data):
                raise self.fail("truncated varint")
            b = self.data[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7
            if shift > 63:
                raise self.fail("varint longer than 64 bits")

    def end(self) -> None:
        """Refuses bytes past the last field."""
        if self.pos != len(self.data):
            raise self.fail(f"{len(self.data) - self.pos} bytes past the "
                            "last field; this reader knows the layout "
                            f"{CHECKED_WITH} writes")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise self.fail(f"truncated ({n} bytes wanted)")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def keys(self, n: int) -> list:
        """``n`` prefix-compressed keys (lengths first, then the bytes)."""
        prefix = [0] + self.varints(n - 1) if n else []
        suffix = self.varints(n)
        return prefix, suffix

    def data_files(self) -> list:
        """A data-file table -> the files' paths (base + relative)."""
        n = self.varint()
        prefix = [0] + self.varints(n - 1) if n else []
        suffix = self.varints(n)
        base = self.varints(n)
        paths, prev = [], b""
        for p, s, b in zip(prefix, suffix, base):
            if p > len(prev):
                raise self.fail("data-file prefix longer than its path")
            path = prev[:p] + self.take(s)
            if b > len(path):
                raise self.fail("base path longer than its path")
            paths.append(path.decode())
            prev = path
        return paths


def _join_keys(cur: _Cursor, prefix: list, suffix: list) -> list:
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise cur.fail("key prefix longer than the previous key")
        prev = prev[:p] + cur.take(s)
        keys.append(prev)
    return keys


def _decode(blob: bytes, magic: int, what: str) -> bytes:
    """One manifest or node -> its body, checked and decompressed."""
    if len(blob) < 18:
        raise ValueError(f"ocdbt: {what}: truncated ({len(blob)} bytes)")
    got = int.from_bytes(blob[:4], "big")
    if got != magic:
        raise ValueError(f"ocdbt: {what}: magic {got:#010x}, expected "
                         f"{magic:#010x}")
    length = int.from_bytes(blob[4:12], "little")
    if length != len(blob):
        raise ValueError(f"ocdbt: {what}: header length {length} != "
                         f"{len(blob)} bytes read")
    crc = int.from_bytes(blob[-4:], "little")
    if crc32c(blob[:-4]) != crc:
        raise ValueError(f"ocdbt: {what}: CRC-32C mismatch")
    cur = _Cursor(blob[:-4], what)
    cur.pos = 12
    version, compression = cur.varint(), cur.varint()
    if version != 0:
        raise ValueError(f"ocdbt: {what}: format version {version} not "
                         "supported")
    body = blob[cur.pos:-4]
    if compression == 1:
        return bytes(zstd.decompress(body))
    if compression != 0:
        raise ValueError(f"ocdbt: {what}: compression {compression} not "
                         "supported")
    return bytes(body)


class OcdbtStore:
    """The latest version of the OCDBT database in directory ``root``:
    ``keys()`` in sorted order and ``read(key)``."""

    def __init__(self, root):
        self.root = Path(root)
        path = self.root / "manifest.ocdbt"
        if not path.is_file():
            raise ValueError(f"ocdbt: no manifest.ocdbt in {self.root}")
        cur = _Cursor(_decode(path.read_bytes(), MANIFEST_MAGIC,
                              str(path)), str(path))
        cur.take(16)                                    # uuid
        kind = cur.varint()
        if kind != 0:
            raise cur.fail(f"manifest kind {kind} (numbered manifests) "
                           "not supported")
        cur.varint()                                    # max inline bytes
        cur.varint()                                    # max node bytes
        cur.take(1)                                     # version arity
        method = cur.varint()
        if method == 1:
            cur.take(4)                                 # zstd level
        elif method != 0:
            raise cur.fail(f"compression method {method} not supported")
        files = cur.data_files()
        n = cur.varint()
        if n == 0:
            raise cur.fail("manifest holds no version")
        cur.varints(n)                                  # generations
        heights = list(cur.take(n))
        fid, off, ln = cur.varints(n), cur.varints(n), cur.varints(n)
        # the latest version is the last inline one; the rest describes it
        # and older versions: key, tree-byte and indirect-byte counts and
        # commit times of the inline versions, then the version-tree node
        # references (generation, data file, offset, length and number of
        # generations, commit time, height)
        cur.varints(3 * n)
        cur.take(8 * n)
        nodes = cur.varint()
        cur.varints(5 * nodes)
        cur.take(9 * nodes)
        cur.end()
        self._values, self._maps = {}, {}
        if off[-1] != _EMPTY_ROOT:
            self._walk(self._path(files, fid[-1], cur), off[-1], ln[-1],
                       heights[-1], b"")
        self._keys = sorted(self._values)

    def _path(self, files: list, fid: int, cur: _Cursor) -> Path:
        if fid >= len(files):
            raise cur.fail(f"data file {fid} of {len(files)}")
        return self.root / files[fid]

    def _walk(self, path: Path, offset: int, length: int, height: int,
              prefix: bytes) -> None:
        what = f"{path.name}@{offset}"
        with open(path, "rb") as f:
            f.seek(offset)
            blob = f.read(length)
        cur = _Cursor(_decode(blob, NODE_MAGIC, what), what)
        got = cur.take(1)[0]
        if got != height:
            raise cur.fail(f"node height {got}, its parent says {height}")
        files = cur.data_files()
        n = cur.varint()
        pl, sl = cur.keys(n)
        if height == 0:
            keys = _join_keys(cur, pl, sl)
            lengths = cur.varints(n)
            kinds = list(cur.take(n))
            indirect = [i for i, k in enumerate(kinds) if k == 1]
            if any(k > 1 for k in kinds):
                raise cur.fail(f"value kind {max(kinds)} not supported")
            fids = cur.varints(len(indirect))
            offs = cur.varints(len(indirect))
            where = dict(zip(indirect, zip(fids, offs)))
            for i, key in enumerate(keys):
                if i in where:
                    fid, off = where[i]
                    value = (self._path(files, fid, cur), off, lengths[i])
                else:
                    value = cur.take(lengths[i])
                self._values[(prefix + key).decode()] = value
            cur.end()
            return
        common = cur.varints(n)
        keys = _join_keys(cur, pl, sl)
        cols = [cur.varints(n) for _ in range(6)]
        cur.end()
        for i, key in enumerate(keys):
            if common[i] > len(key):
                raise cur.fail("subtree prefix longer than its key")
            fid, off, ln = cols[0][i], cols[1][i], cols[2][i]
            self._walk(self._path(files, fid, cur), off, ln, height - 1,
                       prefix + key[:common[i]])

    def keys(self) -> list:
        return list(self._keys)

    def __contains__(self, key: str) -> bool:
        return key in self._values

    def read(self, key: str) -> bytes:
        """The value of ``key``; a value in a data file is read through
        the file's ``np.memmap``, mapped once per store."""
        try:
            value = self._values[key]
        except KeyError:
            raise KeyError(f"ocdbt: no key {key!r} in {self.root}") from None
        if isinstance(value, bytes):
            return value
        path, off, ln = value
        if path not in self._maps:
            self._maps[path] = np.memmap(path, np.uint8, "r")
        data = self._maps[path]
        if off + ln > data.size:
            raise ValueError(f"ocdbt: {key!r}: {path.name} holds "
                             f"{data.size} bytes, the value ends at "
                             f"{off + ln}")
        return data[off:off + ln].tobytes()
