"""Read an orbax checkpoint directory into a nested dict of numpy arrays,
without JAX, orbax, tensorstore or a zstd module.

The JAX package writes its checkpoints with ``ocp.StandardCheckpointer``
(``use_ocdbt``, zarr v2): ``_METADATA`` (JSON) names every leaf by its
key path; each leaf is a zarr array whose ``<dotted.path>/.zarray`` and
``<dotted.path>/<chunk index>`` values live in the directory's OCDBT
database (``utils/ocdbt``), every chunk a zstd frame (``utils/zstd``).

``read_tree(path)`` rebuilds the tree as ``StandardCheckpointer().restore``
does without a target: dict keys, sequences as lists (``opt_state``
tuples), ``scalar`` leaves as Python numbers, other leaves as numpy arrays
(``bfloat16`` widened to float32, exactly), ``None`` and empty containers
as themselves.  All the chunks of one call are decoded together through
``zstd.decompress_many``, read from the data files through ``np.memmap``.
Anything else (zarr v3, another compressor or filter, a layout without
OCDBT, several ``ocdbt.process_*`` directories, a ``_METADATA`` or
``.zarray`` field this reader does not know) raises ``ValueError`` naming
the array and the field.  The layout is the one ``ocdbt.CHECKED_WITH``
writes.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from panogrf_tpu_torch.utils import zstd
from panogrf_tpu_torch.utils.ocdbt import CHECKED_WITH, OcdbtStore

_DTYPES = {"<f2": np.float16, "<f4": np.float32, "<f8": np.float64,
           "|i1": np.int8, "<i2": np.int16, "<i4": np.int32, "<i8": np.int64,
           "|u1": np.uint8, "<u2": np.uint16, "<u4": np.uint32,
           "<u8": np.uint64, "|b1": np.bool_, "bfloat16": np.uint16}
_EMPTY = {"None": lambda: None, "Dict": dict, "List": list, "Tuple": tuple}
_DICT_KEY, _SEQUENCE_KEY = 2, 1
_METADATA_FIELDS = {"tree_metadata", "use_ocdbt", "use_zarr3",
                    "store_array_data_equal_to_fill_value", "custom_metadata"}
_ZARRAY_FIELDS = {"zarr_format", "shape", "chunks", "dtype", "order",
                  "compressor", "filters", "dimension_separator",
                  "fill_value"}


def _unknown(where: str, fields, known: set) -> None:
    extra = sorted(set(fields) - known)
    if extra:
        raise ValueError(f"orbax: {where}: field {extra[0]!r} not known "
                         f"(this reader knows the layout {CHECKED_WITH} "
                         "writes)")


def is_orbax_dir(path) -> bool:
    """Whether ``path`` is an orbax checkpoint directory."""
    p = Path(path)
    return p.is_dir() and (p / "_METADATA").is_file()


class _Leaf:
    """One zarr array: its ``.zarray`` fields and where its chunks are."""

    def __init__(self, name: str, meta: dict):
        self.name = name

        def field(key, ok):
            value = meta.get(key)
            if not ok(value):
                raise ValueError(f"orbax: array {name!r}: field {key!r} = "
                                 f"{value!r} not supported")
            return value

        _unknown(f"array {name!r}", meta, _ZARRAY_FIELDS)
        field("zarr_format", lambda v: v == 2)
        self.shape = tuple(field("shape", lambda v: isinstance(v, list)))
        self.chunks = tuple(field(
            "chunks", lambda v: isinstance(v, list)
            and len(v) == len(self.shape) and all(c > 0 for c in v)))
        dtype = field("dtype", lambda v: v in _DTYPES)
        self.bf16 = dtype == "bfloat16"
        self.dtype = np.dtype(_DTYPES[dtype])
        self.order = field("order", lambda v: v in ("C", "F"))
        comp = field("compressor",
                     lambda v: v is None or (isinstance(v, dict)
                                             and v.get("id") == "zstd"))
        self.compressed = comp is not None
        field("filters", lambda v: not v)
        field("dimension_separator", lambda v: v in (None, "."))
        self.fill = field("fill_value", lambda v: v is None or isinstance(
            v, (int, float, bool)))

    def chunk_keys(self) -> list:
        grid = [math.ceil(s / c) for s, c in zip(self.shape, self.chunks)]
        if not grid:
            return [((), f"{self.name}/0")]
        out = []
        for idx in np.ndindex(*grid):
            out.append((idx, f"{self.name}/"
                        + ".".join(str(i) for i in idx)))
        return out

    def assemble(self, chunks: dict) -> np.ndarray:
        """``chunks`` (index -> decoded bytes or None) -> the array; a
        bfloat16 array's bits become float32 (bf16 is float32's high half)."""
        out = self._bits(chunks)
        if self.bf16:
            return (out.astype(np.uint32) << 16).view(np.float32)
        return out

    def _bits(self, chunks: dict) -> np.ndarray:
        fill = 0 if self.fill is None else self.fill
        if self.bf16:
            fill = int(np.array(fill, np.float32).view(np.uint32) >> 16)
        csize = int(np.prod(self.chunks)) * self.dtype.itemsize
        if len(chunks) == 1 and self.chunks == self.shape:
            (data,) = chunks.values()
            if data is None:
                return np.full(self.shape, fill, self.dtype)
            return self._chunk(data, csize)
        out = np.full(self.shape, fill, self.dtype)
        for idx, data in chunks.items():
            if data is None:
                continue
            block = self._chunk(data, csize)
            lo = [i * c for i, c in zip(idx, self.chunks)]
            hi = [min(l + c, s) for l, c, s in zip(lo, self.chunks,
                                                   self.shape)]
            out[tuple(slice(l, h) for l, h in zip(lo, hi))] = block[
                tuple(slice(0, h - l) for l, h in zip(lo, hi))]
        return out

    def _chunk(self, data, nbytes: int) -> np.ndarray:
        if len(data) != nbytes:
            raise ValueError(f"orbax: array {self.name!r}: a chunk holds "
                             f"{len(data)} bytes, its shape {self.chunks} "
                             f"needs {nbytes}")
        return np.frombuffer(data, self.dtype).reshape(self.chunks,
                                                       order=self.order)


def _store(path: Path, meta: dict) -> OcdbtStore:
    if meta.get("use_zarr3"):
        raise ValueError(f"orbax: {path}: field 'use_zarr3' = true (zarr3 "
                         "arrays are not supported)")
    if meta.get("use_ocdbt") is False or not (path / "manifest.ocdbt"
                                              ).is_file():
        raise ValueError(f"orbax: {path}: field 'use_ocdbt' is not true "
                         "(only OCDBT checkpoints are supported)")
    procs = sorted(p.name for p in path.glob("ocdbt.process_*"))
    if len(procs) > 1:
        raise ValueError(f"orbax: {path}: {len(procs)} ocdbt.process_* "
                         f"directories ({', '.join(procs)}); a checkpoint "
                         "of one process is supported")
    return OcdbtStore(path)


def read_tree(path) -> dict:
    """The orbax checkpoint at directory ``path`` -> a nested dict."""
    path = Path(path)
    if not is_orbax_dir(path):
        raise ValueError(f"orbax: {path} is not an orbax checkpoint "
                         "directory (no _METADATA)")
    meta = json.loads((path / "_METADATA").read_text())
    _unknown(f"{path}/_METADATA", meta, _METADATA_FIELDS)
    entries = meta.get("tree_metadata")
    if not isinstance(entries, dict):
        raise ValueError(f"orbax: {path}/_METADATA: no 'tree_metadata'")
    store = _store(path, meta)
    leaves, fixed = [], []
    for text, entry in entries.items():
        keys = entry["key_metadata"]
        route = [(k["key"], k["key_type"]) for k in keys]
        for k, kt in route:
            if kt not in (_DICT_KEY, _SEQUENCE_KEY):
                raise ValueError(f"orbax: {text}: key_type {kt} of {k!r} "
                                 "not supported")
        vm = entry["value_metadata"]
        vtype = vm.get("value_type")
        if vm.get("skip_deserialize"):
            if vtype not in _EMPTY:
                raise ValueError(f"orbax: {text}: value_type {vtype!r} "
                                 "with skip_deserialize not supported")
            fixed.append((route, _EMPTY[vtype]()))
            continue
        if vtype not in ("jax.Array", "np.ndarray", "scalar"):
            raise ValueError(f"orbax: {text}: value_type {vtype!r} not "
                             "supported")
        name = ".".join(str(k) for k, _ in route)
        zkey = f"{name}/.zarray"
        if zkey not in store:
            raise ValueError(f"orbax: array {name!r}: no .zarray in "
                             f"{path}")
        leaves.append((route, vtype, _Leaf(name, json.loads(
            store.read(zkey)))))
    # every chunk of the call, decoded together
    wanted = []
    for _, _, leaf in leaves:
        for idx, key in leaf.chunk_keys():
            wanted.append((leaf, idx, store.read(key) if key in store
                           else None))
    packed = [d for leaf, _, d in wanted if d is not None and leaf.compressed]
    decoded = iter(zstd.decompress_many(packed))
    per_leaf = {}
    for leaf, idx, data in wanted:
        if data is not None:
            data = next(decoded) if leaf.compressed else data
        per_leaf.setdefault(id(leaf), {})[idx] = data
    tree: dict = {}
    for route, vtype, leaf in leaves:
        value = leaf.assemble(per_leaf[id(leaf)])
        if vtype == "scalar":
            value = value.item()
        _insert(tree, route, value)
    for route, value in fixed:
        _insert(tree, route, value)
    return _lists(tree)


def _insert(tree: dict, route: list, value) -> None:
    """Places ``value`` at ``route``; a sequence level is kept as a dict
    of int keys until ``_lists`` turns it into a list."""
    node = tree
    for i, (key, kt) in enumerate(route):
        k = int(key) if kt == _SEQUENCE_KEY else key
        if i + 1 == len(route):
            node[k] = value
        else:
            node = node.setdefault(k, {})


def _lists(node):
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        if sorted(out) != list(range(len(out))):
            raise ValueError(f"orbax: sequence indices {sorted(out)} are "
                             "not 0..n-1")
        return [out[i] for i in range(len(out))]
    return out

