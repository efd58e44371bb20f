"""The port's reader of the JAX package's orbax checkpoints, on the CPU:
each layer against an independent implementation, then the JAX writers'
own layouts through the port's loaders.

* ``utils/zstd`` against ``zstandard``, byte for byte: levels -1, 1, 3
  and 19 on Gaussian float32, zeros, text, random bytes, a few bytes and
  nothing, with and without the content size and the checksum; frames
  concatenated around a skippable frame; truncated or corrupt input and
  the features it does not support raise.
* ``utils/ocdbt`` against ``tensorstore``'s ``ocdbt`` kvstore: the same
  keys and value bytes (interior nodes, values in data files, version
  tree nodes, an orbax checkpoint); a corrupt node raises.
* ``utils/orbax_read.read_tree`` against ``StandardCheckpointer().restore``
  on the committed fixtures (``tests/make_orbax_fixtures.py``, with their
  ``expected.json`` digests) and on a fresh trainer-shaped tree.
* The JAX writers: ``Trainer.save`` and the params-only layout through
  ``train/trainer.load_checkpoint_params``, the ft layout through
  ``render_ft``'s loader, and the depth trainers' ``{"params",
  "batch_stats"}`` trees of UniFuse, the MVS net and the variants through
  ``models/depth_stack.read_checkpoint``: ``torch.equal`` with the
  ``utils/from_jax`` converters of what JAX reads; the depth stack built
  from orbax directories gives the JAX stack's depth within the port's
  depth-stack tolerance (1e-4 of the scale).
* A UniFuse-sized tree (30.26 M float32 values) read in full.
"""

import hashlib
import json
import logging
import shutil
import time
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
import zstandard

from panogrf_tpu.data import imgs_info as jinfo
from panogrf_tpu.data import synthetic as jsyn
from panogrf_tpu.models import depth_stack as jds
from panogrf_tpu.models import fnet as jfnet
from panogrf_tpu.models import mvs as jmvs
from panogrf_tpu.models import uncert as juncert
from panogrf_tpu.models import unifuse as juni
from panogrf_tpu.train import depth_trainer as jdt
from panogrf_tpu.train import trainer as jtr
from panogrf_tpu_torch.models import depth_stack as tds
from panogrf_tpu_torch.models.unifuse import UniFuse as TUniFuse
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer
from panogrf_tpu_torch.tools import render_ft
from panogrf_tpu_torch.train import trainer as ttr
from panogrf_tpu_torch.utils import from_jax, ocdbt, orbax_read, zstd
from torch_port_parity import seeded_renderer_params, template_init
from torch_port_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "data" / "orbax"
MH, MW = 64, 128                 # UniFuse's smallest size
DH, DW = 32, 64                  # the MVS net's, as in the depth-stack tests
MVS_KW = {"num_hypotheses": 8, "magnet_num_samples": 3, "cnn3d_base": 8}
REL = 1e-4

# orbax warns on every restore without a target
logging.getLogger("absl").setLevel(logging.ERROR)


def _corpus() -> dict:
    """The inputs the decoder is held to: between them and the four
    levels, every block, literals and sequence-table kind
    (``test_zstd_corpus_covers_the_format`` checks it)."""
    rng = np.random.default_rng(0)
    words = b" ".join(b"panorama %d depth %d ray" % (i % 97, i % 13)
                      for i in range(12000))
    # a period broken every 100 bytes: one literal and one repeat offset
    # per sequence (RLE literal-length and offset tables)
    periodic = bytearray(b"abcdefgh" * 20000)
    periodic[::100] = rng.integers(0, 256, len(periodic[::100]),
                                   dtype=np.uint8).tobytes()
    # pieces of one random string joined by "Z": past the first block,
    # every literal is a "Z" (RLE literals)
    base = rng.integers(0, 256, 2000, dtype=np.uint8).tobytes()
    pieces = [base]
    while sum(map(len, pieces)) < 300000:
        a = int(rng.integers(0, 1900))
        pieces.append(b"Z" + base[a:a + int(rng.integers(20, 100))])
    return {
        "gauss": rng.standard_normal(160000).astype(np.float32).tobytes(),
        "zeros": bytes(300000),
        "text": words,
        "random": rng.integers(0, 256, 150000, dtype=np.uint8).tobytes(),
        "tiny": b"0123456789abc",
        "empty": b"",
        "short": words[:99],                 # one Huffman stream
        # few small byte values, skewed: Huffman weights stored directly
        "skewed": (rng.geometric(0.3, 3000) % 16).astype(np.uint8)
        .tobytes(),
        "periodic": bytes(periodic),
        "pieces": b"".join(pieces),
    }


CORPUS = _corpus()


def _compress(data: bytes, level: int, size: bool, checksum: bool) -> bytes:
    c = zstandard.ZstdCompressor(level=level, write_content_size=size,
                                 write_checksum=checksum)
    if size:
        return c.compress(data)
    obj = c.compressobj()                # a streamed frame: no size
    return obj.compress(data) + obj.flush()


# ---------------------------------------------------------------------------
# zstd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CORPUS))
@pytest.mark.parametrize("level", [-1, 1, 3, 19])
def test_zstd_matches_zstandard(level, name):
    data = CORPUS[name]
    for size, checksum in ((True, False), (False, True)):
        frame = _compress(data, level, size, checksum)
        assert bytes(zstd.decompress(frame)) == data, (size, checksum)


def test_zstd_corpus_covers_the_format(monkeypatch):
    """Across the corpus and the levels: raw, RLE and compressed blocks;
    raw, RLE, compressed and treeless literals in 1 and 4 streams; Huffman
    weights FSE-compressed and direct; each sequence table predefined,
    RLE, FSE-compressed and repeated."""
    seen = set()
    huffman, block, sequences = (zstd._read_huffman, zstd._Parser._block,
                                 zstd._Parser._sequences)

    def read_huffman(src, pos, end):
        seen.add("weights_fse" if src[pos] < 128 else "weights_direct")
        return huffman(src, pos, end)

    def parse_block(self, index, src, pos, end, *rest):
        kind = src[pos] & 3
        seen.add(("raw", "rle", "huffman", "treeless")[kind] + "_literals")
        if kind >= 2:
            seen.add("1_stream" if (src[pos] >> 2) & 3 == 0 else "4_streams")
        return block(self, index, src, pos, end, *rest)

    def parse_sequences(self, src, pos, end, *rest):
        b0 = src[pos]
        if b0:
            modes = src[pos + (1 if b0 < 128 else 2 if b0 < 255 else 3)]
            for name, shift in (("ll", 6), ("of", 4), ("ml", 2)):
                seen.add(f"{name}_" + ("predefined", "rle", "fse", "repeat")[
                    (modes >> shift) & 3])
        return sequences(self, src, pos, end, *rest)

    def frame(self, index, src, pos, end):
        out, p = frame_(self, index, src, pos, end)
        seen.update(f"{b[0]}_block" for b in out.blocks)
        return out, p
    frame_ = zstd._Parser._frame
    monkeypatch.setattr(zstd, "_read_huffman", read_huffman)
    monkeypatch.setattr(zstd._Parser, "_block", parse_block)
    monkeypatch.setattr(zstd._Parser, "_sequences", parse_sequences)
    monkeypatch.setattr(zstd._Parser, "_frame", frame)
    for level in (-1, 1, 3, 19):
        zstd.decompress_many([_compress(d, level, True, False)
                              for d in CORPUS.values()])
    want = {f"{k}_block" for k in ("raw", "rle", "cmp")} | {
        f"{k}_literals" for k in ("raw", "rle", "huffman", "treeless")} | {
        "1_stream", "4_streams", "weights_fse", "weights_direct"} | {
        f"{t}_{m}" for t in ("ll", "of", "ml")
        for m in ("predefined", "rle", "fse", "repeat")}
    assert want <= seen, sorted(want - seen)


def test_zstd_many_frames_and_skippable():
    """Frames concatenated around a skippable frame decode to the
    concatenation; ``decompress_many`` equals one call per buffer."""
    a, b = CORPUS["gauss"][:200000], CORPUS["text"]
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") \
        + b"skip!"
    joined = _compress(a, 3, True, True) + skip + _compress(b, 1, False,
                                                            False)
    assert bytes(zstd.decompress(joined)) == a + b
    bufs = [_compress(CORPUS[k], 1, False, False) for k in sorted(CORPUS)]
    outs = zstd.decompress_many(bufs)
    assert [bytes(o) for o in outs] == [CORPUS[k] for k in sorted(CORPUS)]


def test_zstd_rejects_corrupt_input():
    data = CORPUS["gauss"][:300000]
    frame = _compress(data, 3, False, True)
    with pytest.raises(ValueError, match="at byte"):
        zstd.decompress(frame[:len(frame) // 2])
    bad = bytearray(frame)
    bad[-1] ^= 0x40                                  # the checksum
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(bad))
    with pytest.raises(ValueError, match="not a zstd frame"):
        zstd.decompress(b"\x00" * 16)
    # the frame header's reserved bit, then a dictionary ID
    small = _compress(b"abc" * 100, 1, True, False)
    bad = bytearray(small)
    bad[4] |= 0x08
    with pytest.raises(ValueError, match="reserved bit"):
        zstd.decompress(bytes(bad))
    bad = bytearray(small)
    bad[4] |= 0x01                                   # a 1-byte ID
    bad[5:5] = b"\x07"
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(bytes(bad))
    # a flipped byte inside the compressed literals
    bad = bytearray(_compress(data, 1, False, False))
    bad[5000] ^= 0xFF
    with pytest.raises(ValueError):
        zstd.decompress(bytes(bad))


def test_xxh64_matches_zstandard_checksums():
    """XXH64's low 32 bits are what zstd stores after a frame."""
    for data in (b"", b"a", CORPUS["tiny"], CORPUS["text"][:1000],
                 CORPUS["text"][:33]):
        frame = _compress(data, 1, True, True)
        assert zstd.xxh64(data) & 0xFFFFFFFF == int.from_bytes(
            frame[-4:], "little")


# ---------------------------------------------------------------------------
# OCDBT
# ---------------------------------------------------------------------------

def _tensorstore_items(path: Path) -> dict:
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{path}/"}).result()
    reads = {k.decode(): kv.read(k) for k in kv.list().result()}
    return {k: r.result().value for k, r in reads.items()}


def _ocdbt_items(path: Path) -> dict:
    store = ocdbt.OcdbtStore(path)
    return {k: store.read(k) for k in store.keys()}


def test_crc32c():
    assert ocdbt.crc32c(b"123456789") == 0xE3069283
    assert ocdbt.crc32c(b"") == 0


def test_ocdbt_matches_tensorstore(tmp_path):
    """Small nodes (interior nodes, prefix-compressed keys), values
    beside and in data files, 20 commits (version-tree nodes), nodes
    without compression, and an orbax checkpoint: the same keys and bytes
    as tensorstore reads."""
    rng = np.random.default_rng(1)
    small = tmp_path / "small"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{small}/",
                          "config": {"max_inline_value_bytes": 16,
                                     "max_decoded_node_bytes": 300}}).result()
    with ts.Transaction() as txn:
        for i in range(80):
            kv.with_transaction(txn)[f"key{i:03d}/{'x' * (i % 5)}"] = bytes(
                rng.integers(0, 256, i % 40, dtype=np.uint8))
    many = tmp_path / "many"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{many}/",
                          "config": {"compression": {"id": "zstd",
                                                     "level": 5}}}).result()
    for i in range(20):
        kv[f"k{i:02d}"] = bytes([i]) * i
    plain = tmp_path / "plain"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{plain}/",
                          "config": {"compression": None}}).result()
    kv["a"], kv["b/c"] = b"1" * 50, bytes(range(256)) * 12
    for path in (small, many, plain, FIXTURES / "renderer",
                 FIXTURES / "renderer" / "ocdbt.process_0"):
        want = _tensorstore_items(path)
        assert _ocdbt_items(path) == want and want, path
    # a manifest with a byte past its last field (length and checksum
    # made good): a layout the reader does not know is refused
    odd = tmp_path / "odd"
    shutil.copytree(plain, odd)
    blob = (odd / "manifest.ocdbt").read_bytes()
    assert blob[12:14] == b"\x00\x00"          # version 0, not compressed
    blob = (blob[:4] + (len(blob) + 1).to_bytes(8, "little")
            + blob[12:-4] + b"\x00")
    (odd / "manifest.ocdbt").write_bytes(
        blob + ocdbt.crc32c(blob).to_bytes(4, "little"))
    with pytest.raises(ValueError, match="past the last field"):
        ocdbt.OcdbtStore(odd)
    # the root node's checksum
    root = tmp_path / "corrupt"
    shutil.copytree(FIXTURES / "arrays", root)
    (node,) = (root / "d").iterdir()
    blob = bytearray(node.read_bytes())
    blob[20] ^= 1
    node.write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="CRC-32C"):
        ocdbt.OcdbtStore(root)


# ---------------------------------------------------------------------------
# read_tree
# ---------------------------------------------------------------------------

def _leaves(tree) -> list:
    flat, treedef = jax.tree_util.tree_flatten(tree,
                                               is_leaf=lambda x: x is None)
    return flat, treedef


def assert_same_tree(got, want) -> None:
    """Same structure (dicts, lists, None), leaves equal in value and
    dtype (a bfloat16 leaf widened to float32)."""
    gl, gd = _leaves(got)
    wl, wd = _leaves(want)
    assert gd == wd
    for g, w in zip(gl, wl):
        if w is None or isinstance(w, (int, float)):
            assert g == w and type(g) is type(w)
            continue
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            w = w.astype(np.float32)
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["renderer", "arrays"])
def test_read_tree_matches_orbax_on_fixtures(name):
    path = FIXTURES / name
    tree = orbax_read.read_tree(path)
    assert_same_tree(tree, ocp.StandardCheckpointer().restore(path))
    rows = json.loads((FIXTURES / f"{name}.expected.json").read_text())
    for route, shape, dtype, sha in rows:
        node = tree
        for k in route.split("/"):
            node = node[int(k)] if isinstance(node, list) else node[k]
        a = np.array(node, order="C")
        assert (list(a.shape), a.dtype.str) == (shape, dtype), route
        assert hashlib.sha256(a.tobytes()).hexdigest() == sha, route
    assert sum(p.stat().st_size for p in FIXTURES.rglob("*")
               if p.is_file()) <= 1_000_000


def test_read_tree_matches_orbax_on_a_trainer_tree(tmp_path):
    """A trainer-shaped tree: nested dicts, an optimiser's tuple, 0-d
    arrays, Python scalars, None, bfloat16, bool, int64, float64 and an
    array in several chunks."""
    rng = np.random.default_rng(2)
    tree = {"state": {
        "params": {"conv": {"kernel": jnp.asarray(rng.normal(
                       size=(3, 3, 4, 8)).astype(np.float32))},
                   "bias": jnp.zeros((8,), jnp.float32)},
        "opt_state": (jnp.asarray(3, jnp.int32),
                      {"mu": jnp.asarray(rng.normal(size=(40, 50)),
                                         jnp.bfloat16),
                       "nu": jnp.asarray([1.0, -2.5, 3e-3], jnp.bfloat16)},
                      None),
        "step": jnp.asarray(7, jnp.int32)},
        "best_metric": jnp.asarray(1.5, jnp.float32),
        "count": 12, "lr": 2.5e-4,
        "mask": np.array([True, False, True]),
        "ids": np.arange(6, dtype=np.int64).reshape(2, 3),
        "big": rng.normal(size=(64, 70)),
    }
    ck = ocp.StandardCheckpointer()
    save_args = jax.tree.map(lambda _: ocp.SaveArgs(), tree)
    save_args["big"] = ocp.SaveArgs(chunk_byte_size=8192)
    ck.save(tmp_path / "ck", tree, save_args=save_args)
    ck.wait_until_finished()
    store = ocdbt.OcdbtStore(tmp_path / "ck")
    assert sum(k.startswith("big/") for k in store.keys()) > 2  # chunked
    got = orbax_read.read_tree(tmp_path / "ck")
    assert_same_tree(got, ck.restore(tmp_path / "ck"))
    nu = got["state"]["opt_state"][1]["nu"]
    assert nu.dtype == np.float32
    np.testing.assert_array_equal(nu, np.float32([1.0, -2.5, 0.0030059814]))


def test_read_tree_refuses_what_it_cannot_read(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no _METADATA"):
        orbax_read.read_tree(tmp_path / "empty")
    two = tmp_path / "two"
    shutil.copytree(FIXTURES / "arrays", two)
    (two / "ocdbt.process_1").mkdir()
    with pytest.raises(ValueError, match="ocdbt.process_"):
        orbax_read.read_tree(two)
    z3 = tmp_path / "z3"
    shutil.copytree(FIXTURES / "arrays", z3)
    meta = json.loads((z3 / "_METADATA").read_text())
    meta["use_zarr3"] = True
    (z3 / "_METADATA").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="use_zarr3"):
        orbax_read.read_tree(z3)
    meta["use_zarr3"] = False
    meta["format_version"] = 2
    (z3 / "_METADATA").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="'format_version' not known"):
        orbax_read.read_tree(z3)
    ok = {"zarr_format": 2, "shape": [4], "chunks": [4], "dtype": "<f4",
          "order": "C", "compressor": {"id": "zstd", "level": 1},
          "filters": None, "dimension_separator": ".", "fill_value": None}
    orbax_read._Leaf("w", ok)
    for field, value in (("compressor", {"id": "blosc"}), ("dtype", "<c8"),
                         ("zarr_format", 3), ("filters", [{"id": "x"}]),
                         ("codecs", [])):
        with pytest.raises(ValueError, match=f"'w'.*'{field}'"):
            orbax_read._Leaf("w", {**ok, field: value})


# ---------------------------------------------------------------------------
# the JAX writers' layouts through the port's loaders
# ---------------------------------------------------------------------------

RENDER_KW = dict(height=32, width=64, depth_hw=(32, 64))


@pytest.fixture(scope="module")
def renderer_variables():
    """Seeded renderer variables, each leaf's first 1009 values repeated
    (read fast; ``test_full_size_unifuse_tree`` times Gaussian data)."""
    return jax.tree.map(lambda a: np.resize(a.ravel()[:1009], a.shape),
                        seeded_renderer_params(3, **RENDER_KW))


def assert_same_state(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_trainer_layouts_load_as_in_jax(renderer_variables, tmp_path,
                                        monkeypatch):
    """``Trainer.save``'s full state and a params-only tree: the port's
    ``load_checkpoint_params`` equals the converter of what the JAX
    package's reads, and the render CLI's renderer takes it strictly;
    ``torch.load`` is never tried on a directory."""
    cfg = jtr.TrainerConfig(name="run", save_dir=str(tmp_path))
    tr = jtr.Trainer(lambda p, b, r: None, renderer_variables, cfg)
    tr.save("latest")
    params_only = tmp_path / "params_only"
    ck = ocp.StandardCheckpointer()
    ck.save(params_only, renderer_variables)
    ck.wait_until_finished()

    def no_torch_load(*a, **kw):
        raise AssertionError("torch.load on a directory")
    monkeypatch.setattr(torch, "load", no_torch_load)
    model = NeuralRayGenRenderer(**RENDER_KW, device="cpu")
    for path in (tmp_path / "run" / "latest", params_only):
        want = from_jax.renderer_state_dict(
            jax.tree.map(np.asarray, jtr.load_checkpoint_params(path)))
        got = ttr.load_checkpoint_params(path)
        assert_same_state(got, want)
        model.load_state_dict(got, strict=True)


def test_checkpoint_files_never_reach_the_reader(tmp_path, monkeypatch):
    """A ``.pth`` file goes to ``torch.load`` alone; a directory without
    ``_METADATA`` raises before any read."""
    sd = {"w": torch.arange(3.0)}
    torch.save({"network_state_dict": sd}, tmp_path / "model.pth")

    def no_reader(*a, **kw):
        raise AssertionError("the orbax reader on a file")
    monkeypatch.setattr(ttr, "read_tree", no_reader)
    monkeypatch.setattr(tds, "read_tree", no_reader)
    assert torch.equal(ttr.load_checkpoint_params(tmp_path / "model.pth")
                       ["w"], sd["w"])
    torch.save({"model": sd}, tmp_path / "mono.pth")
    assert torch.equal(tds.read_checkpoint(tmp_path / "mono.pth")["w"],
                       sd["w"])
    monkeypatch.undo()
    (tmp_path / "plain").mkdir()
    with pytest.raises(ValueError, match="not readable by the port"):
        tds.read_checkpoint(tmp_path / "plain")


def test_ft_layout_loads_through_render_ft(renderer_variables, tmp_path):
    """``tools/train_ft.py``'s ``ft_latest``: the gen renderer's modules
    but the init net, plus ``ray_feats`` (rfn, fh, fw, F)."""
    p = {k: v for k, v in renderer_variables["params"].items()
         if k != "init_net"}
    p["ray_feats"] = np.random.default_rng(4).normal(
        size=(2, 8, 16, 32)).astype(np.float32)
    ck = ocp.StandardCheckpointer()
    ck.save(tmp_path / "ft_latest", {"params": p})
    ck.wait_until_finished()
    restored = ck.restore(tmp_path / "ft_latest")
    want = from_jax.ft_renderer_state_dict(jax.tree.map(np.asarray,
                                                        restored))
    assert_same_state(ttr.load_checkpoint_params(tmp_path / "ft_latest"),
                      want)
    model = render_ft.load_ft(tmp_path / "ft_latest", 32, 64, device="cpu")
    assert_same_state({k: v for k, v in model.state_dict().items()
                       if k in want}, want)


def _random_variables(tree, seed: int) -> dict:
    """Numpy leaves on a shape-only variables tree: kernels N(0, 1/fan_in),
    vectors N(0, 0.05), BatchNorm variances U(0.5, 1.5), each leaf a
    block of 1009 draws repeated (the full-size nets' leaves then read
    in a fraction of the time Gaussian data takes:
    ``test_full_size_unifuse_tree`` times that)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        n = min(int(np.prod(x.shape)), 1009)
        if name.endswith("['var']"):
            block = rng.uniform(0.5, 1.5, n)
        elif len(x.shape) <= 1:
            block = 0.05 * rng.normal(size=n)
        else:
            block = rng.normal(size=n) / np.sqrt(np.prod(x.shape[:-1]))
        return np.resize(block.astype(np.float32), x.shape)
    return jax.tree_util.tree_map_with_path(leaf, dict(tree))


def _mvs_inputs():
    rng = np.random.default_rng(5)
    return (jnp.asarray(rng.uniform(size=(1, 2, DH, DW, 3)), jnp.float32),
            jnp.broadcast_to(jnp.eye(3), (1, 2, 3, 3)),
            jnp.zeros((1, 2, 3)), jnp.ones((1, MH, MW, 1)),
            jnp.zeros((1, MH // 2, MW // 2, 32)))


def _depth_cases():
    equi = jnp.zeros((1, MH, MW, 3))
    cube = jnp.zeros((1, 6, MH // 2, MH // 2, 3))
    return {
        "UniFuse": (juni.UniFuse, (equi, cube), from_jax.unifuse_state_dict),
        "ERP+TP": (lambda: juni.ERPTPDepth(patch_size=16), (equi,),
                   from_jax.unifuse_state_dict),
        "Equi": (juni.EquiDepth, (equi,), from_jax.equi_depth_state_dict),
        "Cube": (juni.CubeDepth, (equi, cube),
                 from_jax.cube_depth_state_dict),
        "MVS": (lambda: jmvs.MVSDepthModel(**MVS_KW), _mvs_inputs(),
                from_jax.mvs_state_dict),
        "FNET": (lambda: jfnet.FNetDepthModel(num_depths=8),
                 (jnp.zeros((1, 2, DH, DW, 3)),
                  jnp.broadcast_to(jnp.eye(3), (1, 2, 3, 3)),
                  jnp.zeros((1, 2, 3))), from_jax.fnet_state_dict),
        "uncert_head": (juncert.DepthUncertHead,
                        (jnp.zeros((1, 8, 16, 8)), jnp.ones((1, DH, DW, 1))),
                        from_jax.uncert_head_state_dict),
    }


def _depth_trainer_checkpoint(variables, root: Path, name: str) -> Path:
    """The JAX depth trainer's own ``save`` of ``variables``."""
    cfg = jdt.DepthTrainConfig(name=name, save_dir=str(root))
    trainer = jdt.DepthTrainer(lambda v, b, t: ({}, {}), variables, cfg)
    trainer.save()
    return root / name / "checkpoint_0"


@pytest.fixture(scope="module")
def depth_dirs(tmp_path_factory):
    """Each depth net's seeded variables and its orbax directory."""
    root = tmp_path_factory.mktemp("depth")
    out = {}
    for i, (name, (make, args, convert)) in enumerate(
            sorted(_depth_cases().items())):
        variables = _random_variables(
            template_init(make(), jax.random.PRNGKey(0), *args), 20 + i)
        out[name] = (variables, convert,
                     _depth_trainer_checkpoint(variables, root,
                                               name.replace("+", "_")))
    return out


@pytest.mark.parametrize("name", sorted(_depth_cases()))
def test_depth_trainer_layouts_read_exactly(depth_dirs, name):
    """``read_checkpoint`` tells the net from the tree and gives exactly
    the converter's state dict of the variables written."""
    variables, convert, path = depth_dirs[name]
    want = convert(variables)
    assert_same_state(tds.read_checkpoint(path), want)


def test_unknown_depth_tree_raises(tmp_path):
    ck = ocp.StandardCheckpointer()
    ck.save(tmp_path / "other", {"params": {"dense": {"kernel": np.ones(
        (2, 2), np.float32)}}})
    ck.wait_until_finished()
    with pytest.raises(ValueError, match="params keys \\['dense'\\]"):
        tds.read_checkpoint(tmp_path / "other")


def test_depth_stack_from_orbax_matches_jax(depth_dirs, monkeypatch):
    """``load_depth_stack(mono_dir, mvs_dir)`` against the JAX package's
    on the same directories: the references' depth of a 3-view scene."""
    mono_dir, mvs_dir = depth_dirs["UniFuse"][2], depth_dirs["MVS"][2]
    for cls in (juni.UniFuse, jmvs.MVSDepthModel):
        monkeypatch.setattr(cls, "init", template_init)
    jstack = jds.load_depth_stack(str(mono_dir), str(mvs_dir), (MH, MW),
                                  (DH, DW), mvs_kwargs=MVS_KW)
    monkeypatch.undo()
    tstack = tds.load_depth_stack(str(mono_dir), str(mvs_dir), (MH, MW),
                                  (DH, DW), mvs_kwargs=MVS_KW, device="cpu")
    js = jsyn.make_three_view_sample(jsyn.SphereScene.random(21), DH, DW,
                                     m3d_dist=0.3, seed=3)
    ts_ = {k: torch.tensor(np.asarray(v)) for k, v in js.items()}
    want = jax.tree.map(np.asarray, jds.stack_depth_for_sample(
        jstack.jitted(), js, jinfo.REF_IDS, jinfo.SRC_IDS))
    got = tds.stack_depth_for_sample(tstack, ts_, jinfo.REF_IDS,
                                     jinfo.SRC_IDS)
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].numpy(), want[k]
        assert g.shape == w.shape, k
        scale = max(float(np.abs(w).max()), 1e-6)
        assert float(np.abs(g - w).max()) <= REL * scale, k


def test_full_size_unifuse_tree(tmp_path):
    """A tree of UniFuse's shapes (30.26 M float32 values, 121 MB) of
    Gaussian values, written by orbax and read in full within 20 s of
    this process's CPU time (at least 6 MB/s on one thread; the CPU time,
    not the wall clock, so that other test workers do not count)."""
    shapes = {k: tuple(v.shape) for k, v in TUniFuse().state_dict().items()
              if v.dtype == torch.float32}
    n = sum(int(np.prod(s)) for s in shapes.values())
    assert 30.2e6 < n < 30.3e6
    rng = np.random.default_rng(6)
    tree = {"params": {k.replace(".", "_"): rng.standard_normal(
        s, dtype=np.float32) for k, s in shapes.items()}}
    ck = ocp.StandardCheckpointer()
    ck.save(tmp_path / "unifuse", tree)
    ck.wait_until_finished()
    t0, c0 = time.perf_counter(), time.process_time()
    got = orbax_read.read_tree(tmp_path / "unifuse")
    seconds, cpu = time.perf_counter() - t0, time.process_time() - c0
    print(f"read {n} float32 values ({4 * n / 1e6:.1f} MB) in "
          f"{seconds:.2f} s ({cpu:.2f} s CPU): "
          f"{4 * n / 1e6 / seconds:.1f} MB/s")
    assert cpu <= 20.0
    assert got["params"].keys() == tree["params"].keys()
    for k, v in tree["params"].items():
        np.testing.assert_array_equal(got["params"][k], v, err_msg=k)
