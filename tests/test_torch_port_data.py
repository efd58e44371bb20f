"""Port parity for the data pipeline: array shards, the LMDB reader and
import, the view splits, the cross-dataset readers, the augmentations,
the online generator, the ``prepare_data`` / ``import_lmdb`` tools and
``--shards`` in the training and render CLIs — each against the JAX
package on the same numpy inputs (CPU, float32).

Tolerances: shards written by either package read in the other bit for
bit, and the LMDB files, imports and view splits are equal; the readers'
resize, ``database_from_c2w``, ``zdepth_to_distance``, ``normalize_poses``,
the yaw roll's rotations, the photometric jitter and ``jitter_rotation``
within 1e-6 (the rolled images exactly); the online generator's samples
as ``test_torch_port_train.py`` holds the procedural scenes (rgb within
1e-5 and depth within 1e-4 but for at most 4 silhouette pixels a key,
rotations within 1e-7, translations within 1e-6); procedural samples
written to float16 shards by the two packages within one float16 step of
those limits, as a value within 1e-5 may round to either neighbour.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from panogrf_tpu.data import augment as jaug
from panogrf_tpu.data import database as jdb
from panogrf_tpu.data import imgs_info as jinfo
from panogrf_tpu.data import lmdb_import as jli
from panogrf_tpu.data import lmdb_reader as jlr
from panogrf_tpu.data import online as jonline
from panogrf_tpu.data import readers as jreaders
from panogrf_tpu.data import shards as jshards
from panogrf_tpu_torch.data import augment as taug
from panogrf_tpu_torch.data import database as tdb
from panogrf_tpu_torch.data import lmdb_import as tli
from panogrf_tpu_torch.data import lmdb_reader as tlr
from panogrf_tpu_torch.data import online as tonline
from panogrf_tpu_torch.data import readers as treaders
from panogrf_tpu_torch.data import shards as tshards
from panogrf_tpu_torch.tools import import_lmdb as timport
from panogrf_tpu_torch.tools import prepare_data as tprepare
from panogrf_tpu_torch.tools import render as trender
from panogrf_tpu_torch.tools import render_cubes as trender_cubes
from panogrf_tpu_torch.tools import train_renderer as ttrain
from torch_port_threads import one_torch_thread  # noqa: F401

H, W = 32, 64
SHARD_KEYS = jshards.ShardWriter.F16_KEYS + jshards.ShardWriter.F32_KEYS


def random_sample(rng, v=3, h=8, w=16, cubes=True) -> dict:
    """A sample of the shard schema with random values."""
    cw = h // 2
    s = {"rgb_panos": rng.uniform(size=(v, h, w, 3)),
         "depth_panos": rng.uniform(0.5, 9.0, size=(v, h, w, 1)),
         "rots": rng.normal(size=(v, 3, 3)),
         "trans": rng.normal(size=(v, 3))}
    if cubes:
        s.update(rgb_cubes=rng.uniform(size=(v, 6, cw, cw, 3)),
                 depth_cubes=rng.uniform(0.5, 9.0, size=(v, 6, cw, cw, 1)),
                 rots_cubes=rng.normal(size=(v, 6, 3, 3)),
                 trans_cubes=rng.normal(size=(v, 6, 3)))
    return {k: a.astype(np.float32) for k, a in s.items()}


def assert_samples_equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def assert_scene_close(got: dict, want: dict, slack: bool = False) -> None:
    """Procedural samples (numpy): poses to 1e-7 / 1e-6, images to 1e-5 /
    1e-4 but for at most 4 silhouette pixels a key; with ``slack`` (both
    stored as float16) one float16 step more."""
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    for k in got:
        tol = {"rots": 1e-7, "trans": 1e-6, "rots_cubes": 1e-7,
               "trans_cubes": 1e-6}.get(k)
        if tol is not None:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                       err_msg=k)
            continue
        tol = 1e-5 if k.startswith("rgb") else 1e-4
        if slack:
            tol = tol + np.spacing(np.abs(want[k]).astype(np.float16)) \
                .astype(np.float32)
        bad = (np.abs(got[k] - want[k]) > tol).any(-1)
        assert bad.sum() <= 4, (k, int(bad.sum()))


# ---------------------------------------------------------------------------
# 1. shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_shards_read_bit_for_bit_in_the_other_package(tmp_path, writer):
    """9 samples (all eight keys) at 2 a shard, written by one package,
    read by both across shard boundaries and after the cache drops its
    shards; ``host_indices`` and ``iter_epoch`` on the same generator."""
    rng = np.random.default_rng(0)
    samples = [random_sample(rng) for _ in range(9)]
    mod = {"jax": jshards, "port": tshards}[writer]
    with mod.ShardWriter(tmp_path, samples_per_shard=2) as w:
        for s in samples:
            w.add(s if writer == "jax" else tshards.sample_to_torch(s, "cpu"))
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert meta == {"num_samples": 9, "num_shards": 5,
                    "samples_per_shard": 2}
    jr, tr = jshards.ShardReader(tmp_path), tshards.ShardReader(tmp_path)
    assert len(tr) == len(jr) == 9
    for i in (0, 3, 5, 8, 1, 6, 2, 7, 4, 4, 0):
        got, want = tr[i], jr[i]
        assert_samples_equal(got, want)
        assert len(tr._cache) <= 3
        np.testing.assert_array_equal(
            want["rgb_panos"], samples[i]["rgb_panos"].astype(np.float16))
    # the reader hands out copies: writing into one leaves the shard as is
    tr[2]["rots"][:] = 0
    assert_samples_equal(tr[2], jr[2])
    for host in range(3):
        jh, th = (m.ShardReader(tmp_path, host_id=host, num_hosts=3)
                  for m in (jshards, tshards))
        np.testing.assert_array_equal(th.host_indices(), jh.host_indices())
        for shuffle in (True, False):
            got = list(th.iter_epoch(np.random.default_rng(5), shuffle))
            want = list(jh.iter_epoch(np.random.default_rng(5), shuffle))
            assert len(got) == len(want) == 3
            for a, b in zip(got, want):
                assert_samples_equal(a, b)


def test_reader_maps_members_and_decodes_compressed_shards(tmp_path):
    """The port reader maps each member of a shard where it lies in the
    file (``np.savez`` stores them uncompressed), so a sample read touches
    only that sample's bytes; a shard repacked with ``np.savez_compressed``
    is decoded whole instead.  Both read bit-equal to the JAX reader."""
    rng = np.random.default_rng(1)
    with jshards.ShardWriter(tmp_path / "plain", samples_per_shard=3) as w:
        for _ in range(3):
            w.add(random_sample(rng))
    (tmp_path / "packed").mkdir()
    with np.load(tmp_path / "plain" / "shard_00000.npz") as z:
        np.savez_compressed(tmp_path / "packed" / "shard_00000.npz",
                            **{k: z[k] for k in z.files})
    (tmp_path / "packed" / "meta.json").write_text(
        (tmp_path / "plain" / "meta.json").read_text())
    for name, mapped in (("plain", True), ("packed", False)):
        tr, jr = (m.ShardReader(tmp_path / name) for m in (tshards, jshards))
        for i in (2, 0, 1):
            assert_samples_equal(tr[i], jr[i])
        members = tr._cache[0]
        assert sorted(members) == sorted(SHARD_KEYS)
        assert all(isinstance(a, np.memmap) == mapped
                   for a in members.values()), name


def test_write_synthetic_dataset_matches_jax(tmp_path):
    """3 procedural samples at 16x32 rendered and written by each package
    (2 a shard): the same scenes and cameras."""
    jshards.write_synthetic_dataset(tmp_path / "j", 3, 16, 32, seed=2,
                                    samples_per_shard=2)
    tshards.write_synthetic_dataset(tmp_path / "t", 3, 16, 32, seed=2,
                                    samples_per_shard=2, device="cpu")
    jr, tr = (jshards.ShardReader(tmp_path / d) for d in ("j", "t"))
    for i in range(3):
        assert_scene_close(tr[i], jr[i], slack=True)


# ---------------------------------------------------------------------------
# 2. LMDB
# ---------------------------------------------------------------------------

def _lmdb_items(n=2, cubes=True, seed=1, v=3, h=8, w=16) -> tuple:
    """The reference writer's layout: ``"{idx},{field}"`` keys, raw float32
    buffers, the cube depth without a channel axis."""
    rng = np.random.default_rng(seed)
    samples = [random_sample(rng, v, h, w, cubes) for _ in range(n)]
    items = {}
    for i, s in enumerate(samples):
        for k, a in s.items():
            if k in ("depth_panos", "depth_cubes"):
                a = a[..., 0]
            items[f"{i},{k}".encode("ascii")] = a.tobytes()
    return items, samples


LMDB_CASES = {
    "inline": ({b"a": b"x" * 10, b"c": b"z"}, 4096),
    "overflow": ({b"a": b"x" * 10, b"b": b"y" * 9000, b"c": b"z"}, 4096),
    "branch": ({f"key{i:04d}".encode(): bytes([i % 256]) * (50 + i % 37)
                for i in range(300)}, 4096),
    "samples_8k_pages": (_lmdb_items()[0], 8192),
}


@pytest.mark.parametrize("case", sorted(LMDB_CASES))
def test_lmdb_files_equal_and_read_in_the_other_package(tmp_path, case):
    """``write_minimal_lmdb`` writes the same bytes in both packages, and
    each package's ``LMDBReader`` reads the env: every item and every
    point lookup equal."""
    items, psize = LMDB_CASES[case]
    jenv = jlr.write_minimal_lmdb(tmp_path / "j", items, psize)
    tenv = tlr.write_minimal_lmdb(tmp_path / "t", items, psize)
    assert (tenv / "data.mdb").read_bytes() == \
        (jenv / "data.mdb").read_bytes()
    for reader in (jlr.LMDBReader, tlr.LMDBReader):
        with reader(tenv) as db:
            assert len(db) == len(items)
            assert dict(db.items()) == items
            for k in list(items)[::7]:
                assert db.get(k) == items[k]
            assert db.get(b"missing") is None
    with tlr.LMDBReader(jenv / "data.mdb") as db:
        assert dict(db.items()) == items


@pytest.mark.parametrize("cubes", [False, True])
def test_import_lmdb_matches_jax(tmp_path, cubes):
    """An env named by the reference scheme, imported by each package (the
    port through its CLI), 2 samples a shard: the same count and shards,
    and each sample the float16 / float32 cast of what was written."""
    items, samples = _lmdb_items(n=3, cubes=cubes)
    env = tlr.write_minimal_lmdb(
        tmp_path / "lmdb_render_train_16x8_seq_len_3_m3d_dist_0.5", items)
    n_j = jli.import_lmdb(env, tmp_path / "j", samples_per_shard=2)
    n_t = timport.main(["--env", str(env), "--out", str(tmp_path / "t"),
                        "--samples-per-shard", "2"])
    assert n_j == n_t == 3
    jr, tr = (jshards.ShardReader(tmp_path / d) for d in ("j", "t"))
    for i in range(3):
        assert_samples_equal(tr[i], jr[i])
        for k, a in samples[i].items():
            dt = np.float16 if k in jshards.ShardWriter.F16_KEYS \
                else np.float32
            np.testing.assert_array_equal(tr[i][k], a.astype(dt), k)
    assert tli.import_lmdb(env, tmp_path / "t1", max_samples=1) == 1


def test_parse_env_name_zdepth_and_poses_match_jax():
    """``parse_env_name`` on names that follow the scheme and names that
    do not; ``zdepth_to_distance`` with and without a channel axis and
    ``normalize_poses`` for each reference view within 1e-6."""
    for name in ("lmdb_render_train_1024x512_seq_len_3_m3d_dist_0.5",
                 "/x/lmdb_render_test_512x256_seq_len_4_m3d_dist_1.",
                 "lmdb_render_val_64x32_seq_len_2_m3d_dist_0.25_extra",
                 "not_an_env", "lmdb_render_train_axb_seq_len_3"):
        assert tli.parse_env_name(name) == jli.parse_env_name(name), name
    rng = np.random.default_rng(3)
    d = rng.uniform(0.5, 9.0, size=(2, 16, 32, 1)).astype(np.float32)
    for x in (d, d[..., 0]):
        got, want = tli.zdepth_to_distance(x), jli.zdepth_to_distance(x)
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    q, _ = np.linalg.qr(rng.normal(size=(4, 3, 3)))
    t = rng.normal(size=(4, 3))
    for ref in range(4):
        for got, want in zip(tli.normalize_poses(q, t, ref),
                             jli.normalize_poses(q, t, ref)):
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# 3. the view splits
# ---------------------------------------------------------------------------

def test_database_splits_match_jax():
    """``get_database_split`` for every name the JAX package accepts and
    for names and split types it refuses (the same
    ``NotImplementedError``), and ``get_database_split_mv``."""
    rng = np.random.default_rng(4)
    s = random_sample(rng, v=4, cubes=False)
    args = (s["rgb_panos"], s["depth_panos"], s["rots"], s["trans"])
    for name in ("m3d", "m3d_test", "residential", "CoffeeArea",
                 "coffee_area_1", "replica", "replica_wide", "habitat",
                 "Residential", ""):
        for split in ("test", "test_all", "train", "val"):
            for test_ids in ((1,), (3, 2)):
                jd = jdb.PanoDatabase(name, *args, test_img_ids=test_ids)
                td = tdb.PanoDatabase(name, *args, test_img_ids=test_ids)
                try:
                    want = jdb.get_database_split(jd, split)
                except NotImplementedError as e:
                    with pytest.raises(NotImplementedError) as got:
                        tdb.get_database_split(td, split)
                    assert got.value.args == e.args
                else:
                    assert tdb.get_database_split(td, split) == want
    for ref, views in ((3, (3,)), (1, [2, 3]), (0, ())):
        assert tdb.get_database_split_mv(None, ref, views) == \
            jdb.get_database_split_mv(None, ref, views)


# ---------------------------------------------------------------------------
# 4. the cross-dataset readers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out_hw", [(16, 32), (12, 40), (24, 48), (64, 128),
                                    (20, 24)])
def test_resize_bilinear_matches_jax(out_hw):
    """Shrinking (antialiased), enlarging, the same size and mixed, from
    (2, 3, 24, 48, 3) float32, within 1e-6."""
    img = np.random.default_rng(5).uniform(
        size=(2, 3, 24, 48, 3)).astype(np.float32)
    got = treaders.resize_bilinear_np(img, out_hw)
    want = jreaders.resize_bilinear_np(img, out_hw)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _replica_scene(root, scene, rng, v=3, h=24, w=48):
    d = root / f"{scene}_0"
    d.mkdir(parents=True)
    s = random_sample(rng, v, h, w)
    s["depth_panos"] = s["depth_panos"][..., 0]    # stored without channel
    np.savez(d / "data.npz", **s)


def _assert_tree_close(got: dict, want: dict, tol=1e-6) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).shape == np.asarray(want[k]).shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)


def test_replica_wide_dataset_matches_jax(tmp_path):
    """Three scenes (one index missing) resized from 24x48 to 16x32 with
    their cube fields, and each scene's database, within 1e-6."""
    rng = np.random.default_rng(6)
    for s in (0, 2, 5):
        _replica_scene(tmp_path, s, rng)
    kw = dict(height=16, width=32, scenes=range(4), with_cubes=True)
    jd, td = (m.ReplicaWideDataset(tmp_path, **kw) for m in (jreaders,
                                                              treaders))
    assert len(td) == len(jd) == 2
    for i in range(2):
        _assert_tree_close(td[i], jd[i])
        a, b = td.database(i), jd.database(i)
        assert a.database_name == b.database_name == "replica"
        for k in ("images", "depths", "w2c", "c2w"):
            np.testing.assert_allclose(getattr(a, k), getattr(b, k),
                                       rtol=0, atol=1e-6, err_msg=k)


def _residential_archive(rng, v=9, h=16, w=32, cubes=True) -> dict:
    c2w = np.broadcast_to(np.eye(4), (v, 4, 4)).copy()
    c2w[:, :3, :3] = np.linalg.qr(rng.normal(size=(v, 3, 3)))[0]
    c2w[:, :3, 3] = rng.normal(size=(v, 3))
    data = {"rgbs": rng.uniform(size=(v, 3, h, w)),
            "c2w": c2w}
    if cubes:
        data["cube_rgbs"] = rng.uniform(size=(v, 6, 3, h // 2, h // 2))
        data["cube_c2w"] = np.broadcast_to(np.eye(4), (v, 6, 4, 4)).copy()
        data["cube_c2w"][:, :, :3, 3] = rng.normal(size=(v, 6, 3))
    return {k: a.astype(np.float32) for k, a in data.items()}


@pytest.mark.parametrize("archive", ["t7", "npz", "h5"])
def test_residential_and_coffee_area_match_jax(tmp_path, archive):
    """A Residential scene in the reference's ``all.t7``, an ``all.npz``
    or a SOMSI ``.h5`` (resized to 12x24), read by ``ResidentialDataset``
    and ``CoffeeAreaDataset`` (views [0, 4, 8], the cube poses' faces
    swapped), and their databases, within 1e-6."""
    rng = np.random.default_rng(7)
    d = tmp_path / "0_perspective_all"
    d.mkdir()
    data = _residential_archive(rng)
    if archive == "t7":
        torch.save({k: torch.from_numpy(v) for k, v in data.items()},
                   d / "all.t7")
    elif archive == "npz":
        np.savez(d / "all.npz", **data)
    else:
        import h5py
        with h5py.File(d / "scene.h5", "w") as f:
            f["color"] = (data["rgbs"].transpose(0, 2, 3, 1) * 255).astype(
                np.uint8)
            f["pose"] = data["c2w"]
    for jcls, tcls in ((jreaders.ResidentialDataset,
                        treaders.ResidentialDataset),
                       (jreaders.CoffeeAreaDataset,
                        treaders.CoffeeAreaDataset)):
        jd, td = jcls(tmp_path, 12, 24), tcls(tmp_path, 12, 24)
        assert len(td) == len(jd) == 1
        _assert_tree_close(td[0], jd[0])
        a, b = td.database(0), jd.database(0)
        assert a.database_name == b.database_name
        for k in ("images", "depths", "rots", "trans", "w2c", "c2w"):
            np.testing.assert_allclose(getattr(a, k), getattr(b, k),
                                       rtol=0, atol=1e-6, err_msg=k)
    if archive == "h5":
        for ref in (0, 4):
            _assert_tree_close(
                treaders.load_somsi_h5(d / "scene.h5", 20, 40, ref),
                jreaders.load_somsi_h5(d / "scene.h5", 20, 40, ref))
    else:
        path = d / f"all.{archive}"
        for views in (None, [1, 2]):
            _assert_tree_close(treaders.load_residential_scene(path, views),
                               jreaders.load_residential_scene(path, views))


def test_database_from_c2w_matches_jax():
    rng = np.random.default_rng(8)
    data = _residential_archive(rng, v=3, cubes=False)
    rgbs = data["rgbs"].transpose(0, 2, 3, 1)
    for name in ("residential", "CoffeeArea"):
        a = treaders.database_from_c2w(name, rgbs, data["c2w"], 0.3, 9.0)
        b = jreaders.database_from_c2w(name, rgbs, data["c2w"], 0.3, 9.0)
        assert (a.database_name, a.min_depth, a.max_depth) == \
            (b.database_name, b.min_depth, b.max_depth)
        for k in ("images", "depths", "rots", "trans", "w2c", "c2w",
                  "depth_range"):
            np.testing.assert_allclose(getattr(a, k), getattr(b, k),
                                       rtol=0, atol=1e-6, err_msg=k)
        assert tdb.get_database_split(a) == jdb.get_database_split(b)


# ---------------------------------------------------------------------------
# 5. the augmentations
# ---------------------------------------------------------------------------

def _aug_sample(seed=9) -> dict:
    s = random_sample(np.random.default_rng(seed), h=8, w=16, cubes=False)
    return s


@pytest.mark.parametrize("shift", [0, 5, -3, 16, 21])
def test_yaw_roll_matches_jax(shift):
    s = _aug_sample()
    want = jaug.yaw_roll({k: jnp.asarray(v) for k, v in s.items()}, shift)
    got = taug.yaw_roll(tshards.sample_to_torch(s, "cpu"), shift)
    for k in ("rgb_panos", "depth_panos", "trans"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_allclose(got["rots"].numpy(), np.asarray(want["rots"]),
                               rtol=0, atol=1e-6)


def test_photometric_jitter_matches_jax_on_its_draws():
    """JAX's jitter under three keys, its draws replayed from the same
    keys and fed to the port's arithmetic: within 1e-6."""
    s = _aug_sample()
    for seed in (0, 1, 2):
        key = jax.random.PRNGKey(seed)
        want = jaug.photometric_jitter(
            {k: jnp.asarray(v) for k, v in s.items()}, key)
        k1, k2, k3 = jax.random.split(key, 3)
        draws = (jax.random.uniform(k1, (), minval=0.8, maxval=1.2),
                 jax.random.uniform(k2, (), minval=0.8, maxval=1.2),
                 jax.random.uniform(k3, (3,), minval=0.9, maxval=1.1))
        got = taug.photometric_jitter(tshards.sample_to_torch(s, "cpu"),
                                      *(np.asarray(d) for d in draws))
        np.testing.assert_allclose(got["rgb_panos"].numpy(),
                                   np.asarray(want["rgb_panos"]), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(got["depth_panos"].numpy(),
                                      s["depth_panos"])


def test_augment_sample_draws_from_its_generator():
    """The port's draws: the shift in [0, max_shift), gamma and
    brightness in [0.8, 1.2), colour in [0.9, 1.1); the same generator
    seed gives the same sample, which is the yaw roll and the jitter at
    those draws."""
    s = tshards.sample_to_torch(_aug_sample(), "cpu")
    shifts = set()
    for seed in range(40):
        g = torch.Generator().manual_seed(seed)
        shift = int(torch.randint(0, 5, (), generator=g))
        gamma, bright, color = taug.jitter_draws(g)
        assert 0 <= shift < 5
        assert 0.8 <= gamma < 1.2 and 0.8 <= bright < 1.2
        assert color.shape == (3,) and bool(((color >= 0.9)
                                             & (color < 1.1)).all())
        shifts.add(shift)
        got = taug.augment_sample(s, torch.Generator().manual_seed(seed), 5)
        want = taug.photometric_jitter(taug.yaw_roll(s, shift), gamma,
                                       bright, color)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert shifts == set(range(5))
    # without max_shift the shift spans the width
    g = torch.Generator().manual_seed(0)
    assert max(int(torch.randint(0, W, (), generator=g)) for _ in range(200)
               ) > 16


def test_jitter_rotation_matches_jax():
    rng = np.random.default_rng(10)
    rots = list(np.linalg.qr(rng.normal(size=(4, 3, 3)))[0]) + [np.eye(3)]
    for r in rots:
        for angle in (30.0, 5.0):
            got = taug.jitter_rotation(r, np.random.default_rng(3), angle)
            want = jaug.jitter_rotation(r, np.random.default_rng(3), angle)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# 6. the online generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split,idx", [("train", 3), ("val", 1)])
def test_online_generator_matches_jax(split, idx):
    """A 16x32 sample with its 8x8 cube faces: the same scene, cameras and
    normalised poses as the JAX generator's."""
    kw = dict(split=split, height=16, width=32, with_cubes=True, seed=1)
    got = tonline.OnlineImageGenerator(**kw, device="cpu")[idx]
    want = jonline.OnlineImageGenerator(**kw)[idx]
    assert list(got) == list(want)
    assert all(v.dtype == np.float32 for v in got.values())
    assert_scene_close(got, {k: np.asarray(v) for k, v in want.items()})


def test_online_generator_eval_splits_and_write_shards(tmp_path):
    """The val / test splits hold ``val_sample_num`` cached samples (the
    same object again, IndexError past the end), the train split 2**31;
    ``write_shards`` stores the generator's samples, read back as their
    float16 / float32 casts."""
    gen = tonline.OnlineImageGenerator("val", 8, 16, val_sample_num=2,
                                       with_cubes=True, device="cpu")
    assert len(gen) == 2 and gen[1] is gen[1]
    assert len(list(gen)) == 2
    with pytest.raises(IndexError):
        gen[2]
    with pytest.raises(ValueError, match="unknown split"):
        tonline.OnlineImageGenerator("dev", device="cpu")
    train = tonline.OnlineImageGenerator("train", 8, 16, device="cpu")
    assert len(train) == 2 ** 31
    assert train[0] is not train[0]
    gen.write_shards(tmp_path, 3, samples_per_shard=2, start=1)
    reader = jshards.ShardReader(tmp_path)
    assert len(reader) == 3 and reader.num_shards == 2
    for i in range(3):
        want = gen._make(1 + i)
        got = reader[i]
        assert list(got) == [k for k in SHARD_KEYS if k in want]
        for k, a in want.items():
            dt = np.float16 if k in jshards.ShardWriter.F16_KEYS \
                else np.float32
            np.testing.assert_array_equal(got[k], a.astype(dt), k)


# ---------------------------------------------------------------------------
# 7. the tools and --shards in the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cubes", [False, True])
def test_prepare_data_cli_writes_shards_jax_reads(tmp_path, cubes,
                                                  monkeypatch):
    """The port's ``prepare_data`` (on the CPU) against the JAX package's
    writer of the same samples, read by the JAX ``ShardReader``; without
    ``--device cpu`` and with no CUDA device it raises."""
    argv = ["--num", "2", "--height", "16", "--width", "32", "--seed", "3"]
    if cubes:
        argv += ["--cubes", "--split", "test"]
        jonline.OnlineImageGenerator(
            "test", 16, 32, with_cubes=True, seed=3).write_shards(
            tmp_path / "j", 2)
    else:
        jshards.write_synthetic_dataset(tmp_path / "j", 2, 16, 32, seed=3)
    assert tprepare.main(argv + ["--out", str(tmp_path / "t"),
                                 "--device", "cpu"]) == 2
    jr, tr = (jshards.ShardReader(tmp_path / d) for d in ("j", "t"))
    assert len(tr) == len(jr) == 2
    for i in range(2):
        assert list(tr[i]) == list(jr[i])
        assert_scene_close(tr[i], jr[i], slack=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tprepare.main(argv + ["--out", str(tmp_path / "c")])


@pytest.fixture(scope="module")
def jax_shards(tmp_path_factory):
    """4 procedural 32x64 samples written by the JAX package, 2 a shard,
    and 2 cube samples (16x16 faces) written by its online generator."""
    root = tmp_path_factory.mktemp("jax_shards")
    jshards.write_synthetic_dataset(root / "plain", 4, H, W, seed=4,
                                    samples_per_shard=2)
    jonline.OnlineImageGenerator("val", H, W, with_cubes=True,
                                 seed=4).write_shards(root / "cubes", 2)
    return root


def test_train_renderer_cli_on_jax_shards(jax_shards, tmp_path,
                                          monkeypatch):
    """Two steps of the training CLI on JAX-written shards: the losses are
    finite, and the samples it reads follow the JAX CLI's order of draws
    on the config's seed (no pool scenes; a sample index, then the 512
    rays, each step)."""
    monkeypatch.chdir(tmp_path)
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text("\n".join([
        "name: gen_tiny", f"height: {H}", f"width: {W}",
        f"depth_height: {H}", f"depth_width: {W}", "depth_sample_num: 8",
        "fine_depth_sample_num: 8", "use_hierarchical_sampling: true",
        "loss: [render, depth]", "val_interval: 100000",
        "save_interval: 1000", "seed: 3"]) + "\n")
    read = []
    getitem = tshards.ShardReader.__getitem__

    def record(self, idx):
        read.append(idx)
        return getitem(self, idx)
    monkeypatch.setattr(tshards.ShardReader, "__getitem__", record)
    logged = []
    trainer = ttrain.main(["--cfg", str(cfg), "--steps", "2", "--shards",
                           str(jax_shards / "plain"), "--device", "cpu",
                           "--log-interval", "1"],
                          log_fn=lambda st, m: logged.append(m))
    assert trainer.step == 2 and len(logged) == 2
    assert all(np.isfinite(m["loss"]) for m in logged)
    rng = np.random.default_rng(3)
    want = []
    for _ in read:
        want.append(int(rng.integers(4)))
        jinfo.sample_train_coords(rng, H, W, 512)
    assert len(read) >= 2 and read == want


@pytest.mark.parametrize("cache_size", [1, 256])
def test_train_renderer_keeps_the_last_stack_depths(jax_shards, tmp_path,
                                                    monkeypatch, cache_size):
    """With ``--shards`` and the frozen stack as the depth source, the
    stack's depth is kept for the ``DEPTH_CACHE_SIZE`` samples met last:
    with 1, the stack runs for every draw but a repeat of the one before;
    with 256 (above the 4 samples), once a sample."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(ttrain, "DEPTH_CACHE_SIZE", cache_size)
    monkeypatch.setattr(ttrain, "load_depth_stack", lambda *a, **kw: "stack")
    ran, read = [], []

    def stack_depth(stack, s, ids, srcs):
        ran.append(read[-1])
        return {"mvs_depth": s["depth_panos"][list(ids)]}
    monkeypatch.setattr(ttrain, "stack_depth_for_sample", stack_depth)
    getitem = tshards.ShardReader.__getitem__

    def record(self, idx):
        read.append(idx)
        return getitem(self, idx)
    monkeypatch.setattr(tshards.ShardReader, "__getitem__", record)
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text("\n".join([
        "name: gen_tiny", f"height: {H}", f"width: {W}",
        f"depth_height: {H}", f"depth_width: {W}", "depth_sample_num: 8",
        "fine_depth_sample_num: 8", "loss: [render, depth]", "seed: 5"])
        + "\n")
    _, stream, _ = ttrain.build(ttrain.parse_args([
        "--cfg", str(cfg), "--shards", str(jax_shards / "plain"),
        "--depth-source", "stack", "--device", "cpu"]))
    for _ in range(10):
        next(stream)
    if cache_size == 1:
        want = [i for n, i in enumerate(read) if n == 0 or read[n - 1] != i]
    else:
        want = list(dict.fromkeys(read))
    assert ran == want and len(read) >= 10


def test_render_clis_on_jax_shards(jax_shards, tmp_path):
    """``render --shards`` renders the shard's first scene (of 4, with
    ``--num 1``) and ``render_cubes --shards`` scores the stored 16x16
    faces of both cube samples (``--num 3``), or on shards without faces
    the faces cut from the query panorama, at 32x64 on the CPU;
    ``render_cubes`` refuses a height that does not match the stored
    faces."""
    common = ["--height", str(H), "--width", str(W), "--depth-height",
              str(H), "--depth-width", str(W), "--device", "cpu"]
    summary = trender.main(common + ["--shards", str(jax_shards / "plain"),
                                     "--num", "1", "--out",
                                     str(tmp_path / "r")])
    assert len(summary["frames"]) == 1
    assert all(np.isfinite(v) for v in summary["mean"].values())
    assert (tmp_path / "r" / "0-nr_fine.png").exists() or \
        (tmp_path / "r" / "0-nr_fine.npy").exists()
    summary = trender_cubes.main(common + [
        "--shards", str(jax_shards / "cubes"), "--num", "3", "--out",
        str(tmp_path / "c")])
    assert len(summary["faces"]) == 12
    assert all(np.isfinite(v) for f in summary["faces"] for v in f.values())
    # shards without cube faces: the faces cut from the query panorama
    summary = trender_cubes.main(common + [
        "--shards", str(jax_shards / "plain"), "--num", "1", "--out",
        str(tmp_path / "p")])
    assert len(summary["faces"]) == 6
    with pytest.raises(SystemExit, match="--height 32"):
        trender_cubes.main(["--height", "64", "--width", "128",
                            "--depth-height", "32", "--depth-width", "64",
                            "--device", "cpu", "--shards",
                            str(jax_shards / "cubes"), "--out",
                            str(tmp_path / "x")])
