"""Import the reference's pre-rendered LMDB data into the shard format.

Port of ``panogrf_tpu/data/lmdb_import.py`` (numpy only).

The reference renders habitat-sim samples once and serializes them into an
LMDB environment (``lmdb_rw_render/lmdb_write_render.py:193-248``): per
sample index ``idx`` the keys are ``"{idx},{field}"`` (ASCII) with raw
float32 numpy buffers for fields rgb_panos / depth_panos / rots / trans
(+ ``*_cubes`` variants).  Readers reconstruct the arrays by reshape
(``data_readers/habitat_data_neuray_lmdb.py:152-164``).

Samples inside the LMDB are ALREADY pose-normalized (reference view = world
origin, ``create_rgb_dataset.py:370-399``) and hold radial distance (not
z-depth; ``zdepth_to_distance`` applied at ``create_rgb_dataset.py:565``).
For raw sources that are not, :func:`normalize_poses` and
:func:`zdepth_to_distance` reproduce both transforms.

Environment directory names encode the geometry
(``lmdb_write_render.py:175-177``):
``lmdb_render_{mode}_{width}x{height}_seq_len_{V}_m3d_dist_{d}``.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Iterator

import numpy as np

from panogrf_tpu_torch.data.lmdb_reader import LMDBReader
from panogrf_tpu_torch.data.shards import ShardWriter

_ENV_RE = re.compile(
    r"lmdb_render_(?P<mode>[a-z]+)_(?P<width>\d+)x(?P<height>\d+)"
    r"_seq_len_(?P<seq_len>\d+)_m3d_dist_(?P<m3d_dist>[\d.]+)")


def parse_env_name(path: str | Path) -> dict | None:
    """Recover (mode, width, height, seq_len, m3d_dist) from the env dir
    name; None if it doesn't follow the reference naming scheme."""
    m = _ENV_RE.search(Path(path).name)
    if not m:
        return None
    d = m.groupdict()
    return {"mode": d["mode"], "width": int(d["width"]),
            "height": int(d["height"]), "seq_len": int(d["seq_len"]),
            "m3d_dist": float(d["m3d_dist"].rstrip("."))}


def zdepth_to_distance(depth: np.ndarray) -> np.ndarray:
    """Convert stitched ERP z-depth to radial distance.

    Exact reproduction of reference ``create_rgb_dataset.py:565-614``:
    the per-pixel ratio is ``diag_dist / focal_len`` on the cube face the
    pixel stitches from (``cache_depth_to_dist``).  With 90° HFOV faces of
    width cw = H/2 that reduces to ``sqrt(1 + (1/m^2 - 1) * k^2)`` where
    ``m`` is the max |component| of the unit pixel direction (the cosine
    to the dominant face axis) and ``k = (cw - 1) / cw`` — the reference's
    align-corners pixel-grid factor (``uv_int`` uses (cw-1), the focal
    length cw/2; ``my_helpers.py:484-532`` projects with focal 1 so
    u^2 + v^2 = 1/m^2 - 1).  Operates on (..., H, W) or (..., H, W, 1).
    """
    squeeze = depth.shape[-1] == 1
    d = depth[..., 0] if squeeze else depth
    h, w = d.shape[-2:]
    # reference grid: theta in [0, 2pi), phi in [0, pi] with half-pixel
    # centers (``create_rgb_dataset.py:592-594``)
    theta = (np.arange(w) + 0.5) * (2 * np.pi / w)
    phi = (np.arange(h) + 0.5) * (np.pi / h)
    tt, pp = np.meshgrid(theta, phi)
    x = np.sin(pp) * np.sin(tt)
    y = np.cos(pp)
    z = np.sin(pp) * np.cos(tt)
    m = np.maximum(np.max(np.abs(np.stack([x, y, z], -1)), axis=-1), 1e-6)
    cw = h // 2
    k = (cw - 1.0) / cw
    ratio = np.sqrt(1.0 + (1.0 / m ** 2 - 1.0) * k * k).astype(d.dtype)
    out = d * ratio
    return out[..., None] if squeeze else out


def normalize_poses(rots: np.ndarray, trans: np.ndarray,
                    reference_idx: int = 0) -> tuple:
    """Renormalize camera-to-world rotations/positions so the reference
    view sits at the world origin with identity rotation, emitting the
    reference's (w2c-style) rots/trans sample fields.

    Reproduces ``create_rgb_dataset.py:393-399``:
      trans[i] = -R_ref^-1 (t_i - t_ref);  rots[i] = R_ref · R_i^-1
    with trans[ref] = 0, rots[ref] = I.

    :param rots: (V, 3, 3) per-view rotation matrices (habitat world
        orientation); :param trans: (V, 3) world positions.
    """
    rots = np.asarray(rots, np.float64)
    trans = np.asarray(trans, np.float64)
    r_ref = rots[reference_idx]
    t_ref = trans[reference_idx]
    out_r = np.einsum("ij,vkj->vik", r_ref, rots)     # R_ref @ R_i^T
    out_t = -np.einsum("ji,vj->vi", r_ref, trans - t_ref)
    out_r[reference_idx] = np.eye(3)
    out_t[reference_idx] = 0.0
    return out_r.astype(np.float32), out_t.astype(np.float32)


def iter_lmdb_samples(env_path: str | Path, height: int, width: int,
                      seq_len: int) -> Iterator[dict]:
    """Decode consecutive samples 0..N-1 from a reference LMDB env.

    Yields the shard-schema dict: rgb_panos (V, H, W, 3), depth_panos
    (V, H, W, 1), rots (V, 3, 3), trans (V, 3) and — when the env was
    written with cube fields (``lmdb_write_render.py:225-231``) —
    rgb_cubes (V, 6, cw, cw, 3), depth_cubes (V, 6, cw, cw, 1),
    rots_cubes (V, 6, 3, 3), trans_cubes (V, 6, 3) with cw = H/2
    (reader reshapes per ``habitat_data_neuray_ft_lmdb.py:123-126``;
    depth gets an explicit channel axis like depth_panos).
    """
    cw = height // 2
    cube_shapes = {
        "rgb_cubes": (seq_len, 6, cw, cw, 3),
        "depth_cubes": (seq_len, 6, cw, cw, 1),
        "rots_cubes": (seq_len, 6, 3, 3),
        "trans_cubes": (seq_len, 6, 3),
    }
    with LMDBReader(env_path) as db:
        idx = 0
        while True:
            buf = db.get(f"{idx},rgb_panos".encode("ascii"))
            if buf is None:
                return
            rgb = np.frombuffer(buf, np.float32).reshape(
                seq_len, height, width, 3)
            depth = np.frombuffer(
                db.get(f"{idx},depth_panos".encode("ascii")),
                np.float32).reshape(seq_len, height, width, 1)
            rots = np.frombuffer(
                db.get(f"{idx},rots".encode("ascii")),
                np.float32).reshape(seq_len, 3, 3)
            trans = np.frombuffer(
                db.get(f"{idx},trans".encode("ascii")),
                np.float32).reshape(seq_len, 3)
            sample = {"rgb_panos": rgb, "depth_panos": depth,
                      "rots": rots, "trans": trans}
            for key, shape in cube_shapes.items():
                cbuf = db.get(f"{idx},{key}".encode("ascii"))
                if cbuf is not None:
                    sample[key] = np.frombuffer(
                        cbuf, np.float32).reshape(shape)
            yield sample
            idx += 1


def import_lmdb(env_path: str | Path, out_dir: str | Path,
                height: int | None = None, width: int | None = None,
                seq_len: int | None = None, max_samples: int | None = None,
                samples_per_shard: int = 64) -> int:
    """Convert a reference LMDB env into a shard directory.

    Geometry is parsed from the env dir name when not given explicitly.
    :return: number of samples imported.
    """
    info = parse_env_name(env_path) or {}
    height = height or info.get("height")
    width = width or info.get("width")
    seq_len = seq_len or info.get("seq_len")
    if not (height and width and seq_len):
        raise ValueError(
            f"cannot infer geometry from {env_path!r}; pass height/width/"
            "seq_len explicitly")
    n = 0
    with ShardWriter(out_dir, samples_per_shard) as w:
        for sample in iter_lmdb_samples(env_path, height, width, seq_len):
            w.add(sample)
            n += 1
            if max_samples is not None and n >= max_samples:
                break
    return n
