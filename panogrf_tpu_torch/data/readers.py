"""Cross-dataset readers: Replica (wide-baseline), Residential, CoffeeArea.

Port of ``panogrf_tpu/data/readers.py``, the loaders of the reference's
evaluation datasets:

* Replica (reference ``data_readers/replica_wide.py:1-60``): per-scene
  ``data.npz`` with the habitat sample schema (rgb_panos / depth_panos /
  rots / trans [+ ``*_cubes``]), resized to the working resolution.
* Residential (reference ``data_readers/residential.py:1-48``): per-scene
  ``all.t7`` torch archive with ``rgbs`` (V, 3, H, W), ``c2w`` (V, 4, 4),
  ``cube_rgbs``, ``cube_c2w``; views [0, 8] are references, [4] is the
  query; the cube poses' faces 0<->5 and 2<->4 are swapped to line up with
  the face images (``residential.py:33-41``).  The upstream source is
  SOMSI's ``{scene}.h5`` (datasets ``color`` u8 and ``pose``), loadable
  directly with :func:`load_somsi_h5`.
* CoffeeArea: the same archive schema as Residential.

Residential and CoffeeArea carry no depth: their databases hold zero
depth maps, which nothing reads as supervision.  Numpy in, numpy out;
``h5py`` is imported only by :func:`load_somsi_h5`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from panogrf_tpu_torch.data.database import PanoDatabase

RESIDENTIAL_TRAIN_VIEWS = (0, 8)
RESIDENTIAL_VAL_VIEWS = (4,)


def resize_bilinear(img: torch.Tensor, hw: tuple) -> torch.Tensor:
    """Half-pixel bilinear resize of (..., H, W, C) to (..., h, w, C),
    antialiased when it shrinks (a triangle filter widened by the scale),
    as the JAX package's ``jax.image.resize(method="bilinear")`` is."""
    h, w = hw
    lead, (ih, iw, c) = img.shape[:-3], img.shape[-3:]
    x = img.reshape(-1, ih, iw, c).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                      antialias=True)
    return y.permute(0, 2, 3, 1).reshape(*lead, h, w, c)


def resize_bilinear_np(img: np.ndarray, hw: tuple) -> np.ndarray:
    """:func:`resize_bilinear` of a float32 numpy array, on the CPU."""
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    return resize_bilinear(x, hw).numpy()


class ReplicaWideDataset:
    """Wide-baseline Replica scenes (reference ``replica_wide.py``).

    :param data_dir: directory holding ``{scene}_{sub}/data.npz`` dirs.
    :param scenes: scene indices (reference: range(18)); missing scene
        files are skipped.
    """

    def __init__(self, data_dir: str | Path, height: int, width: int,
                 scenes: Sequence[int] = tuple(range(18)), sub_idx: int = 0,
                 with_cubes: bool = False):
        self.data_dir = Path(data_dir)
        self.hw = (height, width)
        self.with_cubes = with_cubes
        self.paths = []
        for s in scenes:
            p = self.data_dir / f"{s}_{sub_idx}" / "data.npz"
            if p.exists():
                self.paths.append(p)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> dict:
        data = np.load(self.paths[idx])
        panos = np.asarray(data["rgb_panos"], np.float32)
        depths = np.asarray(data["depth_panos"], np.float32)
        if depths.ndim == 3:
            depths = depths[..., None]
        sample = {
            "rgb_panos": resize_bilinear_np(panos, self.hw),
            "depth_panos": resize_bilinear_np(depths, self.hw),
            "rots": np.asarray(data["rots"], np.float32),
            "trans": np.asarray(data["trans"], np.float32),
        }
        if self.with_cubes:
            for k in ("rgb_cubes", "depth_cubes", "rots_cubes",
                      "trans_cubes"):
                sample[k] = np.asarray(data[k], np.float32)
        return sample

    def database(self, idx: int, min_depth: float = 0.5,
                 max_depth: float = 15.0) -> PanoDatabase:
        s = self[idx]
        return PanoDatabase("replica", s["rgb_panos"], s["depth_panos"],
                            s["rots"], s["trans"], min_depth, max_depth)


def _swap_faces(arr: np.ndarray) -> np.ndarray:
    """Cube-face relayout 0<->5, 2<->4 (reference ``residential.py:33-41``)."""
    out = arr.copy()
    out[:, 0], out[:, 5] = arr[:, 5].copy(), arr[:, 0].copy()
    out[:, 2], out[:, 4] = arr[:, 4].copy(), arr[:, 2].copy()
    return out


def load_somsi_h5(path: str | Path, height: int, width: int,
                  ref_idx: int = 4) -> dict:
    """Load a SOMSI scene archive: u8 ``color`` -> float panos resized to
    (height, width); ``pose`` renormalized so view ``ref_idx`` is the
    world origin; poses returned as c2w (V, 4, 4)."""
    import h5py
    with h5py.File(path, "r") as f:
        color = np.asarray(f["color"][:], np.float32) / 255.0
        pose = np.asarray(f["pose"][:], np.float64)
    rgbs = resize_bilinear_np(color, (height, width))
    c2w = np.einsum("ij,vjk->vik", np.linalg.inv(pose[ref_idx]),
                    pose)[:, :4, :4]
    return {"rgbs": rgbs, "c2w": c2w.astype(np.float32)}


def load_residential_scene(path: str | Path,
                           views: Sequence[int] | None = None) -> dict:
    """Load one Residential/CoffeeArea scene archive.

    Accepts the reference's ``all.t7`` torch archive or an ``.npz`` with
    the same keys (a SOMSI ``.h5`` goes through :func:`load_somsi_h5`).
    Returns channel-last float arrays: ``rgbs`` (V, H, W, 3), ``c2w``
    (V, 4, 4) and, when present, ``cube_rgbs`` (V, 6, cw, cw, 3) /
    ``cube_c2w`` (V, 6, 4, 4), the poses' faces swapped.

    :param views: view subset; default [0, 4, 8] (refs + query, sorted).
    """
    path = Path(path)
    if views is None:
        views = sorted((*RESIDENTIAL_TRAIN_VIEWS, *RESIDENTIAL_VAL_VIEWS))
    views = list(views)
    if path.suffix in (".t7", ".pt", ".pth"):
        data = {k: np.asarray(v) for k, v in
                torch.load(path, map_location="cpu",
                           weights_only=False).items()}
    elif path.suffix == ".npz":
        data = dict(np.load(path))
    elif path.suffix == ".h5":
        raise ValueError(
            "load a SOMSI .h5 via load_somsi_h5 (needs height/width)")
    else:
        raise ValueError(f"unsupported scene archive {path.suffix!r}")

    rgbs = np.asarray(data["rgbs"], np.float32)[views]
    if rgbs.shape[1] == 3 and rgbs.shape[-1] != 3:   # (V, 3, H, W) torch
        rgbs = rgbs.transpose(0, 2, 3, 1)
    out = {"rgbs": rgbs, "c2w": np.asarray(data["c2w"], np.float32)[views]}
    if "cube_rgbs" in data:
        cubes = np.asarray(data["cube_rgbs"], np.float32)
        cubes = cubes.reshape(-1, 6, *cubes.shape[-3:])[views]
        if cubes.shape[2] == 3 and cubes.shape[-1] != 3:
            cubes = cubes.transpose(0, 1, 3, 4, 2)
        cube_c2w = np.asarray(data["cube_c2w"], np.float32)
        cube_c2w = cube_c2w.reshape(-1, 6, 4, 4)[views]
        # the archive stores the face images in one order and their poses
        # in another; only the poses are permuted, so that each lines up
        # with its image (the images stay in archive order)
        out["cube_rgbs"] = cubes
        out["cube_c2w"] = _swap_faces(cube_c2w)
    return out


def database_from_c2w(name: str, rgbs: np.ndarray, c2w: np.ndarray,
                      min_depth: float = 0.5,
                      max_depth: float = 15.0) -> PanoDatabase:
    """A PanoDatabase from c2w 4x4 poses (the Residential/CoffeeArea
    protocol: w2c = inv(c2w); zero depth maps as placeholders)."""
    w2c = np.linalg.inv(np.asarray(c2w, np.float64))[:, :3, :]
    rots = w2c[:, :3, :3].astype(np.float32)
    trans = w2c[:, :3, 3].astype(np.float32)
    depths = np.zeros((*rgbs.shape[:-1], 1), np.float32)
    return PanoDatabase(name, np.asarray(rgbs, np.float32), depths,
                        rots, trans, min_depth, max_depth)


class ResidentialDataset:
    """Residential scene list (reference ``residential.py``): each scene is
    ``{root}/{i}_perspective_all/all.t7`` (or an ``all.npz``, or a SOMSI
    ``.h5`` when height and width are given)."""

    scene_glob = "*_perspective_all"
    archive_name = "all.t7"
    database_name = "residential"

    def __init__(self, root: str | Path, height: int | None = None,
                 width: int | None = None):
        self.root = Path(root)
        self.hw = (height, width)
        self.scene_dirs = sorted(self.root.glob(self.scene_glob))
        if not self.scene_dirs and self.root.exists():
            self.scene_dirs = sorted(
                p.parent for p in self.root.glob(f"*/{self.archive_name}"))

    def __len__(self) -> int:
        return len(self.scene_dirs)

    def __getitem__(self, idx: int) -> dict:
        d = self.scene_dirs[idx]
        for name in (self.archive_name, "all.npz"):
            if (d / name).exists():
                return load_residential_scene(d / name)
        h5s = sorted(d.glob("*.h5"))
        if h5s and all(self.hw):
            s = load_somsi_h5(h5s[0], *self.hw)
            views = sorted((*RESIDENTIAL_TRAIN_VIEWS,
                            *RESIDENTIAL_VAL_VIEWS))
            return {"rgbs": s["rgbs"][views], "c2w": s["c2w"][views]}
        raise FileNotFoundError(f"no scene archive under {d}")

    def database(self, idx: int, min_depth: float = 0.5,
                 max_depth: float = 15.0) -> PanoDatabase:
        s = self[idx]
        return database_from_c2w(self.database_name, s["rgbs"], s["c2w"],
                                 min_depth, max_depth)


class CoffeeAreaDataset(ResidentialDataset):
    """CoffeeArea scenes: the Residential archive schema."""

    database_name = "CoffeeArea"
