"""Scene database: one multi-view sample, its view split and the
cube-face cameras of its views.

Port of ``panogrf_tpu/data/database.py``: the 90-degree pinhole
intrinsics of a cube face, the camera-frame rotations of the six faces in
the [F R B L U D] layout of ``core/cubemap.py``, ``PanoDatabase`` with
``cube_cameras`` (the per-face world-to-camera poses of a view), and the
reference's view splits: references [0, 2] and query [1] for the two-view
protocol (``get_database_split``), the first ``reference_idx`` views for
the multi-view one (``get_database_split_mv``).  Numpy in, numpy out.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np


def get_poses(rots: np.ndarray, trans: np.ndarray) -> tuple:
    """(V, 3, 3) + (V, 3) w2c -> (w2c (V, 3, 4), c2w (V, 3, 4))."""
    w2c = np.concatenate([rots, trans[..., None]], -1).astype(np.float32)
    rot_inv = np.swapaxes(rots, -1, -2)
    t_inv = -np.einsum("vij,vj->vi", rot_inv, trans)
    c2w = np.concatenate([rot_inv, t_inv[..., None]], -1).astype(np.float32)
    return w2c, c2w


def cube_intrinsics(width: int) -> np.ndarray:
    """90-degree field-of-view pinhole K of a ``width``-pixel cube face,
    principal point at the centre of the align-corners pixel grid."""
    f = 0.5 * width / math.tan(0.5 * 90.0 / 180.0 * math.pi)
    c = (width - 1) / 2.0
    return np.asarray([[f, 0, c], [0, f, c], [0, 0, 1]], np.float32)


def cube_face_rotations() -> np.ndarray:
    """(6, 3, 3) rotations from each cube face's camera frame to the
    panorama camera's frame, faces [F R B L U D] as ``core/cubemap``'s
    ``equi_to_cube`` lays them out: a face camera's u axis runs along the
    face's columns, v along its rows and z along its optical axis, so a
    perspective render with ``R_face @ K^-1 [u, v, 1]`` rays reproduces
    ``equi_to_cube``'s faces (m3d's camera frame is the cubemap's sphere
    frame with x negated)."""
    faces = np.asarray([
        # x_face          y_face          z_face (optical axis)
        [[-1, 0, 0], [0, -1, 0], [0, 0, 1]],    # F  (z = +0.5)
        [[0, 0, -1], [0, -1, 0], [-1, 0, 0]],   # R  (x = +0.5)
        [[1, 0, 0], [0, -1, 0], [0, 0, -1]],    # B  (z = -0.5)
        [[0, 0, 1], [0, -1, 0], [1, 0, 0]],     # L  (x = -0.5)
        [[-1, 0, 0], [0, 0, 1], [0, 1, 0]],     # U  (y = +0.5)
        [[-1, 0, 0], [0, 0, -1], [0, -1, 0]],   # D  (y = -0.5)
    ], np.float64)
    # the columns are the face-frame axes: transpose the row triplets
    return np.ascontiguousarray(np.swapaxes(faces, -1, -2)) \
        .astype(np.float32)


@dataclasses.dataclass
class PanoDatabase:
    """One multi-view panorama sample."""
    database_name: str
    images: np.ndarray          # (V, H, W, 3)
    depths: np.ndarray          # (V, H, W, 1)
    rots: np.ndarray            # (V, 3, 3) w2c
    trans: np.ndarray           # (V, 3)
    min_depth: float = 0.5
    max_depth: float = 15.0
    test_img_ids: Sequence[int] = (1,)

    def __post_init__(self):
        self.w2c, self.c2w = get_poses(self.rots, self.trans)
        self.img_ids = list(range(len(self.images)))
        self.train_img_ids = [i for i in self.img_ids
                              if i not in set(self.test_img_ids)]

    @property
    def depth_range(self) -> np.ndarray:
        return np.asarray([self.min_depth, self.max_depth], np.float32)

    def get_image(self, img_id: int) -> np.ndarray:
        return self.images[int(img_id)]

    def get_depth(self, img_id: int) -> np.ndarray:
        return self.depths[int(img_id)]

    def cube_cameras(self, img_id: int) -> tuple:
        """Per-face (w2c (6, 3, 4), K (3, 3)) of view ``img_id``'s cubemap;
        K is that of a face half the panorama's width wide, as in the JAX
        package."""
        face_r = cube_face_rotations()                 # face -> camera
        r = self.rots[int(img_id)]
        t = self.trans[int(img_id)]
        # x_face = R_face^T x_cam and x_cam = R x_w + t
        rots = np.einsum("fji,jk->fik", face_r, r)
        trans = np.einsum("fji,j->fi", face_r, t)
        w2c = np.concatenate([rots, trans[..., None]], -1).astype(np.float32)
        return w2c, cube_intrinsics(self.images.shape[2] // 2)


def get_database_split(database: PanoDatabase, split_type: str = "test"):
    """(reference ids, query ids) of the two-view protocol: references
    [0, 2], the database's test views as queries, for the m3d, residential,
    CoffeeArea / coffee_area and replica databases; any other split type
    or database name raises ``NotImplementedError``."""
    if not split_type.startswith("test"):
        raise NotImplementedError(split_type)
    name = database.database_name
    if name.startswith(("m3d", "residential", "CoffeeArea", "coffee_area",
                        "replica")):
        return [0, 2], list(database.test_img_ids)
    raise NotImplementedError(name)


def get_database_split_mv(database: PanoDatabase, reference_idx: int,
                          test_views: Sequence[int]):
    """(reference ids, query ids) of the multi-view protocol: the first
    ``reference_idx`` views and ``test_views``."""
    return list(range(reference_idx)), list(test_views)
