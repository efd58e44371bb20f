"""Online sample generator: the habitat-sim stream on procedural scenes.

Port of ``panogrf_tpu/data/online.py``.  The reference trains from
``HabitatImageGenerator`` (reference
``data_readers/habitat_data_neuray.py:334``,
``create_rgb_dataset.py:97-614``): an infinite dataset that, per index,
places a camera with a random yaw in a Matterport3D mesh, renders
``seq_len`` panoramas spaced ``m3d_dist`` apart along the camera z axis,
normalises the poses so that the first view sits at the identity, and
returns ``{rgb_panos, depth_panos, rots, trans}`` plus the optional cube
fields.  Here the scenes are the procedural ones of ``data/synthetic.py``,
ray-traced on ``device``; the stream's contract is the reference's:

* the train split is infinite (``__len__`` = 2**31);
* the val and test splits hold a fixed number of cached samples;
* the poses are normalised with view 0 at the identity
  (:func:`panogrf_tpu_torch.data.lmdb_import.normalize_poses`);
* ``with_cubes`` adds the six cube faces of every view, their z-depth and
  per-face world-to-camera poses, as the reference's LMDB writer stores
  them (``lmdb_write_render.py:225-231``).

Samples are numpy float32 dicts on the host, in the layout ``ShardWriter``
and the CLIs' ``--shards`` readers take; the same seed gives the JAX
package's scenes and cameras.
"""

from __future__ import annotations

import numpy as np
import torch

from panogrf_tpu_torch.data.database import cube_face_rotations
from panogrf_tpu_torch.data.lmdb_import import normalize_poses
from panogrf_tpu_torch.data.shards import ShardWriter, to_numpy
from panogrf_tpu_torch.data.synthetic import (SphereScene, render_cube_faces,
                                              render_panorama)
from panogrf_tpu_torch.utils.device import resolve_device

_TRAIN_LEN = 2 ** 31  # reference habitat_data_neuray.py:429
_SPLIT_SEED = {"train": 0, "val": 7_000_003, "test": 11_000_027}


class OnlineImageGenerator:
    """Infinite online multi-view panorama stream (see the module
    docstring).

    :param split: 'train' (infinite) | 'val' | 'test' (fixed, cached).
    :param seq_len: views per sample, spaced ``m3d_dist`` along camera z.
    :param with_cubes: also render the 6 cube faces of every view (rgb,
        z-depth and per-face w2c).
    :param device: where the scenes are ray-traced: 'cuda' (default; raises
        without a card) or 'cpu'.
    """

    def __init__(self, split: str = "train", height: int = 512,
                 width: int = 1024, seq_len: int = 3,
                 m3d_dist: float = 0.5, with_cubes: bool = False,
                 convention: str = "m3d", val_sample_num: int = 32,
                 num_objects: int = 12, seed: int = 0, device="cuda"):
        if split not in _SPLIT_SEED:
            raise ValueError(f"unknown split {split!r}")
        self.split = split
        self.height, self.width = height, width
        self.seq_len = seq_len
        self.m3d_dist = m3d_dist
        self.with_cubes = with_cubes
        self.convention = convention
        self.val_sample_num = val_sample_num
        self.num_objects = num_objects
        self.seed = seed
        self.device = resolve_device(device)
        self._cache: dict = {}

    def __len__(self) -> int:
        return _TRAIN_LEN if self.split == "train" else self.val_sample_num

    def _make(self, idx: int) -> dict:
        dev = self.device
        base_seed = (self.seed * 600_000_001 + _SPLIT_SEED[self.split]
                     + int(idx))
        scene = SphereScene.random(base_seed, num=self.num_objects,
                                   device=dev)
        rng = np.random.default_rng(base_seed ^ 0x5EED)

        # a common yaw, positions spaced m3d_dist along the camera z axis
        # (reference movement deltas, create_rgb_dataset.py:294-301)
        yaw = rng.uniform(0, 2 * np.pi)
        cy, sy = np.cos(yaw), np.sin(yaw)
        rot_c2w = np.asarray([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]],
                             np.float32)
        base = rng.uniform(-1.0, 1.0, size=3).astype(np.float32)
        offsets = (np.arange(self.seq_len, dtype=np.float32)
                   - (self.seq_len - 1) / 2.0) * self.m3d_dist
        positions = [base + off * rot_c2w[:, 2] for off in offsets]

        rot_t = torch.as_tensor(rot_c2w, device=dev)
        rgbs, depths, cube_rgbs, cube_zs = [], [], [], []
        for p in positions:
            p_t = torch.as_tensor(p, dtype=torch.float32, device=dev)
            rgb, dist = render_panorama(scene, p_t, rot_t, self.height,
                                        self.width, self.convention)
            rgbs.append(to_numpy(rgb))
            depths.append(to_numpy(dist))
            if self.with_cubes:
                crgb, cz = render_cube_faces(scene, p_t, rot_t,
                                             self.height // 2)
                cube_rgbs.append(to_numpy(crgb))
                cube_zs.append(to_numpy(cz))

        # pose normalisation: view 0 at the world identity
        rots_c2w = np.broadcast_to(rot_c2w, (self.seq_len, 3, 3))
        rots, trans = normalize_poses(rots_c2w, np.stack(positions),
                                      reference_idx=0)
        sample = {"rgb_panos": np.stack(rgbs).astype(np.float32),
                  "depth_panos": np.stack(depths).astype(np.float32),
                  "rots": rots, "trans": trans}
        if self.with_cubes:
            # per-face w2c from the normalised panorama w2c, composed as in
            # PanoDatabase.cube_cameras
            face_r = cube_face_rotations()
            sample.update({
                "rgb_cubes": np.stack(cube_rgbs).astype(np.float32),
                "depth_cubes": np.stack(cube_zs).astype(np.float32),
                "rots_cubes": np.einsum("fji,vjk->vfik", face_r,
                                        rots).astype(np.float32),
                "trans_cubes": np.einsum("fji,vj->vfi", face_r,
                                         trans).astype(np.float32)})
        return sample

    def __getitem__(self, idx: int) -> dict:
        if self.split == "train":
            return self._make(idx)
        if idx >= self.val_sample_num:
            raise IndexError(idx)
        if idx not in self._cache:   # fixed, cached eval samples
            self._cache[idx] = self._make(idx)
        return self._cache[idx]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def write_shards(self, out_dir, num_samples: int,
                     samples_per_shard: int = 64, start: int = 0) -> None:
        """Render samples ``start`` .. ``start + num_samples - 1`` into
        shards (the cube keys included when ``with_cubes``): the
        reference's ``lmdb_write_render.py`` stage."""
        with ShardWriter(out_dir, samples_per_shard) as w:
            for i in range(start, start + num_samples):
                w.add(self._make(i))
