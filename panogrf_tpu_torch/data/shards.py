"""Offline array-shard dataset.

Port of ``panogrf_tpu/data/shards.py``, in the same on-disk format, so that
a shard directory written by either package reads in the other: each shard
is an uncompressed ``shard_{:05d}.npz`` holding a contiguous batch of
samples stacked on a leading axis, and ``meta.json`` gives the sample and
shard counts.

Sample schema (every key but the first four optional):
  rgb_panos   (V, H, W, 3)        float16 in [0, 1]
  depth_panos (V, H, W, 1)        float16 (radial distance, meters)
  rots        (V, 3, 3)           float32 (world-to-camera)
  trans       (V, 3)              float32
  rgb_cubes   (V, 6, cw, cw, 3)   float16, cube faces [F R B L U D]
  depth_cubes (V, 6, cw, cw, 1)   float16 (z-depth along each face's axis)
  rots_cubes  (V, 6, 3, 3)        float32 (per-face world-to-camera)
  trans_cubes (V, 6, 3)           float32

The reader maps each member of a shard in place (``np.savez`` stores
them uncompressed), so a sample read touches that sample's bytes only,
wherever it sits: an ``NpzFile`` would read a whole member array, every
sample of the shard, for every key of every sample.
"""

from __future__ import annotations

import json
import struct
import zipfile
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

SHARD_FMT = "shard_{:05d}.npz"
META_NAME = "meta.json"


def to_numpy(x) -> np.ndarray:
    """A host numpy array of ``x`` (a tensor on any device, or an array)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def sample_to_torch(sample: dict, device) -> dict:
    """A numpy sample as float32 tensors on ``device``."""
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in sample.items()}


class ShardWriter:
    """Collect samples and write them ``samples_per_shard`` to a shard;
    ``close`` (or leaving the ``with`` block) writes the last, partial
    shard and ``meta.json``."""

    # image-like fields stored float16, geometry float32
    F16_KEYS = ("rgb_panos", "depth_panos", "rgb_cubes", "depth_cubes")
    F32_KEYS = ("rots", "trans", "rots_cubes", "trans_cubes")

    def __init__(self, out_dir: str | Path, samples_per_shard: int = 64):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.samples_per_shard = samples_per_shard
        self._buf: list = []
        self._shard_idx = 0
        self._count = 0

    def add(self, sample: dict) -> None:
        """Add one sample; its values may be tensors on any device."""
        rec = {k: to_numpy(sample[k]).astype(np.float16)
               for k in self.F16_KEYS if k in sample}
        rec.update({k: to_numpy(sample[k]).astype(np.float32)
                    for k in self.F32_KEYS if k in sample})
        self._buf.append(rec)
        self._count += 1
        if len(self._buf) >= self.samples_per_shard:
            self._flush()

    def _flush(self) -> None:
        if not self._buf:
            return
        arrays = {k: np.stack([s[k] for s in self._buf])
                  for k in self._buf[0]}
        np.savez(self.out_dir / SHARD_FMT.format(self._shard_idx), **arrays)
        self._shard_idx += 1
        self._buf = []

    def close(self) -> None:
        self._flush()
        meta = {"num_samples": self._count,
                "num_shards": self._shard_idx,
                "samples_per_shard": self.samples_per_shard}
        (self.out_dir / META_NAME).write_text(json.dumps(meta))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def map_npz(path: str | Path) -> dict:
    """The members of an ``.npz`` as read-only memory maps at their offsets
    in the file; a member that is compressed (``np.savez_compressed``) or
    not a plain ``.npy`` v1/v2 array is decoded whole instead."""
    headers = {(1, 0): np.lib.format.read_array_header_1_0,
               (2, 0): np.lib.format.read_array_header_2_0}
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            name = info.filename.removesuffix(".npy")
            if info.compress_type == zipfile.ZIP_STORED:
                # local file header: 30 bytes, then the name and the extra
                # field, whose lengths are its last two 16-bit words
                f.seek(info.header_offset)
                n_name, n_extra = struct.unpack("<HH", f.read(30)[26:])
                f.seek(info.header_offset + 30 + n_name + n_extra)
                version = np.lib.format.read_magic(f)
                if version in headers:
                    shape, fortran, dtype = headers[version](f)
                    if not dtype.hasobject and np.prod(shape) > 0:
                        out[name] = np.memmap(
                            path, dtype=dtype, mode="r", offset=f.tell(),
                            shape=shape, order="F" if fortran else "C")
                        continue
            with zf.open(info) as m:
                out[name] = np.lib.format.read_array(m)
    return out


class ShardReader:
    """Random access to the samples of a shard directory, with a
    round-robin split of the sample indices across hosts.

    ``reader[i]`` is sample ``i`` as float32 numpy copies of that sample's
    slice of the mapped members.  At most 3 shards stay mapped: mapping a
    fourth drops the others.
    """

    def __init__(self, shard_dir: str | Path, host_id: int = 0,
                 num_hosts: int = 1):
        self.dir = Path(shard_dir)
        meta = json.loads((self.dir / META_NAME).read_text())
        self.num_samples = meta["num_samples"]
        self.sps = meta["samples_per_shard"]
        self.num_shards = meta["num_shards"]
        self.host_id = host_id
        self.num_hosts = num_hosts
        self._cache: dict = {}

    def __len__(self) -> int:
        return self.num_samples

    def _load_shard(self, si: int) -> dict:
        if si not in self._cache:
            if len(self._cache) > 2:
                self._cache.clear()
            self._cache[si] = map_npz(self.dir / SHARD_FMT.format(si))
        return self._cache[si]

    def __getitem__(self, idx: int) -> dict:
        si, off = divmod(idx, self.sps)
        shard = self._load_shard(si)
        return {k: np.array(a[off], np.float32) for k, a in shard.items()}

    def host_indices(self) -> np.ndarray:
        """This host's sample indices: every ``num_hosts``-th from
        ``host_id``."""
        return np.arange(self.host_id, self.num_samples, self.num_hosts)

    def iter_epoch(self, rng: np.random.Generator,
                   shuffle: bool = True) -> Iterator[dict]:
        idx = self.host_indices()
        if shuffle:
            idx = rng.permutation(idx)
        for i in idx:
            yield self[int(i)]


def write_synthetic_dataset(out_dir: str | Path, num_samples: int,
                            height: int, width: int, m3d_dist: float = 0.5,
                            seed: int = 0, samples_per_shard: int = 64,
                            device="cuda") -> None:
    """Render ``num_samples`` procedural 3-view samples on ``device`` and
    write them as shards; sample ``i`` is the scene of seed
    ``seed * 100003 + i`` with the camera draw of seed ``seed * 7 + i``,
    as in the JAX package."""
    from panogrf_tpu_torch.data.synthetic import (SphereScene,
                                                  make_three_view_sample)
    from panogrf_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    with ShardWriter(out_dir, samples_per_shard) as w:
        for i in range(num_samples):
            scene = SphereScene.random(seed * 100003 + i, device=dev)
            w.add(make_three_view_sample(scene, height, width, m3d_dist,
                                         seed=seed * 7 + i))
