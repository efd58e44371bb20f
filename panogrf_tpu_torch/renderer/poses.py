"""Render poses: the held-out eval pose and interpolated camera paths.

Own copy of ``panogrf_tpu/renderer/poses.py`` (numpy; the port may not
import the JAX package): 'eval' renders the held-out query view, 'inter' a
smooth path between the two reference views for video output, rotations
slerped through quaternions and positions lerped.
"""

from __future__ import annotations

import numpy as np


def rot_to_quat(r: np.ndarray) -> np.ndarray:
    """(3,3) rotation -> (4,) quaternion (w, x, y, z)."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (r[2, 1] - r[1, 2]) / s,
                         (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s])
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(r[i, i] - r[j, j] - r[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (r[k, j] - r[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (r[j, i] + r[i, j]) / s
    q[1 + k] = (r[k, i] + r[i, k]) / s
    return q


def quat_to_rot(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


def interpolate_c2w(c2w_a: np.ndarray, c2w_b: np.ndarray,
                    num: int) -> np.ndarray:
    """(3,4) x2 -> (num, 3, 4) smooth camera path (slerp + lerp)."""
    qa, qb = rot_to_quat(c2w_a[:, :3]), rot_to_quat(c2w_b[:, :3])
    poses = []
    for t in np.linspace(0.0, 1.0, num):
        r = quat_to_rot(slerp(qa, qb, float(t)))
        p = (1 - t) * c2w_a[:, 3] + t * c2w_b[:, 3]
        poses.append(np.concatenate([r, p[:, None]], 1))
    return np.stack(poses).astype(np.float32)


def prepare_render_info(c2w_all: np.ndarray, pose_type: str = "eval",
                        que_id: int = 1, ref_ids=(0, 2),
                        inter_num: int = 24) -> np.ndarray:
    """Render poses (K, 3, 4) from the sample's c2w matrices: 'eval' the
    held-out query view only, 'inter' a path between the two reference
    views."""
    if pose_type == "eval":
        return c2w_all[que_id][None]
    if pose_type == "inter":
        return interpolate_c2w(c2w_all[ref_ids[0]], c2w_all[ref_ids[1]],
                               inter_num)
    raise ValueError(pose_type)
