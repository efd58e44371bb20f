"""imgs_info construction: the renderer's input schema.

Port of ``panogrf_tpu/data/imgs_info.py``: dict-of-tensor samples of the
3-view protocol (query view 1, reference views [0, 2], each reference's
MVS source the other reference), of the multi-view protocol (any
reference set and one query view) and the 512 random training rays drawn
with numpy, as the JAX package draws them.  Channel-last; poses are (3, 4)
world-to-camera.
"""

from __future__ import annotations

import math

import numpy as np
import torch

REF_IDS = (0, 2)
QUE_ID = 1
# source view of each reference view (the other reference)
SRC_IDS = (2, 0)


def polar_weights(height: int, width: int, device=None) -> torch.Tensor:
    """(H, W, 1) sin(phi) of each pixel row's centre."""
    v = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) \
        * (math.pi / height)
    return torch.sin(v)[:, None, None].expand(height, width, 1)


def pose_w2c(rots: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """(V, 3, 3) + (V, 3) -> (V, 3, 4) w2c matrices."""
    return torch.cat([rots, trans[..., None]], -1)


def build_imgs_info(sample: dict, ids, depth_range: tuple,
                    with_depth: bool = True) -> dict:
    """Per-view info dict for the given view ids.

    sample keys: rgb_panos (V, H, W, 3), depth_panos (V, H, W, 1),
    rots (V, 3, 3), trans (V, 3).
    """
    dev = sample["rgb_panos"].device
    idx = torch.as_tensor(list(ids), device=dev)
    info = {
        "imgs": sample["rgb_panos"][idx],
        "w2c": pose_w2c(sample["rots"], sample["trans"])[idx],
        "depth_range": torch.tensor([list(depth_range)] * len(idx),
                                    dtype=torch.float32, device=dev),
    }
    if with_depth and "depth_panos" in sample:
        info["true_depth"] = sample["depth_panos"][idx]
    return info


def c2w_from_w2c(w2c: torch.Tensor) -> torch.Tensor:
    rot = w2c[..., :3, :3].transpose(-1, -2)
    t = -torch.einsum("...ij,...j->...i", rot, w2c[..., :3, 3])
    return torch.cat([rot, t[..., None]], -1)


def sample_train_coords(rng: np.random.Generator, height: int, width: int,
                        num: int = 512, device=None) -> torch.Tensor:
    """Random integer pixel coords (1, num, 2), float32."""
    xs = rng.integers(0, width, size=num)
    ys = rng.integers(0, height, size=num)
    return torch.as_tensor(np.stack([xs, ys], -1)[None], dtype=torch.float32,
                           device=device)


def full_image_coords(height: int, width: int, device=None) -> torch.Tensor:
    """All pixel coords (1, H*W, 2), row by row."""
    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], -1).reshape(1, -1, 2).float()


def build_render_sample(sample: dict, coords: torch.Tensor,
                        render_depth_range=(0.5, 15.0),
                        src_for_mvs: bool = True) -> dict:
    """Assemble the renderer's ``data`` dict from a 3-view sample (query
    1, references [0, 2], MVS sources [2, 0]).  The references'
    ``mvs_depth`` is attached afterwards."""
    ref_info = build_imgs_info(sample, REF_IDS, render_depth_range)
    que_info = build_imgs_info(sample, [QUE_ID], render_depth_range)
    que_info["c2w"] = c2w_from_w2c(que_info.pop("w2c"))[0]
    que_info["coords"] = coords
    data = {"ref_imgs_info": ref_info, "que_imgs_info": que_info}
    if src_for_mvs:
        data["src_imgs_info"] = build_imgs_info(sample, SRC_IDS,
                                                render_depth_range,
                                                with_depth=False)
    return data


def build_render_sample_mv(sample: dict, coords: torch.Tensor, ref_ids,
                           que_id: int,
                           render_depth_range=(0.5, 15.0)) -> dict:
    """Multi-view variant of ``build_render_sample``: the references
    ``ref_ids`` and the query ``que_id`` of a V-view sample; no
    ``src_imgs_info`` (each reference's MVS source is the next reference,
    cyclically).  The references' ``mvs_depth`` is attached afterwards."""
    ref_info = build_imgs_info(sample, ref_ids, render_depth_range)
    que_info = build_imgs_info(sample, [que_id], render_depth_range)
    que_info["c2w"] = c2w_from_w2c(que_info.pop("w2c"))[0]
    que_info["coords"] = coords
    return {"ref_imgs_info": ref_info, "que_imgs_info": que_info}
