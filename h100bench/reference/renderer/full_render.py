"""Pose paths rendered whole: ``render_video_device``.

Frozen from the port's ``renderer/full_render.py``, cut to the video path
with the coarse pass on a low-res grid.  The chunk loop is a Python loop
of eager passes; B poses ride the query axis of each chunk pass, so the
merged maps are shared and each pass launches its kernels once for the B
frames.
"""

from __future__ import annotations

import torch

from h100bench.reference.nn.blocks import resize_linear
from h100bench.reference.renderer.renderer import NeuralRayGenRenderer
from h100bench.reference.utils.device import resolve_device


def _on(model: NeuralRayGenRenderer, device) -> torch.device:
    dev = resolve_device(device)
    mdev = model.directions.device
    if mdev.type != dev.type or (dev.index is not None
                                 and mdev.index != dev.index):
        raise ValueError(f"model lives on {mdev}, asked to run on {dev}")
    return mdev


def _tensor(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _pixel_coords(xs, ys, n_chunks: int, chunk: int) -> torch.Tensor:
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx, yy], -1).reshape(n_chunks, chunk, 2).float()


def _render_poses(model: NeuralRayGenRenderer, ref_data: dict, c2w, qn: int,
                  que_depth_range, ref_depth_range, chunk: int,
                  coarse_lowres: int, coarse_chunk: int,
                  dev: torch.device) -> torch.Tensor:
    """The chunk loop over ``qn`` poses at once, ``c2w`` (qn, 3, 4): the
    coarse pass on the (H/f, W/f) grid of cell centres, its hit
    probabilities upsampled to drive the full-res fine pass; returns rgb
    (qn, H, W, 3) in [0, 1]."""
    h, w = model.height, model.width
    n = h * w
    if n % chunk:
        raise ValueError(f"chunk {chunk} does not divide {h}x{w} rays")
    nc = n // chunk
    coords = _pixel_coords(torch.arange(w, device=dev),
                           torch.arange(h, device=dev), nc, chunk)
    rgb = torch.empty(qn, nc, chunk, 3, device=dev)
    args = (c2w, _tensor(que_depth_range, dev), _tensor(ref_depth_range, dev))
    f = coarse_lowres
    if f < 2 or h % f or w % f:
        raise ValueError(f"coarse_lowres {f} must be > 1 and divide {h}x{w}")
    lh, lw = h // f, w // f
    nlr = lh * lw
    lchunk = min(coarse_chunk or chunk, nlr)
    if nlr % lchunk:
        raise ValueError(f"coarse chunk {lchunk} does not divide {nlr}")
    lnc = nlr // lchunk
    # the low-res rays sample the centre pixel of each f x f cell
    lcoords = _pixel_coords(torch.arange(lw, device=dev) * f + f // 2,
                            torch.arange(lh, device=dev) * f + f // 2,
                            lnc, lchunk)
    hit = torch.cat([model.coarse_hit_probs(
        ref_data, c.expand(qn, lchunk, 2), *args) for c in lcoords], 1)
    dn = hit.shape[-1]
    hit_full = resize_linear(hit.reshape(qn, lh, lw, dn), (h, w),
                             axes=(1, 2)).reshape(qn, nc, chunk, dn)
    for i in range(nc):
        rgb[:, i] = model.render_fine_from_hit(
            ref_data, coords[i].expand(qn, chunk, 2), hit_full[:, i],
            *args)["pixel_colors_nr_fine"]
    return torch.clamp(rgb.reshape(qn, h, w, 3), 0.0, 1.0)


@torch.inference_mode()
def render_video_device(model: NeuralRayGenRenderer, ref_data: dict,
                        c2ws, que_depth_range, ref_depth_range,
                        chunk: int = 256, coarse_lowres: int = 1,
                        coarse_chunk: int = 0,
                        device: str | torch.device = "cuda") -> torch.Tensor:
    """Render B frames of a pose path together: each chunk pass covers the
    chunk's rays of all B poses, so the maps are read by one pass and each
    kernel launches once per pass for the B frames.

    :param c2ws: (B, 3, 4) camera-to-world poses.
    :return: rgb (B, H, W, 3) in [0, 1].
    """
    dev = _on(model, device)
    c2ws = _tensor(c2ws, dev)
    if c2ws.dim() != 3 or tuple(c2ws.shape[1:]) != (3, 4):
        raise ValueError(f"c2ws must be (B, 3, 4), got {tuple(c2ws.shape)}")
    return _render_poses(model, ref_data, c2ws, c2ws.shape[0],
                         que_depth_range, ref_depth_range, chunk,
                         coarse_lowres, coarse_chunk, dev)
