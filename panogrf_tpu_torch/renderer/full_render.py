"""Full-image rendering: per-scene preparation and the chunked frame loop.

Port of ``prepare_ref_data`` and ``render_image_device`` from
``panogrf_tpu/renderer/full_render.py``.  The JAX package maps its chunks
with ``lax.map`` inside one compiled program; here the chunk loop is a
Python loop of eager passes.  Both entry points run on CUDA unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

from panogrf_tpu_torch.nn.blocks import resize_linear
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer
from panogrf_tpu_torch.utils.device import resolve_device


def _on(model: NeuralRayGenRenderer, device) -> torch.device:
    dev = resolve_device(device)
    mdev = model.directions.device
    if mdev.type != dev.type or (dev.index is not None
                                 and mdev.index != dev.index):
        raise ValueError(f"model lives on {mdev}, asked to run on {dev}")
    return mdev


def _tensor(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


@torch.inference_mode()
def prepare_ref_data(model: NeuralRayGenRenderer, ref_info: dict,
                     device: str | torch.device = "cuda") -> dict:
    """Encode reference views once per scene.

    :param ref_info: ``imgs`` (rfn, H, W, 3), ``mvs_depth``
        (rfn, dh, dw, 1) and ``w2c`` (rfn, 3, 4), as arrays or tensors.
    """
    dev = _on(model, device)
    ref_data = model.prepare_ref(_tensor(ref_info["imgs"], dev),
                                 _tensor(ref_info["mvs_depth"], dev))
    ref_data["w2c"] = _tensor(ref_info["w2c"], dev)
    return ref_data


def _pixel_coords(xs, ys, n_chunks: int, chunk: int) -> torch.Tensor:
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx, yy], -1).reshape(n_chunks, 1, chunk, 2).float()


@torch.inference_mode()
def render_image_device(model: NeuralRayGenRenderer, ref_data: dict,
                        que_c2w, que_depth_range, ref_depth_range,
                        chunk: int = 8192, coarse_lowres: int = 1,
                        coarse_chunk: int = 0,
                        device: str | torch.device = "cuda") -> torch.Tensor:
    """Render the whole panorama, ``chunk`` rays at a time.

    :param que_c2w: (3, 4); que_depth_range (1, 2); ref_depth_range
        (rfn, 2).
    :param coarse_lowres: f > 1 runs the coarse importance pass on an
        (H/f, W/f) grid of the cells' centre pixels and bilinearly
        upsamples its hit probability to drive the full-res fine pass.
    :param coarse_chunk: ray-chunk size of that low-res pass (0 = chunk).
    :return: rgb (H, W, 3) in [0, 1].
    """
    dev = _on(model, device)
    que_c2w = _tensor(que_c2w, dev)
    que_depth_range = _tensor(que_depth_range, dev)
    ref_depth_range = _tensor(ref_depth_range, dev)
    h, w = model.height, model.width
    n = h * w
    if n % chunk:
        raise ValueError(f"chunk {chunk} does not divide {h}x{w} rays")
    coords = _pixel_coords(torch.arange(w, device=dev),
                           torch.arange(h, device=dev), n // chunk, chunk)
    rgb = torch.empty(n // chunk, chunk, 3, device=dev)
    args = (que_c2w, que_depth_range, ref_depth_range)

    if coarse_lowres == 1:
        for i in range(n // chunk):
            rgb[i] = model.render_rays(ref_data, coords[i],
                                       *args)["pixel_colors_nr_fine"][0]
        return torch.clamp(rgb.reshape(h, w, 3), 0.0, 1.0)

    f = coarse_lowres
    if h % f or w % f:
        raise ValueError(f"coarse_lowres {f} does not divide {h}x{w}")
    lh, lw = h // f, w // f
    nlr = lh * lw
    lchunk = min(coarse_chunk or chunk, nlr)
    if nlr % lchunk:
        raise ValueError(f"coarse chunk {lchunk} does not divide {nlr}")
    lcoords = _pixel_coords(torch.arange(lw, device=dev) * f + f // 2,
                            torch.arange(lh, device=dev) * f + f // 2,
                            nlr // lchunk, lchunk)
    hit = torch.cat([model.coarse_hit_probs(ref_data, c, *args)[0]
                     for c in lcoords])                     # (nlr, dn)
    dn = hit.shape[-1]
    hit_full = resize_linear(hit.reshape(lh, lw, dn), (h, w), axes=(0, 1))
    hit_full = hit_full.reshape(n // chunk, 1, chunk, dn)
    for i in range(n // chunk):
        rgb[i] = model.render_fine_from_hit(
            ref_data, coords[i], hit_full[i], *args)["pixel_colors_nr_fine"][0]
    return torch.clamp(rgb.reshape(h, w, 3), 0.0, 1.0)
