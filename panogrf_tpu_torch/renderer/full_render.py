"""Full-image rendering: per-scene preparation, frames and pose paths.

Port of ``panogrf_tpu/renderer/full_render.py``: ``prepare_ref_data``,
``render_image_device`` (hierarchical, light-coarse or DINER frames),
``render_video_device`` and ``render_image``.
The JAX package maps its chunks with ``lax.map`` inside one compiled
program; here the chunk loop is a Python loop of eager passes.  The video
path renders B poses at once: they ride the query axis of each chunk pass
(the JAX package vmaps the chunk body over them), so the merged maps are
shared and each pass launches its kernels once for the B frames.  Every
entry point runs on CUDA unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

from panogrf_tpu_torch.nn.blocks import resize_linear
from panogrf_tpu_torch.parallel.mesh import RAY_AXIS, Mesh, assemble
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
    return torch.stack([xx, yy], -1).reshape(n_chunks, chunk, 2).float()


def _render_poses(model: NeuralRayGenRenderer, ref_data: dict, c2w, qn: int,
                  que_depth_range, ref_depth_range, chunk: int,
                  coarse_lowres: int, coarse_chunk: int,
                  dev: torch.device, diner: dict | None = None,
                  mesh: Mesh | None = None) -> torch.Tensor:
    """The chunk loop over ``qn`` poses at once: ``c2w`` (3, 4) for one
    frame or (qn, 3, 4); with ``diner`` (``render_rays_diner``'s counts)
    each chunk renders by depth-guided sampling; returns rgb
    (qn, H, W, 3) in [0, 1].  With a ``mesh`` this rank renders its
    contiguous share of the rays (and of the low-res coarse rays) over
    the mesh's ray axis, and the ranks assemble the low-res hit map and
    the image."""
    h, w = model.height, model.width
    n = h * w
    shards, index = (1, 0) if mesh is None else (mesh.shape[RAY_AXIS],
                                                 mesh.axis_index(RAY_AXIS))
    if n % shards:
        raise ValueError(f"{h}x{w} = {n} rays do not split over {shards} "
                         "ranks")
    if (n // shards) % chunk:
        raise ValueError(f"chunk {chunk} does not divide {h}x{w} rays"
                         + (f" over {shards} ranks" if shards > 1 else ""))
    nc = n // shards // chunk
    coords = _pixel_coords(torch.arange(w, device=dev),
                           torch.arange(h, device=dev), shards * nc,
                           chunk)[index * nc:(index + 1) * nc]
    rgb = torch.empty(qn, nc, chunk, 3, device=dev)
    args = (c2w, _tensor(que_depth_range, dev), _tensor(ref_depth_range, dev))

    def image() -> torch.Tensor:
        out = rgb.reshape(qn, nc * chunk, 3)
        if mesh is not None:
            out = assemble(out, mesh, RAY_AXIS, dim=1)
        return torch.clamp(out.reshape(qn, h, w, 3), 0.0, 1.0)

    if coarse_lowres == 1:
        for i in range(nc):
            c = coords[i].expand(qn, chunk, 2)
            out = model.render_rays_diner(ref_data, c, *args, **diner) \
                if diner is not None else model.render_rays(ref_data, c,
                                                            *args)
            rgb[:, i] = out["pixel_colors_nr_fine" if "pixel_colors_nr_fine"
                            in out else "pixel_colors_nr"]
        return image()

    f = coarse_lowres
    if diner is not None or model.light_coarse or \
            not model.use_hierarchical_sampling:
        raise ValueError("coarse_lowres > 1 needs the hierarchical coarse "
                         "pass (no DINER, no light_coarse)")
    if h % f or w % f:
        raise ValueError(f"coarse_lowres {f} does not divide {h}x{w}")
    lh, lw = h // f, w // f
    nlr = lh * lw
    if nlr % shards:
        raise ValueError(f"the {lh}x{lw} low-res rays do not split over "
                         f"{shards} ranks")
    lchunk = min(coarse_chunk or chunk, nlr // shards)
    if nlr // shards % lchunk:
        raise ValueError(f"coarse chunk {lchunk} does not divide {nlr}"
                         + (f" over {shards} ranks" if shards > 1 else ""))
    lnc = nlr // shards // lchunk
    # the low-res rays sample the centre pixel of each f x f cell
    lcoords = _pixel_coords(torch.arange(lw, device=dev) * f + f // 2,
                            torch.arange(lh, device=dev) * f + f // 2,
                            shards * lnc, lchunk)[index * lnc:
                                                  (index + 1) * lnc]
    hit = torch.cat([model.coarse_hit_probs(
        ref_data, c.expand(qn, lchunk, 2), *args) for c in lcoords], 1)
    if mesh is not None:
        hit = assemble(hit, mesh, RAY_AXIS, dim=1)
    dn = hit.shape[-1]
    hit_full = resize_linear(hit.reshape(qn, lh, lw, dn), (h, w),
                             axes=(1, 2)).reshape(qn, shards * nc, chunk, dn)
    for i in range(nc):
        rgb[:, i] = model.render_fine_from_hit(
            ref_data, coords[i].expand(qn, chunk, 2),
            hit_full[:, index * nc + i], *args)["pixel_colors_nr_fine"]
    return image()


@torch.inference_mode()
def render_image_device(model: NeuralRayGenRenderer, ref_data: dict,
                        que_c2w, que_depth_range, ref_depth_range,
                        chunk: int = 8192, coarse_lowres: int = 1,
                        coarse_chunk: int = 0, mode: str = "hierarchical",
                        n_candidates: int = 128, n_uniform: int = 0,
                        contain_uniform: int = 0,
                        device: str | torch.device = "cuda") -> torch.Tensor:
    """Render the whole panorama, ``chunk`` rays at a time.

    :param que_c2w: (3, 4); que_depth_range (1, 2); ref_depth_range
        (rfn, 2).
    :param mode: "hierarchical" (``render_rays``: coarse + fine, or the
        light coarse pass) or "diner" (``render_rays_diner`` at
        ``n_candidates``, ``n_uniform`` and ``contain_uniform``,
        deterministic; ``ref_data`` needs ``mvs_depth`` and
        ``mvs_uncert``).
    :param coarse_lowres: f > 1 runs the coarse importance pass on an
        (H/f, W/f) grid of the cells' centre pixels and bilinearly
        upsamples its hit probability to drive the full-res fine pass.
    :param coarse_chunk: ray-chunk size of that low-res pass (0 = chunk).
    :return: rgb (H, W, 3) in [0, 1].
    """
    dev = _on(model, device)
    if mode not in ("hierarchical", "diner"):
        raise ValueError(f"unknown mode {mode!r}")
    diner = dict(n_candidates=n_candidates, n_uniform=n_uniform,
                 contain_uniform=contain_uniform) if mode == "diner" else None
    return _render_poses(model, ref_data, _tensor(que_c2w, dev), 1,
                         que_depth_range, ref_depth_range, chunk,
                         coarse_lowres, coarse_chunk, dev, diner)[0]


@torch.inference_mode()
def render_video_device(model: NeuralRayGenRenderer, ref_data: dict,
                        c2ws, que_depth_range, ref_depth_range,
                        chunk: int = 256, coarse_lowres: int = 1,
                        coarse_chunk: int = 0,
                        device: str | torch.device = "cuda") -> torch.Tensor:
    """Render B frames of a pose path together: each chunk pass covers the
    chunk's rays of all B poses, so the maps are read by one pass and each
    kernel launches once per pass for the B frames.  Each frame equals
    ``render_image_device``'s at the same flags, up to float rounding.

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


@torch.inference_mode()
def render_image(model: NeuralRayGenRenderer, ref_info: dict, que_c2w,
                 que_depth_range, chunk: int = 8192,
                 ref_data: dict | None = None,
                 device: str | torch.device = "cuda") -> dict:
    """Render a full ERP image through the full coarse + fine pass, the
    last chunk padded with pixel (0, 0) rays.

    :param ref_info: as ``prepare_ref_data`` takes it, with
        ``depth_range`` (rfn, 2).
    :return: ``rgb`` (H, W, 3) in [0, 1] and ``depth`` (H, W), of the
        fine pass with hierarchical sampling.
    """
    dev = _on(model, device)
    if ref_data is None:
        ref_data = prepare_ref_data(model, ref_info, device=dev)
    h, w = model.height, model.width
    n = h * w
    pad = (-n) % chunk
    coords = torch.cat([_pixel_coords(torch.arange(w, device=dev),
                                      torch.arange(h, device=dev), 1, n)[0],
                        torch.zeros(pad, 2, device=dev)])
    args = (_tensor(que_c2w, dev), _tensor(que_depth_range, dev),
            _tensor(ref_info["depth_range"], dev))
    sfx = "_fine" if model.use_hierarchical_sampling else ""
    rgb, depth = [], []
    for i in range(coords.shape[0] // chunk):
        out = model.render_rays(ref_data,
                                coords[i * chunk:(i + 1) * chunk][None],
                                *args)
        rgb.append(out["pixel_colors_nr" + sfx][0])
        depth.append(out["render_depth" + sfx][0])
    return {"rgb": torch.clamp(torch.cat(rgb)[:n].reshape(h, w, 3), 0.0,
                               1.0),
            "depth": torch.cat(depth)[:n].reshape(h, w)}
