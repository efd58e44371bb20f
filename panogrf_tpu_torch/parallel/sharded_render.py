"""Full-panorama rendering with the rays split over a mesh of ranks.

Port of ``panogrf_tpu/parallel/sharded_render.py``.  The scaling dimension
of this workload is the rays (512 x 1024 per panorama): each rank renders
H*W/N of them through the single-device chunk loop
(``renderer/full_render.py``), with the reference features and the
parameters replicated, and the ranks assemble the image.  With
``coarse_lowres`` f > 1 the coarse importance pass runs on the (H/f, W/f)
ray grid, split the same way, and the ranks assemble its hit map before
the bilinear upsample that drives every rank's fine pass.
"""

from __future__ import annotations

import torch

from panogrf_tpu_torch.parallel.mesh import Mesh
from panogrf_tpu_torch.renderer import full_render
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer


@torch.inference_mode()
def render_image_sharded(model: NeuralRayGenRenderer, ref_data: dict,
                         que_c2w, que_depth_range, ref_depth_range,
                         mesh: Mesh, coarse_lowres: int = 1,
                         chunk: int = 8192,
                         coarse_chunk: int = 0) -> torch.Tensor:
    """Render a full panorama with its rays split over ``mesh``'s ray axis,
    ``chunk`` rays a pass; every rank calls it on replicated ``model`` and
    ``ref_data`` (``full_render.prepare_ref_data``) on its device.

    :param que_c2w: (3, 4); que_depth_range (1, 2); ref_depth_range
        (rfn, 2).
    :param coarse_chunk: ray-chunk size of the low-res coarse pass
        (0 = chunk).
    :return: rgb (H, W, 3) in [0, 1], the same on every rank.
    """
    dev = full_render._on(model, mesh.device)
    return full_render._render_poses(
        model, ref_data, full_render._tensor(que_c2w, dev), 1,
        que_depth_range, ref_depth_range, chunk, coarse_lowres,
        coarse_chunk, dev, mesh=mesh)[0]
