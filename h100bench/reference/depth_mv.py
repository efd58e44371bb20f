"""The multi-source depth stack of the multi-view model, in plain PyTorch.

Each reference view is swept against several source views and the MVS
net averages the sweeps' costs (upstream's
``FullPipeline.estimate_depth_using_cost_volume_multiview``,
``network/omni_mvsnet/pipeline3_model.py:951-1300``).  Built on the frozen
pieces of ``depth.py`` (``run_mono``) and ``models/mvs.py``
(``MVSDepthModel``, which averages over any number of sources); imports
nothing of the port and nothing of JAX.  Run it in float32 with TF32 off
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False), as the benchmark does.

Departures from upstream:

* the views are stacked as ``[src_0, ref, src_1, ...]``, the reference
  at index 1 as the frozen MVS net takes it (upstream puts the reference
  first); the costs are averaged in the sources' order, so the sum's
  rounding order differs;
* each reference's sources are the ones the caller gives (the benchmark
  gives every other reference), where upstream sweeps against the
  neighbouring views of its sequence;
* the prior and the MVS net run on all references as one batch, in eval
  mode (BatchNorm on its running statistics).
"""

from __future__ import annotations

import torch

from h100bench.reference.depth import run_mono
from h100bench.reference.models.mvs import MVSDepthModel
from h100bench.reference.models.unifuse import UniFuse
from h100bench.reference.nn.blocks import resize_linear


@torch.no_grad()
def stack_forward_mv(mono: UniFuse, mvs: MVSDepthModel, ref_imgs, src_imgs,
                     ref_w2c, src_w2c, mono_hw: tuple,
                     depth_hw: tuple) -> dict:
    """Depth of every reference view from its S sources: ``ref_imgs``
    (R, H, W, 3), ``src_imgs`` (R, S, H, W, 3), ``ref_w2c`` (R, 3, 4),
    ``src_w2c`` (R, S, 3, 4) -> ``mvs_depth`` (R, dh, dw, 1) and
    ``mono_depth`` (R, mh, mw, 1); both nets in eval mode."""
    dh, dw = depth_hw
    m = run_mono(mono, ref_imgs, mono_hw)
    s = src_imgs.shape[1]
    views = [src_imgs[:, 0], ref_imgs] + [src_imgs[:, k] for k in range(1, s)]
    poses = [src_w2c[:, 0], ref_w2c] + [src_w2c[:, k] for k in range(1, s)]
    panos = torch.stack([resize_linear(v, (dh, dw), axes=(1, 2))
                         for v in views], 1)
    rots = torch.stack([p[:, :, :3] for p in poses], 1)
    trans = torch.stack([p[:, :, 3] for p in poses], 1)
    out = mvs(panos, rots, trans, m["pred_depth"], m.get("mono_feat"))
    return {"mvs_depth": torch.clamp(out["depth"], min=0.0),
            "mono_depth": m["pred_depth"]}
