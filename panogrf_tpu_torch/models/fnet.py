"""FNET: the single-UNet spherical MVS depth net.

Port of ``panogrf_tpu/models/fnet.py``: one shared UNet encodes each
panorama to a ``cost_volume_channels``-wide map at full resolution, the
source view (index 0) is swept into the reference view (index 1) over
``num_depths`` inverse-uniform hypotheses with the ``abs_diff`` cost
(``ops/cost_volume.batched_sweep_cost``), the cost is summed over the
channels, softmaxed over the depths as it is (the features are learnt, so
the sign is free) and the depth is the hypotheses' expectation.  There is
no 3D regulariser.  With ``use_cube`` the UNet's input carries the
panorama's cube -> ERP round trip as 3 more channels.

Parameter names are the port's own (the JAX package has no converter):
``unet.enc{i}`` (4x4 stride-2 convs, wrap padding 1), ``unet.dec{i}``
(``ConvBlock2``: ``conv1``, ``conv2``) and ``unet.final``.  Channel-last
in and out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from panogrf_tpu_torch.core import cubemap
from panogrf_tpu_torch.core.sphere import get_convention
from panogrf_tpu_torch.nn.blocks import ConvBlock2, PadConv2d, resize_linear
from panogrf_tpu_torch.ops.cost_volume import batched_sweep_cost


class FNetUNet(nn.Module):
    """Wrap-padded UNet: ``layers`` stride-2 encoders of 16 * 2^i channels
    with leaky ReLU, decoders (``ConvBlock2`` on the deeper decoder's
    output beside the level's skip, then a 2x linear resize,
    align_corners=False) and a 3x3 conv to ``out_channels``; NCHW, output
    at the input's resolution."""

    def __init__(self, in_channels: int, layers: int = 5, base: int = 16,
                 out_channels: int = 64, wrap: bool = True):
        super().__init__()
        self.layers = layers
        chans = [base * 2 ** i for i in range(layers)]
        for i, cout in enumerate(chans):
            cin = in_channels if i == 0 else chans[i - 1]
            self.add_module(f"enc{i}", PadConv2d(cin, cout, 4, 2, wrap=wrap,
                                                 padding=1))
        for i, cout in enumerate(chans):
            cin = chans[i] + (chans[i + 1] if i + 1 < layers else 0)
            self.add_module(f"dec{i}", ConvBlock2(cin, cout, wrap=wrap,
                                                  pool=False))
        self.final = PadConv2d(base, out_channels, 3, wrap=wrap)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for i in range(self.layers):
            x = F.leaky_relu(getattr(self, f"enc{i}")(x), 0.01)
            skips.append(x)                   # resolution H / 2^(i+1)
        h = None
        for i in reversed(range(self.layers)):
            h = skips[i] if h is None else torch.cat([h, skips[i]], 1)
            h, _ = getattr(self, f"dec{i}")(h)
            h = resize_linear(h, (2 * h.shape[2], 2 * h.shape[3]),
                              axes=(2, 3))
        return self.final(h)


class FNetDepthModel(nn.Module):
    """Two-view single-UNet MVS depth of view 1 (view 0 is warped into
    it)."""

    def __init__(self, convention_name: str = "m3d", num_depths: int = 64,
                 min_depth: float = 0.5, max_depth: float = 10.0,
                 layers: int = 5, cost_volume_channels: int = 64,
                 use_cube: bool = True, wrap: bool = True):
        super().__init__()
        self.convention = get_convention(convention_name)
        self.num_depths = num_depths
        self.min_depth, self.max_depth = min_depth, max_depth
        self.use_cube = use_cube
        self.unet = FNetUNet(6 if use_cube else 3, layers,
                             out_channels=cost_volume_channels, wrap=wrap)

    def encode(self, panos: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) -> (N, H, W, C) matching features."""
        x = panos
        if self.use_cube:
            n, h, w, _ = panos.shape
            cube = cubemap.equi_to_cube(panos, h // 2)
            x = torch.cat([x, cubemap.cube_to_equi(cube, h, w)], -1)
        return self.unet(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def forward(self, panos: torch.Tensor, rots: torch.Tensor,
                trans: torch.Tensor) -> dict:
        """
        :param panos: (B, 2, H, W, 3); rots (B, 2, 3, 3) and trans (B, 2, 3)
            world-to-camera, view 0 the source and view 1 the reference.
        :return: ``depth`` (B, H, W, 1) and ``prob`` (B, D, H, W), the
            softmax over the hypotheses.
        """
        b, v, h, w, _ = panos.shape
        assert v == 2, "FNET is the two-view variant"
        feats = self.encode(panos.reshape(b * v, h, w, 3))
        feats = feats.reshape(b, v, h, w, -1)
        d_centers = 1.0 / torch.linspace(1.0 / self.min_depth,
                                         1.0 / self.max_depth,
                                         self.num_depths,
                                         device=panos.device)
        dv = d_centers[None, :, None, None].expand(b, -1, h, w)
        cost = batched_sweep_cost(feats[:, 1], feats[:, 0], dv, rots, trans,
                                  self.convention, cost_type="abs_diff")
        prob = torch.softmax(cost.sum(-1), dim=1)          # (B, D, H, W)
        depth = (prob * d_centers[None, :, None, None]).sum(1)
        return {"depth": torch.relu(depth)[..., None], "prob": prob}
