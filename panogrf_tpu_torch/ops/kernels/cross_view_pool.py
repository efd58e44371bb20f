"""The aggregation net's cross-view pool as one CUDA kernel, and the packing
of its weights.

``renderer/agg_net.py:pool_reference`` is the plain version: CPU tensors,
float32, gradient-carrying calls and other widths take it.  For bfloat16
CUDA inputs at the standard widths (rgb_feat 35, neuray_feat 32, ray_diff
4, mask 1 channels a view, 2 to 4 views) ``cross_view_pool`` launches
``csrc/cross_view_pool.cu``, which computes the whole pool in one pass.

The kernel reads its 15 Linear layers from one bfloat16 buffer that
``pack_pool_weights`` builds: for each layer in ``LAYERS`` order, its
weight padded to (K, N) (multiples of 16 and 8) in mma.sync's B-fragment
order, then its N biases.  ``LAYERS`` gives each padded row of K the input
feature it holds (-1: a zero row), in the order the kernel keeps the
layer's input in registers.
"""

from __future__ import annotations

import torch

from panogrf_tpu_torch.ops.kernels import fused_mlp

F, ND, RD = 35, 32, 4          # rgb_feat, neuray_feat, ray_diff channels
MIN_VIEWS, MAX_VIEWS = 2, 4


def _base_fc0_rows() -> list:
    """base_fc layer 0 reads [gf (4 x 35) | rgbf (35) | neuray (32)]; the
    kernel's K order is neuray (n tiles 0-3), rgbf (4-8) and a zero tile,
    then mean0, var0, mean1, var1 of gf, each padded to 40."""
    rows = [4 * F + F + j for j in range(ND)] + [4 * F + j for j in range(F)]
    rows += [-1] * (80 - len(rows))
    for seg in range(4):
        rows += [F * seg + j for j in range(F)] + [-1] * (40 - F)
    return rows


def _rgb_fc0_rows() -> list:
    """rgb_fc layer 0 reads [x (32) | vis (1) | ray_diff (4)]; the kernel's
    K order is x, then ray_diff in n tile 4 and vis in n tile 5."""
    return list(range(32)) + [33, 34, 35, 36] + [-1] * 4 + [32] + [-1] * 7


# (stack, layer index, padded K, padded N, K rows or None for in order),
# in the packed buffer's order (csrc/cross_view_pool.cu enum Layer)
LAYERS = (
    ("ray_dir_fc", 0, 16, 16, None),
    ("ray_dir_fc", 1, 16, 40, None),
    ("neuray_fc", 0, 32, 8, None),
    ("neuray_fc", 1, 16, 8, None),
    ("base_fc", 0, 240, 64, _base_fc0_rows()),
    ("base_fc", 1, 64, 32, None),
    ("vis_fc", 0, 32, 32, None),
    ("vis_fc", 1, 32, 40, None),
    ("vis_fc2", 0, 32, 32, None),
    ("vis_fc2", 1, 32, 8, None),
    ("geometry_fc", 0, 80, 64, None),
    ("geometry_fc", 1, 64, 16, None),
    ("rgb_fc", 0, 48, 16, _rgb_fc0_rows()),
    ("rgb_fc", 1, 16, 8, None),
    ("rgb_fc", 2, 16, 8, None),
)
PACKED_SIZE = sum(k * n + n for _, _, k, n, _ in LAYERS)


def _to_fragments(wp: torch.Tensor) -> torch.Tensor:
    """A padded (K, N) weight in B-fragment order: k step s, n tile nt, lane
    (g, t), then W[16s + 2t + {0, 1, 8, 9}, 8 nt + g]."""
    k, n = wp.shape
    return wp.reshape(k // 16, 2, 4, 2, n // 8, 8) \
        .permute(0, 4, 5, 2, 1, 3).reshape(-1)


def _rows(k_rows, k_in: int, kp: int) -> list:
    return k_rows if k_rows is not None else \
        list(range(k_in)) + [-1] * (kp - k_in)


def pack_pool_weights(params: dict) -> torch.Tensor:
    """The kernel's bfloat16 buffer (``PACKED_SIZE``,) from ``params``:
    stack name -> [(W (in, out), b (out,)), ...], as
    ``agg_net._linears`` gives them, on their device."""
    parts = []
    for name, i, kp, np_, k_rows in LAYERS:
        w, b = params[name][i]
        rows = torch.tensor(_rows(k_rows, w.shape[0], kp), device=w.device)
        live = rows >= 0
        wp = torch.zeros(kp, np_, dtype=w.dtype, device=w.device)
        wp[live, :w.shape[1]] = w[rows[live]]
        bp = torch.zeros(np_, dtype=b.dtype, device=b.device)
        bp[:b.shape[0]] = b
        parts += [_to_fragments(wp), bp]
    return torch.cat(parts).to(torch.bfloat16).contiguous()


def _refusal(rgb_feat, neuray_feat, ray_diff, mask, packed=None,
             layout=True):
    """Why the kernel cannot take these operands, as the exception to
    raise, or None: bfloat16 tensors on one CUDA device, (N > 0, V, 35 /
    32 / 4 / 1) with 2 <= V <= 4, contiguous and 16-byte aligned (unless
    ``layout`` is False), and ``packed`` (when given) of
    ``PACKED_SIZE``."""
    ts = (rgb_feat, neuray_feat, ray_diff, mask)
    if any(t.dim() != 3 for t in ts):
        return ValueError("cross_view_pool takes (N, V, C) inputs")
    n, v, _ = rgb_feat.shape
    want = [(n, v, F), (n, v, ND), (n, v, RD), (n, v, 1)]
    if [tuple(t.shape) for t in ts] != want or n == 0 \
            or not MIN_VIEWS <= v <= MAX_VIEWS:
        return ValueError(f"cross_view_pool takes {want} with N > 0 and "
                          f"{MIN_VIEWS} <= V <= {MAX_VIEWS}; got "
                          f"{[tuple(t.shape) for t in ts]}")
    if packed is not None:
        if tuple(packed.shape) != (PACKED_SIZE,):
            return ValueError(f"packed weights must be ({PACKED_SIZE},), "
                              f"got {tuple(packed.shape)}")
        ts += (packed,)
    for t in ts:
        if t.dtype != torch.bfloat16:
            return TypeError(f"cross_view_pool takes bfloat16, got "
                             f"{t.dtype}")
        if layout and not t.is_contiguous():
            return ValueError("cross_view_pool takes contiguous tensors "
                              "only")
        if layout and t.data_ptr() % 16:
            return ValueError("cross_view_pool takes 16-byte aligned "
                              "tensors")
        if t.device.type != "cuda" or t.device != rgb_feat.device:
            return ValueError(f"cross_view_pool runs on one CUDA device, "
                              f"got {t.device}")
    return None


def takes(rgb_feat: torch.Tensor, neuray_feat: torch.Tensor,
          ray_diff: torch.Tensor, mask: torch.Tensor) -> bool:
    """True when the kernel computes the pool of these inputs: their
    device, dtype, views and widths, whatever their layout (``laid_out``
    gives each the layout the kernel reads)."""
    return _refusal(rgb_feat, neuray_feat, ray_diff, mask,
                    layout=False) is None


def laid_out(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel can read it in place (contiguous and
    16-byte aligned), else a contiguous copy of it in fresh storage (a
    view at an odd offset stays misaligned however contiguous it is)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def cross_view_pool(rgb_feat: torch.Tensor, neuray_feat: torch.Tensor,
                    ray_diff: torch.Tensor, mask: torch.Tensor,
                    packed: torch.Tensor, geometry_only: bool = False
                    ) -> tuple:
    """``pool_reference`` in one launch: (geo (N, 16), rgb (N, 3), nvalid
    (N, 1)), bfloat16; rgb is zeros under ``geometry_only``.  ``packed`` is
    ``pack_pool_weights``' buffer on the inputs' device."""
    refused = _refusal(rgb_feat, neuray_feat, ray_diff, mask, packed)
    if refused is not None:
        raise refused
    from panogrf_tpu_torch.ops.kernels._build import load_library
    lib = load_library()
    n, v, _ = rgb_feat.shape
    geo, rgb, nvalid = (torch.empty(n, c, dtype=torch.bfloat16,
                                    device=rgb_feat.device)
                        for c in (16, 3, 1))
    rc = lib.panogrf_cross_view_pool(
        rgb_feat.data_ptr(), neuray_feat.data_ptr(), ray_diff.data_ptr(),
        mask.data_ptr(), packed.data_ptr(), geo.data_ptr(), rgb.data_ptr(),
        nvalid.data_ptr(), n, v, PACKED_SIZE, int(geometry_only),
        torch.cuda.current_stream(rgb_feat.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cross_view_pool kernel launch failed (CUDA "
                           f"error {rc})")
    launches = fused_mlp.VARIANT_LAUNCHES
    launches["pool_fused"] += 1
    launches[f"pool_fused_v{v}"] += 1
    launches["pool_points"] += n
    return geo, rgb, nvalid
