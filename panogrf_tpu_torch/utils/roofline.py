"""Analytic operations / bytes model of the serving render, priced for the
port's card.

Port of ``panogrf_tpu/utils/roofline.py``: the same FLOP and byte counts of
the two stages the serving frame spends its work in, ``pool_flops``,
``attention_flops``, ``agg_stage``, ``gather_stage``, ``frame_model`` and
``achieved``, which ``tools/bench.py`` feeds with the stages' measured
times:

* the aggregation (pool chain + ray attention) is matmul work: its ceiling
  is the card's peak rate for the compute dtype, and the achieved fraction
  is the MFU;
* the merged-map gathers fetch a few hundred bytes a row: their bytes over
  the HBM rate are a loose floor.  The JAX module's second floor, rows
  times a per-row latency, has no counterpart on the card: there the time
  per row of one call falls as the chunk grows (per-kernel cost, not DRAM
  order), so ``GATHER_NS_PER_ROW`` is None, the latency floor and
  ``gather_latency_model_frac`` are None, and ``tools/bench.py`` reports
  the per-row time measured at its run's own chunk
  (``gather_ns_per_row``).

The peaks are NVIDIA's published dense rates of the NVIDIA H100 SXM5 80 GB
at its 700 W power limit (bf16 on the tensor cores, float32 outside them;
HBM3); a card set to a lower limit reaches less.
"""

from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM5 80 GB, 700 W: dense FLOP/s by compute dtype, HBM bytes/s
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_HBM_BYTES = 3.35e12
# ns per fetched merged-map row: none holds across chunks on the card
# (chip_smoke.py's gather_rows phase times it at two chunks)
GATHER_NS_PER_ROW = None


def _mm(m: int, k: int, n: int) -> int:
    """FLOPs of an (m, k) @ (k, n) matmul (mul + add)."""
    return 2 * m * k * n


@dataclass
class StageCost:
    flops: int
    hbm_bytes: int

    def __add__(self, o: "StageCost") -> "StageCost":
        return StageCost(self.flops + o.flops, self.hbm_bytes + o.hbm_bytes)


def pool_flops(n_points: int, v: int = 2, f: int = 35, nd: int = 32,
               geometry_only: bool = False) -> int:
    """Matmul FLOPs of ``agg_net.pool_reference`` and the prob embed for
    ``n_points`` (ray, sample) points over ``v`` views; base_fc's layer 0
    runs its per-point half once per point, its per-view half per view."""
    N, pv = n_points, n_points * v
    fl = 0
    fl += _mm(pv, nd + 2, nd) + _mm(pv, nd, nd)        # prob_embed
    fl += _mm(pv, 4, 16) + _mm(pv, 16, f)              # ray_dir_fc
    fl += _mm(pv, nd, 8) + _mm(pv, 8, 1)               # neuray_fc
    fl += _mm(N, 4 * f, 64) + _mm(pv, f + nd, 64)      # base_fc layer 0
    fl += _mm(pv, 64, 32)                              # base_fc layer 1
    fl += _mm(pv, 32, 32) + _mm(pv, 32, 33)            # vis_fc
    fl += _mm(pv, 32, 32) + _mm(pv, 32, 1)             # vis_fc2
    fl += _mm(N, 65, 64) + _mm(N, 64, 16)              # geometry_fc
    if not geometry_only:
        fl += _mm(pv, 37, 16) + _mm(pv, 16, 8) + _mm(pv, 8, 1)   # rgb_fc
    return fl


def attention_flops(n_rays: int, dn: int, d_model: int = 16,
                    n_head: int = 4, d_k: int = 4) -> int:
    """Ray attention and sigma head FLOPs for ``n_rays`` rays of ``dn``
    samples."""
    tok = n_rays * dn
    fl = _mm(tok, d_model, 3 * n_head * d_k)          # fused qkv
    fl += 2 * (2 * n_rays * n_head * dn * dn * d_k)   # scores + out
    fl += _mm(tok, n_head * d_k, d_model)             # fc
    fl += _mm(tok, 16, 16) + _mm(tok, 16, 1)          # sigma head
    return fl


def agg_stage(n_rays: int, dn: int, v: int = 2, f: int = 35, nd: int = 32,
              geometry_only: bool = False,
              dtype_bytes: int = 2) -> StageCost:
    """One aggregation pass over n_rays x dn points; its bytes are its
    inputs (rgb 3 + img feats 32 + ray feats nd + dir 3 + stats 5 channels
    per view) and its float32 rgb + sigma outputs."""
    N = n_rays * dn
    fl = pool_flops(N, v, f, nd, geometry_only) + attention_flops(n_rays, dn)
    in_ch = 3 + 32 + nd + 3 + 5
    bytes_ = N * v * in_ch * dtype_bytes + N * 4 * 4
    return StageCost(fl, bytes_)


def gather_stage(n_rays: int, dn: int, stride: int, v: int = 2,
                 row_ch: int = 77, dtype_bytes: int = 2) -> dict:
    """Rows, bytes and the latency floor (None without a per-row time) of
    one pass's merged-map fetches: one bilinear fetch (4 map rows) per
    view at every ``stride``-th sample."""
    fetched = n_rays * ((dn + stride - 1) // stride) * v
    rows = fetched * 4
    bytes_ = rows * row_ch * dtype_bytes
    floor = None if GATHER_NS_PER_ROW is None else tuple(
        rows * ns * 1e-9 for ns in GATHER_NS_PER_ROW)
    return {"rows": rows, "hbm_bytes": bytes_, "latency_floor_s": floor}


def frame_model(h: int, w: int, dn_coarse: int = 64, dn_fine: int = 64,
                stride: int = 4, stride_fine: int = 16, v: int = 2,
                coarse_geometry_only: bool = True,
                lowres_coarse: int = 1,
                dtype: str = "bfloat16") -> dict:
    """Whole-frame counts at the serving operating point; the coarse pass
    runs on (h/f, w/f) rays at ``lowres_coarse`` f.  Feed measured seconds
    to :func:`achieved`."""
    rays = h * w
    crays = rays // (lowres_coarse * lowres_coarse)
    dtb = 2 if dtype == "bfloat16" else 4
    agg = (agg_stage(crays, dn_coarse, v, geometry_only=coarse_geometry_only,
                     dtype_bytes=dtb)
           + agg_stage(rays, dn_fine, v, geometry_only=False,
                       dtype_bytes=dtb))
    g_c = gather_stage(crays, dn_coarse, stride, v, dtype_bytes=dtb)
    g_f = gather_stage(rays, dn_fine, stride_fine, v, dtype_bytes=dtb)
    return {"agg_flops": agg.flops, "agg_hbm_bytes": agg.hbm_bytes,
            "gather_rows": g_c["rows"] + g_f["rows"],
            "gather_hbm_bytes": g_c["hbm_bytes"] + g_f["hbm_bytes"],
            "gather_latency_floor_s": None if g_c["latency_floor_s"] is None
            else tuple(a + b for a, b in zip(g_c["latency_floor_s"],
                                             g_f["latency_floor_s"])),
            "dtype": dtype}


def achieved(model: dict, agg_sec: float, gather_sec: float) -> dict:
    """The stages' measured seconds per frame against the card's peaks
    (``gather_latency_model_frac`` above 1: the fetches beat the row-time
    model; None without one)."""
    peak = PEAK_FLOPS[model["dtype"]]
    floor = model["gather_latency_floor_s"]
    return {
        "agg_mfu": model["agg_flops"] / (agg_sec * peak),
        "agg_hbm_frac": model["agg_hbm_bytes"] / (agg_sec * PEAK_HBM_BYTES),
        "gather_hbm_frac": model["gather_hbm_bytes"]
        / (gather_sec * PEAK_HBM_BYTES),
        "gather_latency_model_frac": None if floor is None
        else tuple(f / gather_sec for f in floor),
    }
