"""Named operating points of the renderer (copy of
``panogrf_tpu/renderer/presets.py``, which the port may not import).

* ``exact``   — reference numerics: float32, per-map gathers, the
  per-sample dist-decoder MLPs, full coarse pass.
* ``serving`` — fast gather + bfloat16 + depth-major rows + gather stride 4
  (fine 16) + decode-on-map + coarse RGB head skipped, with the coarse pass
  on an (H/2, W/2) ray grid (``PRESET_COARSE_LOWRES``).
* ``turbo``   — serving with the coarse pass at (H/4, W/4).

Speed figures for these points on the port's hardware are in ``PERF.md``.
"""

from __future__ import annotations

PRESETS: dict = {
    "exact": dict(
        fast_gather=False,
        compute_dtype="float32",
        gather_depth_major=False,
        gather_stride=1,
        gather_stride_fine=0,
        decode_on_map=False,
        coarse_geometry_only=False,
    ),
    "serving": dict(
        fast_gather=True,
        compute_dtype="bfloat16",
        gather_depth_major=True,
        gather_stride=4,
        gather_stride_fine=16,
        decode_on_map=True,
        coarse_geometry_only=True,
    ),
    # turbo shares serving's model flags; the presets differ only in the
    # render-path coarse_lowres factor below
    "turbo": dict(
        fast_gather=True,
        compute_dtype="bfloat16",
        gather_depth_major=True,
        gather_stride=4,
        gather_stride_fine=16,
        decode_on_map=True,
        coarse_geometry_only=True,
    ),
}

# rays per chunk of the render loop
PRESET_CHUNK = {"exact": 128, "serving": 256, "turbo": 256}

# ray-chunk size of the low-res coarse pass only (0 = same as the chunk)
PRESET_COARSE_CHUNK = {"exact": 0, "serving": 0, "turbo": 0}

# render-path knob (an argument of full_render.render_image_device): the
# coarse importance pass runs on an (H/f, W/f) ray grid
PRESET_COARSE_LOWRES = {"exact": 1, "serving": 2, "turbo": 4}


def preset_kwargs(name: str, **overrides) -> dict:
    """Renderer kwargs for a named preset; overrides whose value is None
    are dropped."""
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r}; "
                         f"choose from {sorted(PRESETS)}")
    kw = dict(PRESETS[name])
    for k, v in overrides.items():
        if v is not None:
            kw[k] = v
    return kw
