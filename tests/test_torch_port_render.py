"""Whole-slice parity: ``prepare_ref_data`` + ``render_image_device`` of
``panogrf_tpu_torch`` against the JAX pair, on the CPU in float32 (as
``bench.py`` runs on a CPU), for the ``serving`` flags at coarse_lowres 2
and 4 and the ``exact`` flags at coarse_lowres 1.

32x64 render with 32 coarse + 32 fine samples, so the fine gather stride
16 is not clamped; the depth grid is 32x64 (see the module docstring of
test_torch_port_modules.py for why not 16x32).
"""

import numpy as np
import jax
import pytest
import torch

import __graft_entry__ as ge
from panogrf_tpu.renderer import full_render as jfr
from panogrf_tpu.renderer.presets import preset_kwargs as jpreset
from panogrf_tpu.renderer.renderer import NeuralRayGenRenderer as JR
from panogrf_tpu_torch.renderer import full_render as tfr
from panogrf_tpu_torch.renderer.presets import preset_kwargs
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer as TR
from panogrf_tpu_torch.utils.from_jax import load_jax_params
from torch_port_threads import one_torch_thread  # noqa: F401

H, W, DH, DW, DN, CHUNK = 32, 64, 32, 64, 32, 64
# The fine depths are an inverse CDF of the coarse hit probability, which
# amplifies ulp-level differences of the coarse pass; measured max error
# is ~3e-5, the bound leaves room for other BLAS builds.
RGB_ATOL = 1e-3


@pytest.fixture(scope="module")
def scene():
    data = ge._tiny_data(H, W, DH, DW, rn=8)
    init = JR(height=H, width=W, depth_hw=(DH, DW), depth_sample_num=DN,
              fine_depth_sample_num=DN).init
    params = jax.jit(init)(jax.random.PRNGKey(0), data)
    np_params = jax.tree.map(np.asarray, params)
    ref_info = {k: np.array(v) for k, v in data["ref_imgs_info"].items()}
    que = {k: np.array(data["que_imgs_info"][k])
           for k in ("c2w", "depth_range")}
    return params, np_params, ref_info, que


@pytest.mark.parametrize("preset,clr", [("serving", 2), ("serving", 4),
                                        ("exact", 1)])
def test_render_image_device_matches_jax(scene, preset, clr):
    params, np_params, ref_info, que = scene
    common = dict(height=H, width=W, depth_hw=(DH, DW), depth_sample_num=DN,
                  fine_depth_sample_num=DN)
    jm = JR(**common, **jpreset(preset, compute_dtype="float32"))
    jref = jfr.prepare_ref_data(jm, params, ref_info)
    want = np.asarray(jfr.render_image_device(
        jm, params, jref, que["c2w"], que["depth_range"],
        ref_info["depth_range"], chunk=CHUNK, coarse_lowres=clr))

    tm = TR(**common, **preset_kwargs(preset, compute_dtype="float32"),
            device="cpu")
    load_jax_params(tm, np_params)
    tref = tfr.prepare_ref_data(tm, ref_info, device="cpu")
    got = tfr.render_image_device(tm, tref, que["c2w"], que["depth_range"],
                                  ref_info["depth_range"], chunk=CHUNK,
                                  coarse_lowres=clr, device="cpu")
    assert got.shape == (H, W, 3) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=RGB_ATOL, rtol=0)


def test_chunking_is_pure_blocking(scene):
    _, np_params, ref_info, que = scene
    tm = TR(height=H, width=W, depth_hw=(DH, DW), depth_sample_num=DN,
            fine_depth_sample_num=DN,
            **preset_kwargs("serving", compute_dtype="float32"),
            device="cpu")
    load_jax_params(tm, np_params)
    ref = tfr.prepare_ref_data(tm, ref_info, device="cpu")
    args = (que["c2w"], que["depth_range"], ref_info["depth_range"])
    a = tfr.render_image_device(tm, ref, *args, chunk=64, coarse_lowres=2,
                                device="cpu")
    b = tfr.render_image_device(tm, ref, *args, chunk=256, coarse_lowres=2,
                                coarse_chunk=128, device="cpu")
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    with pytest.raises(ValueError):
        tfr.render_image_device(tm, ref, *args, chunk=100, device="cpu")
