"""Port parity for the renderer's other modes: the replica / residential /
coffee_area sphere conventions, nearest sampling and the ``zeros`` pad
mode, the ``use_vis`` head, perspective rays, the light coarse pass's
projection, ``merge_composites``, the nearest merged-map gather,
``depth2normal`` and the SH solver, DINER's depth-guided sampler, the
renderer's chunks and frames under these modes, one DINER training step,
the cube-face cameras and tracer, ``render_cubes`` and ``ab_quality``
(CPU, float32 unless a mode is bfloat16), and the repair of
``decode_on_map`` without fine heads.

Shapes: 32x64 render, 32x64 depth, 16 samples (the tools' own counts for
the tools), 2 reference views of a procedural 3-view scene.  Weights are
random numpy draws on the JAX package's parameter tree (a shape-only
``init``) carried into the port by ``load_jax_params``.

Tolerances: geometry, sampling, normals, the SH solver and
``merge_composites`` 1e-5; chunk outputs and frames 1e-4; a DINER
training step's loss 1e-4 relative and each gradient 1e-3 of its
parameter's largest (plus 1e-6 of the tree's largest), the JAX step in
float64 at its float32 draws (``test_torch_port_mv.py``); tool metrics of
float32 modes 5e-3 dB and 1e-3 SSIM (a whole frame's seam pixels, below),
of bfloat16 modes 2e-2 dB and 2e-3 SSIM (the two packages also round
bfloat16 products differently).  The cameras sit on one axis, so in a
whole frame the border rows and columns and the middle column have points
on another view's longitude seam, where the two packages' roundings may
fetch pixels a column apart: frames are compared off those pixels, rays
are drawn off them (``off_seam_coords``).  A pass is compared from JAX's
``prepare_ref`` maps (the port's held to them within 5e-4: the encoders'
summation orders differ), since a fine sample in a bin of near-zero mass
moves far for a small change of its coarse pass; the rays whose fine
samples that change moves by more than 1e-4 are held to 1e-3 and counted
(``ill_conditioned_rays``, ``test_torch_port_ft.py``'s measure).

DINER's shortlist is discontinuous: a candidate whose validity
(|mu - depth| against 0.05) is within rounding of flipping, or a tie at
the kept shortlist's boundary, can select differently in two float32
evaluations.  ``diner.ambiguous_rays`` flags those rays from a float64
evaluation; every other ray is held to the tolerance above (DINER's
samples to 1e-6 relative), and the flagged count is asserted small.
"""

import runpy
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from panogrf_tpu.core import cubemap as jcube
from panogrf_tpu.core import sphere as jsphere
from panogrf_tpu.data import database as jdb
from panogrf_tpu.data import imgs_info as jinfo
from panogrf_tpu.data import online as jonline
from panogrf_tpu.data import shards as jshards
from panogrf_tpu.data import synthetic as jsyn
from panogrf_tpu.ops import resample as jres
from panogrf_tpu.renderer import diner as jdiner
from panogrf_tpu.renderer import dist_decoder as jdd
from panogrf_tpu.renderer import full_render as jfr
from panogrf_tpu.renderer import render_ops as jro
from panogrf_tpu.renderer import sph_solver as jsph
from panogrf_tpu.renderer.renderer import NeuralRayGenRenderer as JR
from panogrf_tpu.train import losses as jl
from panogrf_tpu.train import metrics as jm
from panogrf_tpu.utils.torch_convert import convert_renderer
from panogrf_tpu_torch.core import sphere as tsphere
from panogrf_tpu_torch.data import database as tdb
from panogrf_tpu_torch.data import imgs_info as tinfo
from panogrf_tpu_torch.data import synthetic as tsyn
from panogrf_tpu_torch.ops import resample as tres
from panogrf_tpu_torch.renderer import diner as tdiner
from panogrf_tpu_torch.renderer import dist_decoder as tdd
from panogrf_tpu_torch.renderer import full_render as tfr
from panogrf_tpu_torch.renderer import render_ops as tro
from panogrf_tpu_torch.renderer import sph_solver as tsph
from panogrf_tpu_torch.renderer.presets import preset_kwargs as tpreset
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer as TR
from panogrf_tpu_torch.tools import ab_quality, render_cubes
from panogrf_tpu_torch.train import trainer as ttr
from panogrf_tpu_torch.utils.from_jax import load_jax_params
from torch_port_parity import (OUT_TOL, f32_uniform, inject_uniform,
                               off_seam_coords, template_init, to_f64,
                               to_torch)
from torch_port_threads import one_torch_thread  # noqa: F401

H, W, DH, DW, DN, RN = 32, 64, 32, 64, 16, 64
REPO = __import__("pathlib").Path(__file__).resolve().parents[1]
GEO_TOL = dict(atol=1e-5, rtol=1e-5)
NEAR, FAR = 0.5, 15.0


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# shared inputs: one scene, random weights on the JAX parameter tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    """A 3-view procedural scene (numpy), its renderer sample at RN
    off-seam rays and the references' depth as their MVS depth."""
    s = {k: v.numpy() for k, v in tsyn.make_three_view_sample(
        tsyn.SphereScene.random(5), H, W, seed=5).items()}
    coords = off_seam_coords(np.random.default_rng(5), RN, H, W)
    data = jinfo.build_render_sample(s, jnp.asarray(coords))
    data.pop("src_imgs_info")
    data["ref_imgs_info"]["mvs_depth"] = jnp.asarray(
        s["depth_panos"][list(jinfo.REF_IDS)])
    return s, jax.tree.map(np.asarray, data)


def _random_leaf(path, leaf, rng):
    name = jax.tree_util.keystr(path)
    if name.endswith("['scale']"):
        return (1.0 + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
    if len(leaf.shape) <= 1:
        return (0.05 * rng.normal(size=leaf.shape)).astype(np.float32)
    fan_in = int(np.prod(leaf.shape[:-1]))
    return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(np.float32)


@pytest.fixture(scope="module")
def params(scene):
    """{"full": hierarchical, "vis": with the vis heads, "nofine": without
    the fine heads}: random draws on the JAX tree (shape-only init); a
    positive density bias gives every pass density."""
    _, data = scene
    model = JR(height=H, width=W, depth_hw=(DH, DW), depth_sample_num=DN,
               fine_depth_sample_num=DN)
    tree = template_init(model, jax.random.PRNGKey(0),
                         jax.tree.map(jnp.asarray, data))
    rng = np.random.default_rng(11)
    p = jax.tree_util.tree_map_with_path(
        lambda path, leaf: _random_leaf(path, leaf, rng), tree)["params"]
    for n in ("agg_net", "fine_agg_net"):
        p[n]["agg_impl"]["out_geometry_fc"]["b1"] = np.full((1,), 0.5,
                                                            np.float32)
    vis = jax.tree.map(lambda a: a, p)
    for n in ("dist_decoder", "fine_dist_decoder"):
        vis[n]["vis_decoder"] = jax.tree.map(
            lambda a: _random_leaf((), a, rng) if a.ndim > 1
            else (0.05 * rng.normal(size=a.shape)).astype(np.float32),
            p[n]["aw_decoder"])
    nofine = {k: v for k, v in p.items() if not k.startswith("fine_")}
    return {"full": {"params": p}, "vis": {"params": vis},
            "nofine": {"params": nofine}}


def _jit(fn, *args):
    """``fn`` of JAX arrays run as one compiled program (op-by-op dispatch
    compiles every primitive on its own); returns numpy."""
    return jax.tree.map(np.asarray, jax.jit(fn)(*args))


def _port(kw, params):
    return load_jax_params(TR(**kw, device="cpu"), params).eval()


# ---------------------------------------------------------------------------
# 1. sphere conventions
# ---------------------------------------------------------------------------

def _convention_outputs(conv, xy, pts, lib):
    """Every function of a convention on pixel coords ``xy`` and camera
    points ``pts``, through ``lib`` (jnp or torch)."""
    out = {}
    for mode in ("corner", "center"):
        sph = conv.equi_to_spherical(xy, H, W, 2.0, mode)
        out[f"sph_{mode}"] = sph
        for n in (2, 3):
            out[f"cart{n}_{mode}"] = conv.spherical_to_cartesian(sph[..., :n])
        out[f"equi_{mode}"] = conv.spherical_to_equi(sph, H, W, mode)
    out["cart2sph"] = conv.cartesian_to_spherical(pts)
    out["prj_xy"], out["prj_d"] = conv.project_to_pixels(pts, H, W)
    out["rays"] = conv.ray_directions(H, W)
    out["grid"] = conv.pixel_grid(H, W)
    return out


@pytest.mark.parametrize("name", ["replica_test", "residential",
                                  "coffee_area", "CoffeeArea"])
def test_convention_matches_jax(name):
    """Every function of the convention, pixel mode and radius form, on
    points off the seam and the poles (the pixel round trip is smooth
    there)."""
    jc, tc = jsphere.get_convention(name), tsphere.get_convention(name)
    assert tc.name == jc.name
    rng = np.random.default_rng(1)
    xy = np.stack([rng.uniform(0.3, W - 1.3, 200),
                   rng.uniform(0.3, H - 1.3, 200)], -1).astype(np.float32)
    pts = np.asarray(jc.spherical_to_cartesian(
        jc.equi_to_spherical(jnp.asarray(xy), H, W, 3.0)))
    pts = (pts + 0.01 * rng.normal(size=pts.shape)).astype(np.float32)
    want = jax.jit(lambda a, b: _convention_outputs(jc, a, b, jnp))(xy, pts)
    got = _convention_outputs(tc, torch.tensor(xy), torch.tensor(pts), torch)
    assert want.keys() == got.keys()
    for k in want:
        tol = dict(atol=1e-4) if k in ("equi_corner", "equi_center",
                                       "prj_xy") else GEO_TOL
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), **tol,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# 2. resampling: nearest taps, the zeros pad mode and its gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wrap_x", [True, False])
def test_nearest_sample_matches_jax(wrap_x):
    rng = np.random.default_rng(2)
    img = rng.normal(size=(6, 9, 4)).astype(np.float32)
    xy = np.concatenate([rng.uniform(-3, 12, size=(200, 2)),
                         [[8.5, 2.5], [-0.5, 1.5], [9.0, 6.0]]]) \
        .astype(np.float32)
    # and multi-view, rescaled to a map of another size
    feats = rng.normal(size=(2, 8, 16, 5)).astype(np.float32)
    pts = rng.uniform(0, 31, size=(2, 40, 2)).astype(np.float32)
    want = jax.jit(lambda *a: (
        jres.nearest_sample(a[0], a[1], wrap_x=wrap_x),
        jres.interpolate_feats_pointmajor(a[2], a[3], 32, 64,
                                          nearest=True)))(img, xy, feats, pts)
    got = (tres.nearest_sample(torch.tensor(img), torch.tensor(xy),
                               wrap_x=wrap_x),
           tres.interpolate_feats_pointmajor(
               torch.tensor(feats), torch.tensor(pts), 32, 64, nearest=True))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


@pytest.mark.parametrize("wrap_x", [True, False])
def test_zeros_pad_mode_and_its_gradient_match_jax(wrap_x):
    rng = np.random.default_rng(3)
    img = rng.normal(size=(6, 9, 4)).astype(np.float32)
    xy = np.concatenate([rng.uniform(-3, 12, size=(200, 2)),
                         [[2.0, -1.0], [3.5, 6.0], [-1.0, 2.0], [9.0, 2.5]]]
                        ).astype(np.float32)
    cot = rng.normal(size=(xy.shape[0], 4)).astype(np.float32)

    def jf(im, p):
        out = jres.bilinear_sample(im, p, wrap_x=wrap_x, pad_mode="zeros")
        return jnp.sum(out * cot), out
    (_, want), (gi, gp) = jax.jit(jax.value_and_grad(
        jf, (0, 1), has_aux=True))(jnp.asarray(img), jnp.asarray(xy))
    ti = torch.tensor(img, requires_grad=True)
    tp = torch.tensor(xy, requires_grad=True)
    got = tres.bilinear_sample(ti, tp, wrap_x=wrap_x, pad_mode="zeros")
    torch.sum(got * torch.tensor(cot)).backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), **GEO_TOL)
    assert (_np(got)[np.asarray(want) == 0] == 0).all()
    np.testing.assert_allclose(_np(ti.grad), np.asarray(gi), **GEO_TOL)
    np.testing.assert_allclose(_np(tp.grad), np.asarray(gp), atol=1e-4)


# ---------------------------------------------------------------------------
# 3-4. the vis head, perspective rays, the stats projection, merging
# ---------------------------------------------------------------------------

def test_vis_decoder_and_compute_prob_match_jax(params):
    p = params["vis"]["params"]["dist_decoder"]
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(2, 5, 7, 2, 32)).astype(np.float32)
    rng2 = np.random.default_rng(40)
    near = rng2.uniform(0, 1, size=(2, 5, 7, 2)).astype(np.float32)
    far = near + 0.05

    def jf(feats, near, far):
        heads = jdd.MixtureLogisticsDistDecoder(use_vis=True).apply(
            {"params": p}, feats)
        m, v, vis, aw = heads
        return heads, jdd.compute_prob(near, far, m, v, vis, aw, True)
    (jmean, jvar, jvis, jaw), want = _jit(jf, feats, near, far)
    dec = _port(dict(height=H, width=W, depth_hw=(DH, DW), use_vis=True),
                params["vis"]).dist_decoder
    tf = torch.tensor(feats)
    tmean, tvar, taw = dec(tf)
    tvis = dec.decode_vis(tf)
    for a, b in ((tmean, jmean), (tvar, jvar), (taw, jaw), (tvis, jvis)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **OUT_TOL)
    got = tdd.compute_prob(torch.tensor(near), torch.tensor(far), tmean,
                           tvar, taw, tvis)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), **OUT_TOL)


def test_perspective_rays_match_jax():
    rng = np.random.default_rng(5)
    k = np.stack([tdb.cube_intrinsics(16), tdb.cube_intrinsics(24)])
    rot = np.linalg.qr(rng.normal(size=(2, 3, 3)))[0].astype(np.float32)
    w2c = np.concatenate([rot, rng.normal(size=(2, 3, 1))], -1) \
        .astype(np.float32)
    coords = rng.uniform(0, 16, size=(2, 9, 2)).astype(np.float32)
    depth = np.sort(rng.uniform(0.5, 9, size=(2, 9, 5)), -1) \
        .astype(np.float32)
    a = _jit(jro.depth2points_perspective, coords, depth, w2c, k)
    b = tro.depth2points_perspective(*map(torch.tensor,
                                          (coords, depth, w2c, k)))
    for x, y in zip(b, a):
        np.testing.assert_allclose(_np(x), np.asarray(y), **GEO_TOL)
    # the ray through the principal point is the camera's optical axis
    c, d = tro.coords2rays_perspective(
        torch.tensor([[[7.5, 7.5]]]), torch.tensor(np.eye(3, 4)[None],
                                                   dtype=torch.float32),
        torch.tensor(k[:1]))
    np.testing.assert_allclose(_np(d[0, 0] / d[0, 0].norm()), [0, 0, 1],
                               atol=1e-6)


def _ref_maps(rng, rfn=2, c=6):
    w2c = np.stack([np.eye(3, 4), np.concatenate(
        [np.eye(3), [[0.3], [0.1], [0.5]]], 1)]).astype(np.float32)
    return {"imgs": rng.uniform(size=(rfn, H, W, 3)).astype(np.float32),
            "stats_coarse": rng.uniform(size=(rfn, H, W, c))
            .astype(np.float32), "w2c": w2c}


def test_project_stats_matches_jax():
    rng = np.random.default_rng(6)
    ref = _ref_maps(rng)
    pts = (rng.normal(size=(1, 7, 5, 3)) * 3).astype(np.float32)
    a = _jit(lambda r, p: jro.project_stats(r, p, jsphere.M3D), ref, pts)
    b = tro.project_stats(to_torch(ref), torch.tensor(pts), tsphere.M3D)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(_np(b[k]), np.asarray(a[k]), atol=1e-4)


def test_merge_composites_matches_jax():
    """Equal depths in the two passes keep pass a's sample first (JAX's
    stable sort): the colours then differ in order only where they tie."""
    rng = np.random.default_rng(7)
    za = np.sort(rng.uniform(1, 9, size=(1, 6, 8)), -1).astype(np.float32)
    zb = np.sort(rng.uniform(1, 9, size=(1, 6, 5)), -1).astype(np.float32)
    zb[..., 2] = za[..., 3]                       # exact ties
    ca = rng.uniform(size=(1, 6, 8, 3)).astype(np.float32)
    cb = rng.uniform(size=(1, 6, 5, 3)).astype(np.float32)
    da = rng.uniform(0, 2, size=(1, 6, 8)).astype(np.float32)
    db = rng.uniform(0, 2, size=(1, 6, 5)).astype(np.float32)
    a = _jit(jro.merge_composites, za, ca, da, zb, cb, db)
    b = tro.merge_composites(*map(torch.tensor, (za, ca, da, zb, cb, db)))
    for x, y in zip(b[:3], a[:3]):
        np.testing.assert_allclose(_np(x), np.asarray(y), **GEO_TOL)
    for k in a[3]:
        np.testing.assert_allclose(_np(b[3][k]), np.asarray(a[3][k]),
                                   **GEO_TOL)


@pytest.mark.parametrize("stride", [1, 4])
def test_nearest_merged_gather_matches_jax(stride):
    rng = np.random.default_rng(8)
    ref = {"imgs": rng.uniform(size=(2, H, W, 3)),
           "ray_feats": rng.normal(size=(2, 8, 16, 32)),
           "img_feats": rng.normal(size=(2, 16, 32, 16)),
           "merged_full": rng.normal(size=(2, H, W, 51)),
           "w2c": _ref_maps(rng)["w2c"]}
    ref = {k: v.astype(np.float32) for k, v in ref.items()}
    pts = (rng.normal(size=(1, 6, 8, 3)) * 3).astype(np.float32)
    qdir = rng.normal(size=(1, 6, 8, 3)).astype(np.float32)
    a = _jit(lambda r, p, q: jro.project_points_dict(
        r, p, jsphere.M3D, que_dir=q, gather_stride=stride,
        gather_nearest=True), ref, pts, qdir)
    b = tro.project_points_dict(to_torch(ref), torch.tensor(pts),
                                tsphere.M3D, torch.tensor(qdir),
                                gather_stride=stride, gather_nearest=True)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(_np(b[k]), np.asarray(a[k]), atol=1e-4,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# 5. normals and the SH solver
# ---------------------------------------------------------------------------

def test_depth2normal_and_sh_solver_match_jax(scene):
    s, _ = scene
    depth = s["depth_panos"][:2].copy()
    depth[0, 3:5, 7:9] = 0.0
    # the last row is the south pole, where sin(pi) rounds to -8.7e-8: its
    # left and right neighbours differ by rounding only, so its normal is
    # float noise in both packages
    np.testing.assert_allclose(
        _np(tsph.depth2normal(torch.tensor(depth), tsphere.M3D))[:, :-1],
        _jit(lambda d: jsph.depth2normal(d, jsphere.M3D), depth)[:, :-1],
        **GEO_TOL)
    rng = np.random.default_rng(9)
    dirs = rng.normal(size=(3, 40, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)) \
        .astype(np.float32)
    colors = rng.uniform(size=(3, 40, 3)).astype(np.float32)
    weights = rng.uniform(size=(3, 40)).astype(np.float32)
    weights[1] = 0.0                                # the eps fallback
    for degree in (2, 3, 4):
        js = jsph.SphericalHarmonicsSolver(degree)
        ts = tsph.SphericalHarmonicsSolver(degree)
        ja, jp = _jit(lambda d, c, w: (js(d, c, w), js.predict(d, js(d, c, w))),
                      dirs, colors, weights)
        ta = ts(torch.tensor(dirs), torch.tensor(colors),
                torch.tensor(weights))
        np.testing.assert_allclose(_np(ta), ja, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(_np(ts.predict(torch.tensor(dirs), ta)),
                                   jp, atol=1e-4)


# ---------------------------------------------------------------------------
# 6. DINER's sampler
# ---------------------------------------------------------------------------

def _prj_inputs(seed, rn=64, cn=32, rfn=2, normals=False):
    rng = np.random.default_rng(seed)
    cand = np.asarray(jro.sample_depth(1, rn, cn, NEAR, FAR, False)[0])
    d = cand[None] + rng.normal(0, 0.02, size=(rfn, 1, rn, cn))
    mu = np.where(rng.uniform(size=d.shape) < 0.3,
                  d + rng.normal(0, 0.03, size=d.shape),
                  d + rng.uniform(0.2, 3, size=d.shape))
    prj = {"mu": mu, "depth": d,
           "uncert": rng.uniform(0.002, 0.1, size=d.shape)}
    extra = {}
    if normals:
        nrm = rng.normal(size=(*d.shape, 3))
        prj["normal"] = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
        qd = rng.normal(size=(1, rn, cn, 3))
        extra = {"que_dir": qd / np.linalg.norm(qd, axis=-1, keepdims=True),
                 "w2c": _ref_maps(rng)["w2c"]}
    f32 = lambda t: {k: np.asarray(v, np.float32) for k, v in t.items()}
    return cand, f32(prj), f32(extra)


@pytest.mark.parametrize("n_gaussian,culling", [(0, False), (8, False),
                                                (8, True)])
def test_sample_depthguided_matches_jax(n_gaussian, culling):
    """JAX's draws (its Gaussian tail and, folded in, the fill's jitter)
    handed to the port, and the deterministic sampler; every ray the
    float64 check does not flag selects the same samples."""
    cand, prj, extra = _prj_inputs(10 + n_gaussian, normals=culling)
    key = jax.random.PRNGKey(3)
    n = DN

    def jf(cand, prj, extra):
        return [jdiner.sample_depthguided(cand, prj, n, n_gaussian, NEAR,
                                          FAR, rng=r, **extra)
                for r in (key, None)]
    want = _jit(jf, cand, prj, extra)
    noise = np.asarray(jax.random.normal(key, (1, RN, n_gaussian))) \
        if n_gaussian else None
    jitter = np.asarray(jax.random.uniform(jax.random.fold_in(key, 1),
                                           (1, RN, n)))
    got = [tdiner.sample_depthguided(
        torch.tensor(cand), to_torch(prj), n, n_gaussian, NEAR, FAR,
        noise=None if noise is None else torch.tensor(noise),
        jitter=torch.tensor(jitter), **to_torch(extra)),
        tdiner.sample_depthguided(torch.tensor(cand), to_torch(prj), n,
                                  n_gaussian, NEAR, FAR, **to_torch(extra))]
    f64 = lambda t: {k: torch.tensor(v, dtype=torch.float64)
                     for k, v in t.items()}
    flag = tdiner.ambiguous_rays(torch.tensor(cand, dtype=torch.float64),
                                 f64(prj), n, n_gaussian, NEAR, FAR,
                                 **f64(extra))[0].numpy()
    print(f"flagged rays: {int(flag.sum())} of {flag.size}")
    assert flag.sum() <= 2
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a)[0, ~flag], b[0, ~flag], rtol=1e-6,
                                   atol=1e-6)


def test_fill_uniform_and_project_depth_info_match_jax(scene):
    rng = np.random.default_rng(12)
    z = np.where(rng.uniform(size=(2, 9, 12)) < 0.5, 0.0,
                 rng.uniform(1, 9, size=(2, 9, 12))).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jit = np.asarray(jax.random.uniform(key, z.shape))
    s, data = scene
    ref = {"imgs": data["ref_imgs_info"]["imgs"],
           "w2c": data["ref_imgs_info"]["w2c"],
           "mvs_depth": s["depth_panos"][:2],
           "mvs_uncert": rng.uniform(0.01, 0.1, size=(2, H, W, 1))
           .astype(np.float32),
           "mvs_normal": rng.normal(size=(2, H, W, 3)).astype(np.float32)}
    pts = (rng.normal(size=(1, 5, 7, 3)) * 2).astype(np.float32)
    fill_r, fill_d, a = _jit(lambda z, r, p: (
        jdiner.fill_uniform(z, NEAR, FAR, key),
        jdiner.fill_uniform(z, NEAR, FAR),
        jdiner.project_depth_info(r, p, jsphere.M3D)), z, ref, pts)
    np.testing.assert_allclose(
        _np(tdiner.fill_uniform(torch.tensor(z), NEAR, FAR,
                                jitter=torch.tensor(jit))), fill_r,
        rtol=1e-6)
    np.testing.assert_allclose(
        _np(tdiner.fill_uniform(torch.tensor(z), NEAR, FAR)), fill_d,
        rtol=1e-6)
    b = tdiner.project_depth_info(to_torch(ref), torch.tensor(pts),
                                  tsphere.M3D)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(_np(b[k]), a[k], atol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# 7. the renderer: chunks under each mode, and the decode_on_map repair
# ---------------------------------------------------------------------------

BASE = dict(height=H, width=W, depth_hw=(DH, DW), depth_sample_num=DN,
            fine_depth_sample_num=DN)


def ill_conditioned_rays(depth, hit, fine, hit_other,
                         tol=OUT_TOL["atol"]):
    """(qn, rn) rays with a fine sample whose depth moves by more than
    ``tol`` (+ ``tol`` relative) when the sampler's CDF moves by the two
    packages' difference: the larger of the rounding of a float32
    cumulative sum of dn terms (dn ulps of 1) and the coarse hit
    probabilities' difference ``hit`` - ``hit_other`` summed over the ray.
    A fine depth in a bin of near-zero mass (the CDF's 1e-5 floor) is
    ill-conditioned (``test_torch_port_ft.py``'s measure): in the
    sampler's coordinate x = (1/near - 1/d) / (1/near - 1/far),
    d depth / d cdf = d^2 (1/near - 1/far) (bin width) / (bin mass)."""
    span = 1 / NEAR - 1 / FAR
    x = lambda d: (1 / NEAR - 1 / d) / span
    xd = x(depth)
    bins = np.concatenate([xd[..., :1], (xd[..., 1:] + xd[..., :-1]) / 2,
                           xd[..., -1:]], -1)
    total = (hit + 1e-5).sum(-1, keepdims=True)
    pdf = (hit + 1e-5) / total
    dcdf = np.maximum(depth.shape[-1] * np.finfo(np.float32).eps,
                      np.abs(hit - hit_other).sum(-1, keepdims=True) / total)
    j = (x(fine)[..., :, None] >= bins[..., None, 1:-1]).sum(-1)
    width = np.take_along_axis(np.diff(bins), j, -1)
    mass = np.take_along_axis(pdf, j, -1)
    moved = fine ** 2 * span * width / mass * dcdf
    return (moved > tol + tol * fine).any(-1)


PREP_TOL = dict(atol=5e-4, rtol=5e-4)


def _shared_ref(jref: dict, tref: dict) -> dict:
    """The port's ``prepare_ref`` maps against JAX's (within PREP_TOL:
    the encoders' convolution and reduction orders differ), then JAX's
    maps as tensors, so that a pass's comparison starts from equal maps:
    a fine sample in a bin of near-zero mass moves far for a small change
    of the coarse pass's inputs."""
    assert tref.keys() == jref.keys()
    for k, v in tref.items():
        np.testing.assert_allclose(_np(v), np.asarray(jref[k], np.float32),
                                   **PREP_TOL, err_msg=k)
    return {k: torch.tensor(np.array(v)) for k, v in jref.items()}


def _chunks(kw, params, data, perspec_cam=None):
    """(JAX outputs, port outputs, the rays whose fine samples are
    ill-conditioned) of ``render_rays`` on the sample's rays, both from
    JAX's ``prepare_ref`` maps (the port's are held to them); the JAX
    side as one compiled program."""
    ref, que = data["ref_imgs_info"], data["que_imgs_info"]
    jm = JR(**kw)

    def jf(p, ref, que, cam):
        rd = jm.apply(p, ref["imgs"], ref["mvs_depth"],
                      method=JR.prepare_ref)
        jrd = dict(rd)
        rd["w2c"] = ref["w2c"]
        args = (que["coords"], que["c2w"], que["depth_range"],
                ref["depth_range"])
        out = jm.apply(p, rd, *args, perspec_cam=cam, method=JR.render_rays)
        if kw.get("light_coarse"):
            # the proxy pass's importance, which places the fine samples
            qn, rn, _ = que["coords"].shape
            cd = jro.sample_depth(qn, rn, kw.get("coarse_proxy_samples")
                                  or DN, NEAR, FAR, True)[0]
            out["que_depth"] = cd
            out["hit_prob_nr"] = jm.apply(p, rd, cd, *args, cam,
                                          method=JR.coarse_hit_proxy)
        return jrd, out
    jrd, want = _jit(jf, params, ref, que, perspec_cam)
    tm = _port(kw, params)
    tref, tque = to_torch(ref), to_torch(que)
    with torch.no_grad():
        rd = _shared_ref(jrd, tm.prepare_ref(tref["imgs"],
                                             tref["mvs_depth"]))
        rd["w2c"] = tref["w2c"]
        got = tm.render_rays(
            rd, tque["coords"], tque["c2w"], tque["depth_range"],
            tref["depth_range"], perspec_cam=None if perspec_cam is None
            else tuple(map(torch.tensor, perspec_cam)))
        hit = got["hit_prob_nr"]
        if kw.get("light_coarse"):
            hit = tm.coarse_hit_proxy(rd, torch.tensor(want["que_depth"]),
                                      tque["coords"], tque["c2w"],
                                      tque["depth_range"],
                                      tref["depth_range"])
    ill = None
    if "que_depth_fine" in want:
        ill = ill_conditioned_rays(want["que_depth"], want["hit_prob_nr"],
                                   want["que_depth_fine"], _np(hit))
        if kw.get("light_coarse"):
            for k in ("que_depth", "hit_prob_nr"):
                want[k] = want[k + "_fine"]
    return want, got, ill


ILL_TOL = dict(atol=1e-3, rtol=1e-3)


def _assert_outputs(got, want, ill=None):
    """Every output within OUT_TOL; the rays of ``ill`` (qn, rn) within
    ILL_TOL."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    if ill is not None:
        print(f"ill-conditioned rays: {int(ill.sum())} of {ill.size}")
        assert ill.mean() <= 0.05
    for k in want:
        a, b = _np(got[k]), want[k].astype(np.float32)
        if ill is None:
            np.testing.assert_allclose(a, b, **OUT_TOL, err_msg=k)
            continue
        np.testing.assert_allclose(a[~ill], b[~ill], **OUT_TOL, err_msg=k)
        np.testing.assert_allclose(a[ill], b[ill], **ILL_TOL, err_msg=k)


def test_decode_on_map_without_fine_heads_matches_jax(scene, params):
    """A renderer without fine heads (a DINER-trained checkpoint) under
    fast_gather and decode_on_map decodes only the coarse head onto the
    map and reads the stats' whole width (the JAX package's
    ``prepare_ref`` / ``render_by_depth``)."""
    kw = dict(BASE, use_hierarchical_sampling=False, fast_gather=True,
              decode_on_map=True)
    want, got, _ = _chunks(kw, params["nofine"], scene[1])
    assert "pixel_colors_nr_fine" not in got
    _assert_outputs(got, want)


CHUNK_CASES = {
    # the light coarse pass: stats decoded at full resolution under
    # fast_gather, on the ray features' own grid without it (there with
    # the vis head's channel, 8 proxy samples and the depth spread)
    "light_coarse": dict(fast_gather=True, gather_depth_major=True,
                         gather_stride=4, light_coarse=True),
    "light_coarse_vis": dict(light_coarse=True, coarse_proxy_samples=8,
                             use_vis=True, render_uncert=True),
    # the nearest merged-map gather with strides, and the vis heads
    # decoded onto the map
    "nearest_vis_map": dict(fast_gather=True, gather_depth_major=True,
                            gather_stride=2, gather_stride_fine=4,
                            gather_nearest=True, decode_on_map=True,
                            use_vis=True),
    # the vis heads in the per-sample path
    "use_vis_exact": dict(use_vis=True, render_uncert=True),
}


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunk_matches_jax(scene, params, case):
    kw = dict(BASE, **CHUNK_CASES[case])
    want, got, ill = _chunks(
        kw, params["vis" if kw.get("use_vis") else "full"], scene[1])
    _assert_outputs(got, want, ill)
    if kw.get("light_coarse"):
        # the fine pass's outputs under both key families
        assert torch.equal(got["pixel_colors_nr"],
                           got["pixel_colors_nr_fine"])


# ---------------------------------------------------------------------------
# 8. DINER frames through render_image_device
# ---------------------------------------------------------------------------

DINER_FLAGS = dict(BASE, **tpreset("serving", compute_dtype="float32",
                                   coarse_geometry_only=False))
DINER_CASES = {"diner": dict(n_candidates=64),
               "diner_mu8": dict(n_candidates=64, n_uniform=8),
               "diner_cu8": dict(n_candidates=64, contain_uniform=8)}
FRAME_CHUNK = 512


@pytest.fixture(scope="module")
def diner_refs(scene, params):
    """The serving flags in float32 with the coarse colour head (bench.py's
    DINER setup): both packages' reference data, with mvs_uncert 0.04."""
    s, data = scene
    ref = data["ref_imgs_info"]
    jm = JR(**DINER_FLAGS)
    jref = jfr.prepare_ref_data(jm, params["full"], ref)
    tm = _port(DINER_FLAGS, params["full"])
    tref = _shared_ref(jref, tfr.prepare_ref_data(tm, ref, device="cpu"))
    uncert = np.full_like(ref["mvs_depth"], 0.04)
    jref["mvs_depth"], jref["mvs_uncert"] = ref["mvs_depth"], uncert
    tref["mvs_uncert"] = torch.tensor(uncert)
    return jm, jref, tm, tref


def off_seam_pixels() -> np.ndarray:
    """(H, W) pixels off the border and the middle column: the cameras sit
    on one axis, so there a view's points lie on another view's longitude
    seam, where the two packages' roundings may fetch pixels a column
    apart (``torch_port_parity.off_seam_coords``)."""
    ok = np.ones((H, W), bool)
    ok[[0, H - 1]] = False
    ok[:, [0, W - 1, W // 2 - 1, W // 2, W // 2 + 1]] = False
    return ok


def diner_frame_flags(tm, ref: dict, c2w, n_candidates: int) -> np.ndarray:
    """(H, W) pixels whose DINER samples float rounding may change
    (``diner.ambiguous_rays`` on a float64 evaluation)."""
    f64 = lambda t: torch.as_tensor(np.asarray(t), dtype=torch.float64)
    coords = tinfo.full_image_coords(H, W).double()
    cand = tro.sample_depth(1, H * W, n_candidates, NEAR, FAR, False)[0] \
        .double()
    pts, _ = tro.depth2points_spherical(coords, cand, f64(c2w),
                                        tm.directions.double())
    prj = tdiner.project_depth_info(
        {"imgs": f64(ref["imgs"]), "w2c": f64(ref["w2c"]),
         "mvs_depth": f64(ref["mvs_depth"]),
         "mvs_uncert": torch.full_like(f64(ref["mvs_depth"]), 0.04)},
        pts, tsphere.M3D)
    return tdiner.ambiguous_rays(cand, prj, DN, 8, NEAR, FAR)[0] \
        .reshape(H, W).numpy()


@pytest.mark.parametrize("case", sorted(DINER_CASES))
def test_diner_frame_matches_jax(scene, params, diner_refs, case):
    s, data = scene
    jm, jref, tm, tref = diner_refs
    que, dr = data["que_imgs_info"], data["ref_imgs_info"]["depth_range"]
    kw = DINER_CASES[case]
    want = np.asarray(jfr.render_image_device(
        jm, params["full"], jref, que["c2w"], que["depth_range"], dr,
        chunk=FRAME_CHUNK, mode="diner", **kw))
    got = tfr.render_image_device(tm, tref, que["c2w"], que["depth_range"],
                                  dr, chunk=FRAME_CHUNK, mode="diner",
                                  device="cpu", **kw)
    flag = diner_frame_flags(tm, data["ref_imgs_info"], que["c2w"],
                             kw["n_candidates"])
    print(f"{case}: flagged pixels {int(flag.sum())} of {flag.size}")
    assert flag.mean() <= 0.01
    assert got.shape == (H, W, 3) and torch.isfinite(got).all()
    held = off_seam_pixels() & ~flag
    np.testing.assert_allclose(_np(got)[held], want[held], **OUT_TOL)


def test_diner_needs_uncertainty_and_lowres_needs_coarse(diner_refs,
                                                         scene):
    _, _, tm, tref = diner_refs
    que = scene[1]["que_imgs_info"]
    args = (que["c2w"], que["depth_range"],
            scene[1]["ref_imgs_info"]["depth_range"])
    with pytest.raises(KeyError, match="mvs_uncert"):
        tfr.render_image_device(
            tm, {k: v for k, v in tref.items() if k != "mvs_uncert"}, *args,
            chunk=FRAME_CHUNK, mode="diner", device="cpu")
    with pytest.raises(ValueError, match="coarse_lowres"):
        tfr.render_image_device(tm, tref, *args, chunk=FRAME_CHUNK,
                                mode="diner", coarse_lowres=2, device="cpu")
    with pytest.raises(ValueError, match="sampling_mode"):
        TR(**BASE, sampling_mode="uniform", device="cpu")


# ---------------------------------------------------------------------------
# 9. one DINER training step against jax.grad
# ---------------------------------------------------------------------------

DINER_TRAIN = dict(BASE, sampling_mode="diner", use_hierarchical_sampling=False,
                   diner_n_candidates=64, diner_n_uniform=8,
                   gather_depth_major=True)


def _f32_normal(mp):
    """Under ``jax.enable_x64``: JAX's normal draws in float32 (then
    float64), so both packages sample the same Gaussian tail."""
    draw = jax.random.normal

    def normal(key, shape=(), dtype=None, *args, **kw):
        return draw(key, shape, jnp.float32, *args, **kw).astype(jnp.float64)
    mp.setattr(jax.random, "normal", normal)


@pytest.fixture(scope="module")
def diner_step(scene, params):
    """JAX value_and_grad, in float64, of the render + depth loss of the
    DINER recipe (no fine heads, a separate 8-sample uniform pass merged),
    with JAX's float32 draws: the Gaussian tail and the fill's jitter."""
    _, data = scene
    model = JR(**DINER_TRAIN)
    key = jax.random.PRNGKey(7)
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        f32_uniform(mp)
        _f32_normal(mp)
        data64 = to_f64(data)

        def loss_fn(p):
            out = model.apply(p, data64, rng=key)
            terms = {**jl.render_loss(out, data64),
                     **jl.depth_loss(out, data64)}
            return jl.total_loss(terms), (out, terms)
        (loss, (out, terms)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(to_f64(params["nofine"]))
        draws = [np.asarray(jax.random.normal(key, (1, RN, 8)), np.float32),
                 np.asarray(jax.random.uniform(jax.random.fold_in(key, 1),
                                               (1, RN, DN)), np.float32)]
    return dict(loss=float(loss), out=jax.tree.map(np.asarray, out),
                terms=jax.tree.map(np.asarray, terms),
                grads=jax.tree.map(np.asarray, grads["params"]), draws=draws)


def _port_diner_step(monkeypatch, scene, params, draws):
    noise, jitter = draws
    queue = inject_uniform(monkeypatch, [jitter])
    normals = [noise]
    monkeypatch.setattr(tro, "normal", lambda g, shape, device=None:
                        torch.tensor(normals.pop(0)).to(device))
    model = _port(DINER_TRAIN, params["nofine"]).train()
    data = to_torch(scene[1])
    loss_fn = ttr.make_loss_fn(ttr.TrainerConfig(losses=("render",
                                                         "depth")))
    out = model(data, torch.Generator())
    loss, terms = loss_fn(out, data)
    loss.backward()
    assert not queue and not normals
    return model, out, loss, terms


def test_diner_training_step_matches_jax_grad(monkeypatch, scene, params,
                                              diner_step):
    """The DINER recipe's forward, loss terms and every parameter's
    gradient; no ray of the step is flagged as ambiguous."""
    _, data = scene
    ref = data["ref_imgs_info"]
    f64 = lambda t: torch.tensor(np.asarray(t), dtype=torch.float64)
    cand = tro.sample_depth(1, RN, 64, NEAR, FAR, False)[0].double()
    tm = _port(DINER_TRAIN, params["nofine"])
    pts, _ = tro.depth2points_spherical(
        f64(data["que_imgs_info"]["coords"]), cand,
        f64(data["que_imgs_info"]["c2w"]), tm.directions.double())
    prj = tdiner.project_depth_info(
        {"imgs": f64(ref["imgs"]), "w2c": f64(ref["w2c"]),
         "mvs_depth": f64(ref["mvs_depth"]),
         "mvs_uncert": torch.full_like(f64(ref["mvs_depth"]), 0.04)},
        pts, tsphere.M3D)
    assert not tdiner.ambiguous_rays(cand, prj, DN, 8, NEAR, FAR).any()

    model, out, loss, terms = _port_diner_step(monkeypatch, scene, params,
                                               diner_step["draws"])
    want = diner_step["out"]
    assert set(out) == set(want)
    assert "que_depth_fine" in out and "fine_dist_decoder" not in dict(
        model.named_children())
    for k in want:
        np.testing.assert_allclose(_np(out[k]), want[k].astype(np.float32),
                                   **OUT_TOL, err_msg=k)
    assert set(terms) == set(diner_step["terms"])
    for k, v in diner_step["terms"].items():
        np.testing.assert_allclose(_np(terms[k]), v, **OUT_TOL, err_msg=k)
    assert abs(loss.item() - diner_step["loss"]) <= 1e-4 * abs(
        diner_step["loss"])
    got = convert_renderer({n: p.grad.numpy() for n, p in
                            model.named_parameters()})["params"]
    flat = lambda t: {jax.tree_util.keystr(k): v for k, v in
                      jax.tree_util.tree_leaves_with_path(t)}
    got, want_g = flat(got), flat(diner_step["grads"])
    assert got.keys() == want_g.keys()
    atol = 1e-6 * max(np.abs(v).max() for v in want_g.values())
    for k, a in want_g.items():
        np.testing.assert_allclose(got[k], a, rtol=0,
                                   atol=1e-3 * np.abs(a).max() + atol,
                                   err_msg=k)


def test_weights_round_trip_with_vis_and_without_fine(params):
    """``load_jax_params`` -> ``state_dict`` -> ``convert_renderer`` gives
    back the JAX tree, with the vis heads and without the fine heads."""
    for name, kw in (("vis", dict(use_vis=True)),
                     ("nofine", dict(use_hierarchical_sampling=False))):
        sd = {k: v.numpy() for k, v in
              _port(dict(BASE, **kw), params[name]).state_dict().items()}
        back = convert_renderer(sd)["params"]
        flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                          jax.tree_util.tree_leaves_with_path(t)}
        a, b = flat(back), flat(params[name]["params"])
        assert a.keys() == b.keys(), name
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# 10-11. cube cameras and cube faces
# ---------------------------------------------------------------------------

def test_cube_cameras_and_faces_match_jax(scene):
    s, _ = scene
    np.testing.assert_array_equal(tdb.cube_intrinsics(16),
                                  jdb.cube_intrinsics(16))
    np.testing.assert_array_equal(tdb.cube_face_rotations(),
                                  jdb.cube_face_rotations())
    args = [s[k] for k in ("rgb_panos", "depth_panos", "rots", "trans")]
    for a, b in zip(tdb.PanoDatabase("m3d", *args).cube_cameras(1),
                    jdb.PanoDatabase("m3d", *args).cube_cameras(1)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    tscene = tsyn.SphereScene.random(5)
    jscene = jsyn.SphereScene.random(5)
    rot = np.linalg.qr(np.random.default_rng(13).normal(size=(3, 3)))[0] \
        .astype(np.float32)
    pos = np.asarray([0.2, -0.1, 0.3], np.float32)
    want = jsyn.render_cube_faces(jscene, pos, rot, 16)
    got = tsyn.render_cube_faces(tscene, torch.tensor(pos),
                                 torch.tensor(rot), 16)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-4)


# ---------------------------------------------------------------------------
# 12-13. the render_cubes and ab_quality CLIs
# ---------------------------------------------------------------------------

def _assert_cube_cli_matches_jax(tmp_path, params, argv, s, w2c, k, gt):
    """Run ``render_cubes`` on ``argv`` with the ``params["full"]`` weights
    and hold its first scene's six faces and metrics to the JAX tool's
    loop on the sample ``s`` (numpy): ``prepare_ref``, ``render_rays`` on
    each face camera ``w2c[f]`` with intrinsics ``k`` (the renderer's exact
    flags, 64 + 64 samples), the metrics against the faces ``gt``."""
    ckpt = tmp_path / "model.pth"
    kw = dict(height=H, width=W, depth_hw=(DH, DW))
    torch.save({"network_state_dict": _port(kw, params["full"])
                .state_dict()}, ckpt)
    summary = render_cubes.main(["--ckpt", str(ckpt), "--height", str(H),
                                 "--width", str(W), "--depth-height",
                                 str(DH), "--depth-width", str(DW),
                                 "--out", str(tmp_path / "out"),
                                 "--device", "cpu", *argv])
    data = jax.tree.map(np.asarray, jinfo.build_render_sample(
        s, jnp.zeros((1, 8, 2))))
    ref, que = data["ref_imgs_info"], data["que_imgs_info"]
    fw = H // 2
    coords = np.stack(np.meshgrid(np.arange(fw), np.arange(fw)), -1) \
        .reshape(1, -1, 2).astype(np.float32)
    jmodel = JR(**kw)

    def faces(p, imgs, depth, w2c_ref, w2c, k, gt):
        rd = jmodel.apply(p, imgs, depth, method=JR.prepare_ref)
        rd["w2c"] = w2c_ref
        out = jax.vmap(lambda w: jmodel.apply(
            p, rd, coords, que["c2w"], que["depth_range"],
            ref["depth_range"], perspec_cam=(w[None], k[None]),
            method=JR.render_rays)["pixel_colors_nr_fine"])(w2c)
        pred = jnp.clip(out.reshape(6, fw, fw, 3), 0, 1)
        return pred, [jm.render_metrics(pred[f], gt[f]) for f in range(6)]
    pred, metrics = _jit(faces, params["full"], ref["imgs"],
                         s["depth_panos"][list(jinfo.REF_IDS)], ref["w2c"],
                         w2c, k, gt)
    for f in range(6):
        np.testing.assert_allclose(
            np.load(tmp_path / "out" / f"0-face{f}-pred.npy"), pred[f],
            **OUT_TOL, err_msg=f"face {f}")
        for key, v in metrics[f].items():
            np.testing.assert_allclose(summary["faces"][f][key], v,
                                       rtol=1e-4, atol=1e-4, err_msg=key)
    assert (tmp_path / "out" / "metric.txt").exists()


def test_render_cubes_cli_matches_jax(tmp_path, scene, params):
    """The CLI's six faces and metrics against the JAX tool's loop on the
    same scene and weights, the faces ``equi_to_cube`` cuts from the query
    panorama as ground truth."""
    s = {k: v.numpy() for k, v in tsyn.make_three_view_sample(
        tsyn.SphereScene.random(8800), H, W, 0.5, seed=50).items()}
    w2c, k = jdb.PanoDatabase("m3d", *(s[n] for n in (
        "rgb_panos", "depth_panos", "rots", "trans"))).cube_cameras(1)
    gt = _jit(lambda p: jcube.equi_to_cube(p, H // 2), s["rgb_panos"][1])
    _assert_cube_cli_matches_jax(tmp_path, params, [], s, w2c, k, gt)


def test_render_cubes_cli_on_shards_matches_jax(tmp_path, params):
    """``--shards`` on cube shards that the JAX online generator wrote, as
    the JAX tool reads them: the stored query faces are the ground truth,
    the stored face poses ``[rots_cubes | trans_cubes]`` the cameras, with
    ``cube_intrinsics`` of the stored face width."""
    jonline.OnlineImageGenerator("val", H, W, with_cubes=True,
                                 seed=4).write_shards(tmp_path / "cubes", 1)
    s = jshards.ShardReader(tmp_path / "cubes")[0]
    q = jinfo.QUE_ID
    w2c = np.concatenate([s["rots_cubes"][q], s["trans_cubes"][q][..., None]],
                         -1)
    _assert_cube_cli_matches_jax(
        tmp_path, params, ["--shards", str(tmp_path / "cubes")], s, w2c,
        jdb.cube_intrinsics(H // 2), s["rgb_cubes"][q])


def _diner_ckpt(tmp_path, params) -> str:
    ckpt = tmp_path / "diner.pth"
    torch.save({"network_state_dict": _port(
        dict(BASE, use_hierarchical_sampling=False),
        params["nofine"]).state_dict()}, ckpt)
    return str(ckpt)


def test_ab_quality_cli_matches_jax_tool(tmp_path, monkeypatch, params):
    """Both CLIs on one checkpoint without fine heads (a DINER-trained
    renderer): the float32 ``exact`` mode and the bfloat16 ``diner_mu8``
    mode.  The JAX tool's throw-away ``init`` is skipped (the checkpoint
    replaces it)."""
    argv = ["--ckpt", _diner_ckpt(tmp_path, params), "--height", str(H),
            "--width", str(W), "--depth-height", str(DH), "--depth-width",
            str(DW), "--num", "1", "--samples", str(DN), "--train-mode",
            "diner_mu8", "--modes", "exact,diner_mu8"]
    got = ab_quality.main(argv + ["--device", "cpu"])
    monkeypatch.setattr(JR, "init", lambda self, *a, **k: {})
    monkeypatch.setattr(sys, "argv", ["ab_quality.py", *argv, "--cpu",
                                      "--out", str(tmp_path / "j.json")])
    runpy.run_path(str(REPO / "tools/ab_quality.py"), run_name="__main__")
    want = __import__("json").loads((tmp_path / "j.json").read_text())
    assert got.keys() == want.keys()
    for mode, db, other in (("exact", 5e-3, 1e-3),
                            ("diner_mu8", 2e-2, 2e-3)):
        for k, v in want[mode].items():
            np.testing.assert_allclose(got[mode][k], v, rtol=0,
                                       atol=db if "psnr" in k else other,
                                       err_msg=f"{mode} {k}")


def test_ab_quality_trains_under_diner_and_count_jitter(tmp_path):
    """``--train-mode diner`` trains a renderer without fine heads (every
    parameter moves), saves it, and the saved weights give the same table
    through ``--ckpt``; ``--count-jitter`` weights the fine counts."""
    small = ["--height", str(H), "--width", str(W), "--depth-height",
             str(DH), "--depth-width", str(DW), "--num", "1", "--samples",
             str(DN), "--device", "cpu"]
    args = ab_quality.parse_args(small + ["--train-mode", "diner",
                                          "--steps", "2"])
    make_model, model, trainer, stream = ab_quality.build(args)
    assert model.sampling_mode == "diner" and \
        not model.use_hierarchical_sampling
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer.fit(stream, 2)
    assert all(not torch.equal(v, before[k])
               for k, v in model.state_dict().items())
    ckpt = tmp_path / "d.pth"
    table = ab_quality.main(small + ["--train-mode", "diner", "--steps",
                                     "2", "--modes", "diner",
                                     "--save-ckpt", str(ckpt)])
    again = ab_quality.main(small + ["--train-mode", "diner", "--ckpt",
                                     str(ckpt), "--modes", "diner"])
    assert table == again
    assert all(np.isfinite(v) for v in table["diner"].values())

    args = ab_quality.parse_args(small + ["--count-jitter", "8,8,16",
                                          "--steps", "1"])
    _, _, trainer, stream = ab_quality.build(args)
    assert trainer.variant_probs == {"f8": 2, "f16": 1}
    trainer.fit(stream, 1)
    with pytest.raises(ValueError, match="unknown mode"):
        ab_quality.mode_config("diner_xx")
    with pytest.raises(ValueError, match="train-mode"):
        ab_quality.train_kwargs("uniform")


def test_new_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """Without ``--device cpu`` and with no CUDA device, both CLIs raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = ["--height", str(H), "--width", str(W), "--depth-height",
             str(DH), "--depth-width", str(DW), "--out", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA"):
        render_cubes.main(small)
    with pytest.raises(RuntimeError, match="CUDA"):
        ab_quality.main(small[:-2] + ["--steps", "1"])
