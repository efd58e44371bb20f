"""Port parity for the stage profilers ``tools/profile_honest.py``,
``tools/profile_render.py`` and ``tools/profile_mvs.py``.

Each stage the port's stage functions make (``honest_stages``,
``render_stages``, ``mvs_stages`` / ``step_ms``), at 32x64 with 32x64
depth, 32 samples, 64 or 128 rays and an MVS batch of 2 at 8
hypotheses, computes in float32 on the CPU what the same stage built
from the JAX package's functions computes on the same numpy inputs,
with the port's seeded weights carried over by ``utils/torch_convert``.  Tolerances (of the largest output, or
gradient, of each compared array):

* 1e-5 for the gathers, the projection, ``compute_prob`` (in float64:
  its hit probability is a difference of two CDFs near 0.5), the pool
  chain, the decoder and the aggregation net (attention tail included);
* 1e-4 for ``project_gather``, where the float32 rounding of the
  projected coordinates (~1e-5 px) meets the random maps' slopes;
* 1e-3 for whole render passes (``test_torch_port_render.py``'s), and
  for the per-scene encoding they read; 5e-2 for the bfloat16 pass with
  per-map gathers (the JAX tool's default), where JAX promotes to float32
  what the port keeps in bfloat16;
* for ``sample_fine_depth``, 1e-4 and 1e-3 on the samples
  ``ill_conditioned`` flags (``test_torch_port_ft.py``'s);
* 1e-4 for the MVS stages' outputs and gradients, and for the first
  training step's loss.

One contract test per CLI runs it on ``--device cpu`` at a small size and
reads its JSON; without ``--device cpu`` each raises here, where there is
no CUDA device.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import pytest
import torch

from panogrf_tpu.core.sphere import M3D as JM3D
from panogrf_tpu.models.mvs import MVSDepthModel as JMVS
from panogrf_tpu.models.mvs import build_depth_hypotheses as jhyp
from panogrf_tpu.models.unifuse import Equi as JEqui
from panogrf_tpu.nn.blocks import UNet3D as JUNet3D
from panogrf_tpu.nn.blocks import resize_linear as jresize
from panogrf_tpu.ops.cost_volume import spherical_sweep_cost as jsweep
from panogrf_tpu.ops.resample import interpolate_feats as jif
from panogrf_tpu.ops.resample import interpolate_feats_pointmajor as jifp
from panogrf_tpu.renderer import agg_net as jagg
from panogrf_tpu.renderer import full_render as jfr
from panogrf_tpu.renderer import render_ops as jro
from panogrf_tpu.renderer.dist_decoder import MixtureLogisticsDistDecoder
from panogrf_tpu.renderer.dist_decoder import compute_prob as jprob
from panogrf_tpu.renderer.renderer import NeuralRayGenRenderer as JR
from panogrf_tpu.train.depth_trainer import depth_loss_fn as jloss
from panogrf_tpu.utils import torch_convert as tcv
from panogrf_tpu_torch.tools import profile_honest as PH
from panogrf_tpu_torch.tools import profile_mvs as PM
from panogrf_tpu_torch.tools import profile_render as PR
from torch_port_parity import ill_conditioned
from torch_port_threads import one_torch_thread  # noqa: F401

H, W, DN, CHUNK, RAYS = 32, 64, 32, 64, 128
CPU = torch.device("cpu")
TIGHT, PASS, MVS_TOL, PROJECT_GATHER = 1e-5, 1e-3, 1e-4, 1e-4
# bfloat16 through a whole pass: the port's rows and prob embedding are
# bfloat16 where JAX promotes them to float32 (measured 2.0e-2; the port's
# bfloat16 pass is 2.0e-2 off its float32 one)
BF16_PASS = 5e-2
ILL_CONDITIONED = 1e-3


def _np(t):
    return np.asarray(t.detach().float() if isinstance(t, torch.Tensor)
                      else t, np.float32)


def assert_close(got, want, rel, what=""):
    """``got`` within ``rel`` of ``want``'s largest magnitude."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=what)


def assert_close_off_seam(got, want, coords, rel, what, hw=(H, W)):
    """``got`` (1, rn, ...) against ``want`` on the rays off the seams:
    the profilers' reference views and query lie on one axis, so a ray in
    the border columns or rows or the middle column has points on a
    reference view's longitude seam, where the two packages' roundings
    fetch pixels a column apart (ROADMAP, Queue 3; ``off_seam_coords``
    draws rays off the same set)."""
    (h, w), x, y = hw, coords[0, :, 0], coords[0, :, 1]
    seam = (x == 0) | (x == w - 1) | (np.abs(x - w // 2) <= 1) \
        | (y == 0) | (y == h - 1)
    assert seam.sum() <= seam.size / 4, (what, seam.sum())
    assert_close(_np(got)[:, ~seam], np.asarray(want)[:, ~seam], rel, what)


def state(module, prefix):
    """The module's state dict as numpy under ``prefix``."""
    return {f"{prefix}.{k}": v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


# ---------------------------------------------------------------------------
# profile_honest
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def honest():
    with torch.no_grad():
        stages = PH.honest_stages(CHUNK, "float32", CPU, hw=(H, W),
                                  depth_hw=(H, W), dn=DN,
                                  only=set(PH.GROUPS.values()) - {"coarse"})
    return stages, PH.honest_inputs(CHUNK, (H, W), (H, W), DN)


def _jax_honest(key, x, st):
    """The JAX tool's stage ``key`` on the inputs ``x`` (numpy), with the
    port stage ``st``'s weights."""
    f = lambda a: jnp.asarray(a, jnp.float32)        # noqa: E731
    if key.startswith("gather"):
        maps = x["imgs"] if "imgs" in key else x["merged"]
        return jax.jit(lambda m, p: jifp(m, p, H, W))(f(maps), f(x["pts"]))
    if key == "dist_decoder_ms":
        p = tcv.convert_dist_decoder(state(st.module, "d"), "d")
        mean, var, _, aw = jax.jit(MixtureLogisticsDistDecoder().apply)(
            {"params": p}, f(x["feats"]))
        return mean, var, aw
    if key == "compute_prob_ms":
        # float64 of the float32 inputs (see test_honest_stage_matches_jax)
        with jax.enable_x64(True):
            near, mean = (jnp.asarray(np.float32(x[k]), jnp.float64)
                          for k in ("near", "mean"))
            return tuple(np.asarray(a) for a in jprob(
                near, near + 0.01, mean, mean + 0.5, None, mean[..., :1],
                False))
    if key == "agg_net_ms":
        feats = f(x["feats"])
        prj = {"ray_feats": feats, "rgb": feats[..., :3],
               "img_feats": feats, "dir": feats[..., :3],
               "hit_prob": feats[..., :1], "vis": feats[..., :1],
               "alpha": feats[..., :1]}
        p = tcv.convert_agg_net(state(st.module, "a"), "a")
        return jax.jit(jagg.DefaultAggregationNet(n_samples=DN).apply)(
            {"params": p}, prj, jnp.ones((1, CHUNK, DN, 3)))
    if key == "attn_tail_ms":
        return _jax_attn_tail(st.module, f(x["geo"]))
    if key == "pool_xla_ms":
        params = {n: {k: f(a) for i, (w, b) in enumerate(layers)
                      for k, a in ((f"w{i}", w), (f"b{i}", b))}
                  for n, layers in x["pool_params"].items()}
        return jax.jit(jagg.pool_reference)(
            f(x["rgbf"]), f(x["nray"]), f(x["rdif"]),
            jnp.ones((CHUNK * DN, 2, 1)), params)
    if key == "projection_math_ms":
        w2c = jnp.broadcast_to(jnp.concatenate(
            [jnp.eye(3), jnp.zeros((3, 1))], 1), (2, 3, 4))

        @jax.jit
        def project(pts3):
            cam = jnp.einsum("vij,pj->pvi", w2c[:, :, :3], pts3) \
                + w2c[None, :, :, 3]
            return JM3D.project_to_pixels(cam, H, W)[0]
        return project(f(x["pts3"]))
    if key == "sample_fine_depth_ms":
        depth0 = jnp.broadcast_to(jnp.linspace(0.5, 15, DN), (1, CHUNK, DN))
        return jax.jit(lambda d, hit: jro.sample_fine_depth(
            d, hit, jnp.asarray([[0.5, 15.0]]), DN, None))(depth0,
                                                          f(x["hit"]))
    raise KeyError(key)


def _jax_attn_tail(tail, geo):
    """The JAX tool's ``_AttnTail`` with ``tail``'s weights."""
    class _AttnTail(fnn.Module):
        @fnn.compact
        def __call__(self, g):
            pos = jnp.asarray(jagg.sinusoid_pos_encoding(DN, 16))
            y = g + pos[None]
            a = jagg.MultiHeadAttention(name="ray_attention")(y, y, y)
            return jagg._Seq((16, 1), final_act="relu",
                             name="out_geometry_fc")(a)

    sd = state(tail, "t")
    dense = lambda k: {"kernel": tcv.t2f_dense(sd[k])}   # noqa: E731
    params = {
        "ray_attention": {
            **{n: dense(f"t.ray_attention.{n}.weight")
               for n in ("w_qs", "w_ks", "w_vs", "fc")},
            "LayerNorm_0": {"scale": sd["t.ray_attention.layer_norm.weight"],
                            "bias": sd["t.ray_attention.layer_norm.bias"]}},
        "out_geometry_fc": {
            k: a for i, j in enumerate((0, 2)) for k, a in (
                (f"w{i}", tcv.t2f_dense(sd[f"t.out_geometry_fc.{j}.weight"])),
                (f"b{i}", sd[f"t.out_geometry_fc.{j}.bias"]))}}
    return jax.jit(_AttnTail().apply)({"params": params}, geo)


@pytest.mark.parametrize("key", [
    "gather_imgs_512x1024x3_ms", "gather_merged_128x256x64_ms",
    "dist_decoder_ms", "compute_prob_ms", "agg_net_ms", "attn_tail_ms",
    "pool_xla_ms", "projection_math_ms", "sample_fine_depth_ms"])
def test_honest_stage_matches_jax(honest, key):
    stages, x = honest
    st = stages[key]
    with torch.no_grad():
        # the hit probability is a difference of two CDFs near 0.5, which
        # float32 rounds to 1.5e-5 of the largest hit here: compute_prob
        # runs in float64 on both sides, on the same float32 inputs
        got = st.run(st.init.double() if key == "compute_prob_ms"
                     else st.init)
        nxt = st.step(st.init)
    want = _jax_honest(key, x, st)
    got, want = (got if isinstance(got, tuple) else (got,),
                 want if isinstance(want, tuple) else (want,))
    assert len(got) == len(want)
    if key == "sample_fine_depth_ms":
        depth0 = np.broadcast_to(np.linspace(0.5, 15, DN), (1, CHUNK, DN))
        fine = np.asarray(want[0])
        ill = ill_conditioned(depth0, x["hit"], fine)
        tol = np.where(ill, ILL_CONDITIONED, 1e-4) * (1 + fine)
        assert np.all(np.abs(_np(got[0]) - fine) <= tol)
    else:
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, TIGHT, f"{key}[{i}]")
    # the chain's next input has the stage input's structure
    first = st.init if not isinstance(st.init, dict) else st.init["hit_prob"]
    nxt = nxt if not isinstance(nxt, dict) else nxt["hit_prob"]
    assert nxt.shape == first.shape and torch.isfinite(nxt).all()


@pytest.mark.parametrize("serving,dtype,hw,depth_hw,tol", [
    (False, "float32", (H, W), (H, W), PASS),
    (True, "float32", (H, W), (H, W), PASS),
    # the JAX tool's default: bfloat16 with the per-map gathers, where the
    # merged map is float32 (its ray features resized onto the image
    # features' grid); the port's rows take the compute dtype, JAX's
    # promote its prob embedding to float32
    (False, "bfloat16", (2 * H, 2 * W), (H, W), BF16_PASS)])
def test_honest_coarse_pass_matches_jax(serving, dtype, hw, depth_hw, tol):
    with torch.no_grad():
        st = PH.honest_stages(CHUNK, dtype, CPU, hw=hw, depth_hw=depth_hw,
                              fast_gather=serving, serving=serving,
                              only=["coarse"], dn=DN)["coarse_pass_ms"]
        got = st.run(st.init)["pixel_colors_nr"]
    assert st.method == ("graph" if serving else "events")
    assert got.shape == (1, CHUNK, 3)
    x = PH.honest_inputs(CHUNK, hw, depth_hw, DN)
    model = JR(height=hw[0], width=hw[1], depth_hw=depth_hw,
               depth_sample_num=DN, fine_depth_sample_num=DN,
               compute_dtype=dtype,
               fast_gather=serving, gather_depth_major=serving,
               gather_stride=4 if serving else 1, decode_on_map=serving,
               use_hierarchical_sampling=False)
    params = tcv.convert_renderer({k: v.detach().numpy().copy() for k, v
                                   in st.module.state_dict().items()})
    w2c = np.tile(np.concatenate([np.eye(3), np.zeros((3, 1))], 1),
                  (2, 1, 1)).astype(np.float32)
    dr = jnp.asarray([[0.5, 15.0]] * 2)
    ref = jfr.prepare_ref_data(model, params, {
        "imgs": jnp.asarray(x["ref_imgs"], jnp.float32),
        "mvs_depth": jnp.asarray(x["mvs_depth"], jnp.float32),
        "w2c": jnp.asarray(w2c)})
    c2w = jnp.asarray([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0.5]])
    out = jax.jit(lambda p, r, c: model.apply(
        p, r, c, c2w, dr[:1], dr, method=JR.render_rays))(
        params, ref, jnp.asarray(x["coords"], jnp.float32))
    assert_close_off_seam(got, out["pixel_colors_nr"], x["coords"], tol,
                          "pixel_colors_nr", hw)


# ---------------------------------------------------------------------------
# profile_render
# ---------------------------------------------------------------------------

def test_render_stages_match_jax():
    size = (H, W, H, W)
    with torch.no_grad():
        model, stages = PR.render_stages(CPU, size, RAYS, DN)
        got = {k: fn() for k, fn in stages.items()}
    x = PR.render_inputs(size, RAYS, DN)
    f = lambda a: jnp.asarray(a, jnp.float32)        # noqa: E731
    jm = JR(height=H, width=W, depth_hw=(H, W), depth_sample_num=DN,
            fine_depth_sample_num=DN)
    params = tcv.convert_renderer({k: v.detach().numpy().copy() for k, v in
                                   model.state_dict().items()})
    ref = jax.jit(lambda p, i, d: jm.apply(p, i, d, method=JR.prepare_ref))(
        params, f(x["imgs"]), f(x["mvs_depth"]))
    for k in ("imgs", "img_feats", "ray_feats"):
        assert_close(got["prepare_ref_ms"][k], ref[k], PASS, k)
    ref["w2c"] = f(x["w2c"])
    c2w = jnp.asarray([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0.5]])
    dr = jnp.asarray([[0.5, 15.0]] * 2)
    coords = f(x["coords"])
    out = jax.jit(lambda p, r, c: jm.apply(
        p, r, c, c2w, dr[:1], dr, method=JR.render_rays))(params, ref, coords)
    for k in ("pixel_colors_nr", "pixel_colors_nr_fine"):
        assert_close_off_seam(got["render_8192rays_ms"][k], out[k],
                              x["coords"], PASS, k)

    @jax.jit
    def project_gather(r, c):
        qd, _ = jro.sample_depth(1, RAYS, DN, 0.5, 15.0, True)
        pts, _ = jro.depth2points_spherical(c, qd, c2w,
                                            JM3D.ray_directions(H, W))
        return jro.project_points_dict(r, pts, JM3D)["ray_feats"]
    assert_close_off_seam(got["project_gather_ms"],
                          project_gather(ref, coords), x["coords"],
                          PROJECT_GATHER, "project_gather")

    ones = jnp.ones((1, RAYS, DN, 2, 32))
    jprj = {"ray_feats": ones, "rgb": ones[..., :3], "img_feats": ones,
            "dir": ones[..., :3], "hit_prob": ones[..., :1],
            "vis": ones[..., :1]}
    density, colors = jax.jit(lambda v, p, q: jm.apply(
        v, p, q, method=lambda m, p, q: m.agg_net(p, q)))(
        params, jprj, jnp.ones((1, RAYS, DN, 3)))
    assert_close(got["agg_net_ms"][0], density, TIGHT, "agg density")
    assert_close(got["agg_net_ms"][1], colors, TIGHT, "agg colors")
    mean, var, _, aw = jax.jit(lambda v, a: jm.apply(
        v, a, method=lambda m, a: m.dist_decoder(a)))(params, ones)
    for g, w, k in zip(got["dist_decoder_ms"], (mean, var, aw),
                       ("mean", "var", "aw")):
        assert_close(g, w, TIGHT, k)
    pts2 = f(x["pts"])
    want = jax.jit(lambda r, p: sum(jif(r[k], p, H, W).sum() for k in (
        "ray_feats", "imgs", "img_feats")))(ref, pts2)
    assert_close(got["raw_gathers_ms"], want, TIGHT, "raw_gathers")


# ---------------------------------------------------------------------------
# profile_mvs
# ---------------------------------------------------------------------------

MVS_HW, MVS_D = (32, 64), 8


@pytest.fixture(scope="module")
def mvs():
    model = PM.mvs_model(MVS_D, CPU)
    x = PM.mvs_inputs(MVS_HW, 2)
    with torch.no_grad():
        stages = PM.mvs_stages(model, x, CPU, 1)
    v = tcv.convert_mvs({k: a.detach().numpy().copy() for k, a in
                         model.state_dict().items()})
    return model, x, stages, v


def _value_and_grads(fn, *xs):
    """(fn(*xs), d sum(fn(*xs)) / d xs) from one trace of ``fn``."""
    y, vjp = jax.vjp(fn, *xs)
    return y, vjp(jnp.ones_like(y))


def _jax_equi(v):
    ev = {"params": v["params"]["feature_net"],
          "batch_stats": v["batch_stats"]["feature_net"]}
    return lambda a: JEqui().apply(ev, a, False)


def test_mvs_forward_and_feature_stages_match_jax(mvs):
    model, x, stages, v = mvs
    f = {k: jnp.asarray(a, jnp.float32) for k, a in x.items()}
    with torch.no_grad():
        got = {k: stages[k].run(stages[k].init) for k in ("fwd", "feat")}
    got["feat_grad"] = stages["feat_grad"].run(stages["feat_grad"].init)
    want_fwd = jax.jit(lambda v, *a: JMVS(num_hypotheses=MVS_D).apply(
        v, *a, train=False))(v, f["panos"], f["rots"], f["trans"],
                             f["mono"], f["feat"])["depth"]
    assert_close(got["fwd"], want_fwd, MVS_TOL, "fwd")
    flat = f["panos"].reshape(4, *MVS_HW, 3)
    feat, g = jax.jit(lambda a: _value_and_grads(_jax_equi(v), a))(flat)
    assert_close(got["feat"], feat, MVS_TOL, "feat")
    assert_close(got["feat_grad"][0], g[0], MVS_TOL, "feat_grad")


def test_mvs_sweep_and_reg_stages_match_jax(mvs):
    model, x, stages, v = mvs
    with torch.no_grad():
        feats = model.unet(torch.as_tensor(x["panos"], dtype=torch.float32)
                           .reshape(4, *MVS_HW, 3)).reshape(
            2, 2, MVS_HW[0] // 4, MVS_HW[1] // 4, -1).numpy()
        got = {k: stages[k].run(stages[k].init) for k in ("sweep", "reg")}
    for k in ("sweep_grad", "reg_grad"):
        got[k] = stages[k].run(stages[k].init)
    f = lambda a: jnp.asarray(a, jnp.float32)        # noqa: E731
    mu4 = jresize(f(x["mono"]), (MVS_HW[0] // 4, MVS_HW[1] // 4),
                  axes=(1, 2))
    dvol = jhyp(mu4, [0.0] * 5, MVS_D, 0.1, 10.0, 0.5)
    rots, trans = f(x["rots"]), f(x["trans"])
    conv = JMVS().convention

    def sweep(rf, sf):
        return jax.vmap(lambda a, b, dv, rot, tr: jsweep(
            a, b, dv, rot[1], tr[1], rot[0], tr[0], conv))(
            rf, sf, dvol, rots, trans)
    ref, src = f(feats[:, 1]), f(feats[:, 0])
    cost, gs = jax.jit(lambda a, b: _value_and_grads(sweep, a, b))(ref, src)
    assert_close(got["sweep"], cost, MVS_TOL, "sweep")
    for i in range(2):
        assert_close(got["sweep_grad"][i], gs[i], MVS_TOL, f"sweep_grad{i}")
    cost = f(got["sweep"])                      # (B, D, h, w, C)
    u3 = JUNet3D(base_features=32, num_layers=3, out_features=1, wrap=True)
    uv = {"params": v["params"]["unet3d"]}
    reg, gr = jax.jit(lambda c: _value_and_grads(
        lambda x: u3.apply(uv, x), c))(cost)
    assert_close(got["reg"].permute(0, 2, 3, 4, 1), reg, MVS_TOL, "reg")
    assert_close(got["reg_grad"][0].permute(0, 2, 3, 4, 1), gr[0], MVS_TOL,
                 "reg_grad")


def test_mvs_step_loss_matches_jax(mvs):
    """The first training step's loss (BatchNorm on batch statistics)
    against the JAX trainer's loss of the same forward."""
    model, x, _, v = mvs
    before = {k: a.clone() for k, a in model.state_dict().items()}
    runs, losses, launches = PM.step_ms(model, x, CPU, 1)
    assert len(runs) == 1 and len(losses) == 2 and launches == [0, 0]
    f = {k: jnp.asarray(a, jnp.float32) for k, a in x.items()}

    def loss(v):
        out, _ = JMVS(num_hypotheses=MVS_D).apply(
            v, f["panos"], f["rots"], f["trans"], f["mono"], f["feat"],
            train=True, mutable=["batch_stats"])
        return jloss("l1_sphere", out["depth"], f["gt_depth"]) \
            + 0.5 * jloss("l1_sphere", out["rectified_depth_d1"],
                          f["gt_depth"])
    want = float(jax.jit(loss)(v))
    assert abs(losses[0] - want) <= MVS_TOL * abs(want)
    # the stage trained a copy: the profiled net keeps its weights
    after = model.state_dict()
    assert all(torch.equal(a, after[k]) for k, a in before.items())


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def _json(out: str) -> dict:
    """The JSON dict a CLI printed after its ``[stage]`` lines."""
    start = out.index("{")
    return json.loads(out[start:])


HONEST_KEYS = {"chunk", "dtype", "compute_prob_ms", "projection_math_ms",
               "sample_fine_depth_ms", "device"}
MVS_KEYS = {"step", "fwd", "feat", "feat_grad", "sweep", "sweep_grad", "reg",
            "reg_grad"}
RENDER_KEYS = {"prepare_ref_ms", "render_8192rays_ms", "project_gather_ms",
               "agg_net_ms", "dist_decoder_ms", "raw_gathers_ms",
               "est_frame_ms_from_chunks", "device"}


def test_profile_honest_cli(capsys):
    res = PH.main(["--only", "fine,prob,projection", "--chunk", "64",
                   "--device", "cpu"])
    out = _json(capsys.readouterr().out)
    assert out == res and HONEST_KEYS <= out.keys()
    assert out["device"] == "cpu" and out["chunk"] == 64
    assert out["mlp2_launches"] == {k: 0 for k in HONEST_KEYS
                                    if k.endswith("_ms")}
    assert all(out[k] > 0 for k in HONEST_KEYS if k.endswith("_ms"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PH.main(["--only", "fine", "--chunk", "64"])


def test_profile_mvs_cli(capsys):
    res = PM.main(["--height", "32", "--width", "64", "--hypotheses", "8",
                   "--iters", "1", "--device", "cpu", "--scatter"])
    out = _json(capsys.readouterr().out.splitlines()[-1])
    assert out == res and MVS_KEYS <= out.keys()
    assert out["sweep_backward"] == "scatter" and out["device"] == "cpu"
    assert all(out[k] > 0 for k in MVS_KEYS)
    assert out["mlp2_launches"] == dict.fromkeys(MVS_KEYS, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PM.main(["--height", "32", "--width", "64"])


def test_profile_render_cli(capsys, monkeypatch):
    monkeypatch.setattr(PR, "SIZE", (H, W, H, W))
    monkeypatch.setattr(PR, "RAYS", 64)
    res = PR.main(["--device", "cpu"])
    out = _json(capsys.readouterr().out)
    assert out == res and RENDER_KEYS <= out.keys()
    assert all(out[k] > 0 for k in RENDER_KEYS if k.endswith("_ms"))
    assert out["est_frame_ms_from_chunks"] == pytest.approx(
        out["render_8192rays_ms"] * H * W / 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PR.main([])
