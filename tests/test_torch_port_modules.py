"""Port parity for the renderer's modules: encoders, init and vis nets,
mixture decoder, render ops and aggregation net of
``panogrf_tpu_torch.renderer`` against their JAX counterparts, with the
weights of one JAX ``model.init`` loaded through ``load_jax_params``.

Shapes: 32x64 render, 32x64 depth, 2 reference views, 32 samples.  The
depth grid is 32x64 rather than 16x32 because at 16x32 the init net's
deepest stage is 1x2 pixels, where instance norm over two values turns
float-order noise (and flax's E[x^2]-E[x]^2 variance) into O(1) output
differences: the comparison would measure conditioning, not the port.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as ge
from panogrf_tpu.core.sphere import M3D as JM3D
from panogrf_tpu.nn.blocks import ResUNetLight as JResUNet
from panogrf_tpu.renderer import agg_net as jagg
from panogrf_tpu.renderer import dist_decoder as jdd
from panogrf_tpu.renderer import init_net as jinit
from panogrf_tpu.renderer import render_ops as jro
from panogrf_tpu.renderer.renderer import NeuralRayGenRenderer as JR
from panogrf_tpu_torch.core.sphere import M3D as TM3D
from panogrf_tpu_torch.nn.blocks import ResUNetLight as TResUNet
from panogrf_tpu_torch.renderer import agg_net as tagg
from panogrf_tpu_torch.renderer import dist_decoder as tdd
from panogrf_tpu_torch.renderer import init_net as tinit
from panogrf_tpu_torch.renderer import render_ops as tro
from panogrf_tpu_torch.renderer.presets import preset_kwargs
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer as TR
from panogrf_tpu_torch.utils.from_jax import renderer_state_dict
from torch_port_threads import one_torch_thread  # noqa: F401

H, W, DH, DW, DN = 32, 64, 32, 64, 32
# float32 on both sides; convolution, matmul and reduction order differ
# between XLA and PyTorch
TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.fixture(scope="module")
def jax_model():
    model = JR(height=H, width=W, depth_hw=(DH, DW), depth_sample_num=DN,
               fine_depth_sample_num=DN)
    data = ge._tiny_data(H, W, DH, DW, rn=8)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), data)
    return params["params"], renderer_state_dict(jax.tree.map(np.asarray,
                                                              params))


def _load(module, sd, prefix):
    n = len(prefix) + 1
    module.load_state_dict({k[n:]: v for k, v in sd.items()
                            if k.startswith(prefix + ".")}, strict=True)
    return module.eval()


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("name,layers,inplanes,hw", [
    ("image_encoder", (1, 2, 6), 16, (32, 64)),
    ("init_net.res_net", (2, 3, 6), 32, (32, 64)),
    ("image_encoder", (1, 2, 6), 16, (64, 128)),
])
def test_resunet_light(jax_model, name, layers, inplanes, hw):
    p, sd = jax_model
    jp = p
    for part in name.split("."):
        jp = jp[part]
    x = np.random.default_rng(1).uniform(size=(2, *hw, 3)).astype(np.float32)
    a = JResUNet(32, layers, inplanes).apply({"params": jp}, jnp.asarray(x))
    b = _load(TResUNet(32, layers, inplanes), sd, name)(torch.tensor(x))
    np.testing.assert_allclose(_np(b), np.asarray(a), **TOL)


def test_cost_volume_init_net_and_vis_encoder(jax_model):
    p, sd = jax_model
    rng = np.random.default_rng(2)
    imgs = rng.uniform(size=(2, H, W, 3)).astype(np.float32)
    depth = rng.uniform(1, 5, size=(2, DH // 2, DW // 2, 1)).astype(
        np.float32)       # off-grid depth exercises the resize to depth_hw
    a = jinit.CostVolumeInitNet(depth_hw=(DH, DW)).apply(
        {"params": p["init_net"]}, jnp.asarray(imgs), jnp.asarray(depth))
    tnet = _load(tinit.CostVolumeInitNet((DH, DW)), sd, "init_net")
    b = tnet(torch.tensor(imgs), torch.tensor(depth))
    np.testing.assert_allclose(_np(b), np.asarray(a), **TOL)

    img_feats = rng.normal(size=(2, H // 4, W // 4, 32)).astype(np.float32)
    ray = np.asarray(a)
    a2 = jinit.DefaultVisEncoder().apply({"params": p["vis_encoder"]},
                                         jnp.asarray(ray),
                                         jnp.asarray(img_feats))
    b2 = _load(tinit.DefaultVisEncoder(), sd, "vis_encoder")(
        torch.tensor(ray), torch.tensor(img_feats))
    np.testing.assert_allclose(_np(b2), np.asarray(a2), **TOL)


def test_normalize_inverse_depth():
    d = np.random.default_rng(3).uniform(0.0, 20.0, (50,)).astype(np.float32)
    a = jinit.normalize_inverse_depth(jnp.asarray(d), 0.1, 10.0)
    b = tinit.normalize_inverse_depth(torch.tensor(d), 0.1, 10.0)
    np.testing.assert_allclose(_np(b), np.asarray(a), atol=1e-6)


def test_mixture_decoder_and_compute_prob(jax_model):
    p, sd = jax_model
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(2, 5, DN, 2, 32)).astype(np.float32)
    jm, jv, _, ja = jdd.MixtureLogisticsDistDecoder().apply(
        {"params": p["dist_decoder"]}, jnp.asarray(feats))
    dec = _load(tdd.MixtureLogisticsDistDecoder(), sd, "dist_decoder")
    tm, tv, ta = dec(torch.tensor(feats))
    for x, y in [(tm, jm), (tv, jv), (ta, ja)]:
        np.testing.assert_allclose(_np(x), np.asarray(y), **TOL)

    depth = rng.uniform(0.6, 14, size=(2, 5, DN, 2)).astype(np.float32)
    interval = rng.uniform(0.001, 0.05, size=(2, 5, DN)).astype(np.float32)
    dr = np.asarray([[0.5, 15.0], [0.4, 12.0]], np.float32)
    jn, jf = jdd.get_near_far_intervals_ref(*map(jnp.asarray,
                                                 (depth, interval, dr)))
    tn, tf = tdd.get_near_far_intervals_ref(*map(torch.tensor,
                                                 (depth, interval, dr)))
    np.testing.assert_allclose(_np(tn), np.asarray(jn), atol=1e-6)
    np.testing.assert_allclose(_np(tf), np.asarray(jf), atol=1e-6)
    dm = np.ascontiguousarray(depth.transpose(0, 2, 1, 3))
    jn2, jf2 = jdd.get_near_far_intervals_ref_dm(
        *map(jnp.asarray, (dm, interval, dr)))
    tn2, tf2 = tdd.get_near_far_intervals_ref_dm(
        *map(torch.tensor, (dm, interval, dr)))
    np.testing.assert_allclose(_np(tn2), np.asarray(jn2), atol=1e-6)
    np.testing.assert_allclose(_np(tf2), np.asarray(jf2), atol=1e-6)
    qdr = dr[:1].repeat(2, 0)
    jq = jdd.get_near_far_intervals_que(*map(jnp.asarray,
                                             (depth[..., 0], interval, qdr)))
    tq = tdd.get_near_far_intervals_que(*map(torch.tensor,
                                             (depth[..., 0], interval, qdr)))
    for x, y in zip(tq, jq):
        np.testing.assert_allclose(_np(x), np.asarray(y), atol=1e-6)

    ja_, jvis, jhit = jdd.compute_prob(jn, jf, jm, jv, None, ja, False)
    ta_, tvis, thit = tdd.compute_prob(tn, tf, tm, tv, ta)
    for x, y in [(ta_, ja_), (tvis, jvis), (thit, jhit)]:
        np.testing.assert_allclose(_np(x), np.asarray(y), **TOL)


def test_sampling_and_compositing():
    rng = np.random.default_rng(5)
    jd, jdist = jro.sample_depth(2, 7, DN, 0.5, 15.0, True)
    td, tdist = tro.sample_depth(2, 7, DN, 0.5, 15.0, True)
    np.testing.assert_allclose(_np(td), np.asarray(jd), rtol=1e-6)
    np.testing.assert_allclose(_np(tdist), np.asarray(jdist), rtol=1e-5)
    qdr = np.asarray([[0.5, 15.0]], np.float32)
    np.testing.assert_allclose(
        _np(tro.depth2inv_dists(td, torch.tensor(qdr))),
        np.asarray(jro.depth2inv_dists(jd, jnp.asarray(qdr))), rtol=1e-5)
    hit = rng.uniform(size=(2, 7, DN)).astype(np.float32) ** 4
    jf = jro.sample_fine_depth(jd, jnp.asarray(hit), jnp.asarray(qdr), DN,
                               None)
    tf = tro.sample_fine_depth(td, torch.tensor(hit), torch.tensor(qdr), DN)
    np.testing.assert_allclose(_np(tf), np.asarray(jf), rtol=1e-5)

    density = rng.normal(size=(2, 7, DN)).astype(np.float32)
    colors = rng.uniform(size=(2, 7, DN, 3)).astype(np.float32)
    a = jro.density2outputs(jnp.asarray(density), jnp.asarray(colors), jd)
    b = tro.density2outputs(torch.tensor(density), torch.tensor(colors), td)
    for k in ("hit_prob", "pixel_colors", "render_depth"):
        np.testing.assert_allclose(_np(b[k]), np.asarray(a[k]), rtol=1e-5,
                                   atol=1e-6)


def _ref_data(p, preset):
    """The JAX prepare_ref output at ``preset``'s flags (float32), as numpy,
    plus the query rays of one chunk."""
    kw = preset_kwargs(preset, compute_dtype="float32")
    model = JR(height=H, width=W, depth_hw=(DH, DW), depth_sample_num=DN,
               fine_depth_sample_num=DN, **kw)
    info = ge._tiny_data(H, W, DH, DW, rn=8)["ref_imgs_info"]
    ref = model.apply({"params": p}, info["imgs"], info["mvs_depth"],
                      method=JR.prepare_ref)
    ref["w2c"] = info["w2c"]
    rng = np.random.default_rng(6)
    coords = np.stack([rng.integers(0, W, (1, 24)),
                       rng.integers(0, H, (1, 24))], -1).astype(np.float32)
    c2w = np.concatenate([np.eye(3), [[0.1], [0.0], [0.2]]], 1).astype(
        np.float32)
    que_depth, _ = jro.sample_depth(1, 24, DN, 0.5, 15.0, True)
    pts, qdir = jro.depth2points_spherical(
        jnp.asarray(coords), que_depth, jnp.asarray(c2w),
        JM3D.ray_directions(H, W))
    return ({k: np.asarray(v) for k, v in ref.items()}, coords, c2w,
            np.asarray(que_depth), np.asarray(pts), np.asarray(qdir))


@pytest.mark.parametrize("preset", ["serving", "exact"])
def test_points_and_projection(jax_model, preset):
    p, _ = jax_model
    ref, coords, c2w, que_depth, pts, qdir = _ref_data(p, preset)
    tpts, tqdir = tro.depth2points_spherical(
        torch.tensor(coords), torch.tensor(que_depth), torch.tensor(c2w),
        TM3D.ray_directions(H, W))
    np.testing.assert_allclose(_np(tpts), pts, atol=1e-5)
    np.testing.assert_allclose(_np(tqdir), qdir, atol=1e-6)

    kw = preset_kwargs(preset)
    for stride in sorted({1, kw["gather_stride"],
                          kw["gather_stride_fine"] or 1}):
        stride = min(stride, DN // 2)
        a = jro.project_points_dict(
            {k: jnp.asarray(v) for k, v in ref.items()}, jnp.asarray(pts),
            JM3D, que_dir=jnp.asarray(qdir),
            depth_major=kw["gather_depth_major"], gather_stride=stride)
        b = tro.project_points_dict(
            {k: torch.tensor(v) for k, v in ref.items()}, torch.tensor(pts),
            TM3D, torch.tensor(qdir), depth_major=kw["gather_depth_major"],
            gather_stride=stride)
        assert b.get("layout") == a.get("layout")
        want = {k for k in a if k != "layout"}
        assert want == {k for k in b if k != "layout"}
        for k in want:
            np.testing.assert_allclose(_np(b[k]), np.asarray(a[k]), **TOL,
                                       err_msg=f"{k} stride {stride}")


@pytest.mark.parametrize("layout", ["rnd", "dnr"])
@pytest.mark.parametrize("geometry_only", [False, True])
def test_aggregation_net(jax_model, layout, geometry_only):
    p, sd = jax_model
    rng = np.random.default_rng(7)
    qn, rn, v = 1, 12, 2
    shp = (qn, DN, rn, v) if layout == "dnr" else (qn, rn, DN, v)
    prj = {"ray_feats": rng.normal(size=(*shp, 32)),
           "rgb": rng.uniform(size=(*shp, 3)),
           "img_feats": rng.normal(size=(*shp, 32)),
           "dir_diff": rng.normal(size=(*shp, 4)) * 0.3,
           "hit_prob": rng.uniform(size=(*shp, 1)),
           "vis": rng.uniform(size=(*shp, 1))}
    prj = {k: x.astype(np.float32) for k, x in prj.items()}
    jprj = {k: jnp.asarray(x) for k, x in prj.items()}
    tprj = {k: torch.tensor(x) for k, x in prj.items()}
    if layout == "dnr":
        jprj["layout"] = tprj["layout"] = "dnr"
    que_dir = jnp.zeros((qn, rn, DN, 3))
    jd, jc = jagg.DefaultAggregationNet(
        n_samples=DN, geometry_only=geometry_only).apply(
        {"params": p["agg_net"]}, jprj, que_dir)
    net = _load(tagg.DefaultAggregationNet(geometry_only=geometry_only),
                sd, "agg_net")
    td, tc = net(tprj)
    np.testing.assert_allclose(_np(td), np.asarray(jd), **TOL)
    np.testing.assert_allclose(_np(tc), np.asarray(jc), **TOL)


def test_sinusoid_table_and_seq_plain_path(jax_model):
    np.testing.assert_array_equal(tagg.sinusoid_pos_encoding(DN, 16),
                                  jagg.sinusoid_pos_encoding(DN, 16))
    p, sd = jax_model
    x = np.random.default_rng(8).normal(size=(40, DN, 16)).astype(np.float32)
    a = jagg._Seq((16, 1), final_act="relu").apply(
        {"params": p["agg_net"]["agg_impl"]["out_geometry_fc"]},
        jnp.asarray(x))
    b = _load(tagg._Seq((16, 16, 1), final_act="relu"), sd,
              "agg_net.agg_impl.out_geometry_fc")(torch.tensor(x))
    np.testing.assert_allclose(_np(b), np.asarray(a), **TOL)


def test_weights_round_trip_through_converter(jax_model):
    """flax params -> load_jax_params -> state_dict() -> convert_renderer
    gives back the same tree: the port's parameter names are the
    reference PyTorch layout."""
    from panogrf_tpu.utils.torch_convert import convert_renderer
    from panogrf_tpu_torch.utils.from_jax import load_jax_params
    p, _ = jax_model
    model = TR(height=H, width=W, depth_hw=(DH, DW), depth_sample_num=DN,
               fine_depth_sample_num=DN, device="cpu")
    load_jax_params(model, {"params": jax.tree.map(np.asarray, p)})
    back = convert_renderer({k: v.numpy() for k, v in
                             model.state_dict().items()})["params"]
    flat_a = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, p))
    flat_b = jax.tree_util.tree_flatten_with_path(back)
    assert [k for k, _ in flat_a[0]] == [k for k, _ in flat_b[0]]
    for (k, x), (_, y) in zip(flat_a[0], flat_b[0]):
        np.testing.assert_array_equal(x, y, err_msg=str(k))


@pytest.mark.parametrize("part", ["init_net", "prepare_ref"])
def test_float64_at_depth_16x32(jax_model, part):
    """At depth_hw (16, 32) the init net's deepest stage is 1x2 pixels: in
    float32 each package is far from its own float64 output there (see the
    module docstring), so the two are held to each other in float64, the
    init net and the whole per-scene encoding."""
    p, sd = jax_model
    rng = np.random.default_rng(6)
    imgs = rng.uniform(size=(2, H, W, 3))
    depth = rng.uniform(1, 5, size=(2, 16, 32, 1))
    kw = dict(height=H, width=W, depth_hw=(16, 32), depth_sample_num=DN,
              fine_depth_sample_num=DN, compute_dtype="float64")
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), p)
        if part == "init_net":
            want = {"ray_feats": jinit.CostVolumeInitNet(
                depth_hw=(16, 32)).apply({"params": p64["init_net"]},
                                         jnp.asarray(imgs),
                                         jnp.asarray(depth))}
        else:
            want = JR(**kw).apply({"params": p64}, jnp.asarray(imgs),
                                  jnp.asarray(depth), method=JR.prepare_ref)
        want = {k: np.asarray(v) for k, v in want.items()}
    with torch.no_grad():
        if part == "init_net":
            tnet = _load(tinit.CostVolumeInitNet((16, 32)), sd,
                         "init_net").double()
            got = {"ray_feats": tnet(torch.tensor(imgs),
                                     torch.tensor(depth))}
        else:
            tm = TR(**kw, device="cpu")
            tm.load_state_dict(sd)
            got = tm.double().eval().prepare_ref(torch.tensor(imgs),
                                                 torch.tensor(depth))
    assert set(want) <= set(got)
    for k, v in want.items():
        assert got[k].dtype == torch.float64, k
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-7,
                                   atol=1e-7 * np.abs(v).max(), err_msg=k)
