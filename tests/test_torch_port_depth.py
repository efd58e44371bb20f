"""The port's frozen depth stack against the JAX package, on the CPU in
float32: the pixel-centre sphere grid, border-x resampling, the 3-axis
resize, the cubemap grids, the depth-stack conv blocks, the ResNet
encoders, the fusion layers, UniFuse, Equi, the depth hypotheses, the
spherical sweep, ``MVSDepthModel`` and ``DepthStack`` (full and
``wo_stereo``), the state-dict round trips and the loading of
reference-layout checkpoints.

Weights are drawn by the port's seeded initialiser, with random BatchNorm
statistics so eval-mode normalisation is not the identity, and carried to
the JAX modules by the JAX package's own converters (``torch_convert``),
whose trees are checked against ``jax.eval_shape`` of the JAX modules'
``init``.  Shapes follow ``tests/test_depth_stack.py``: mono 64x128, MVS
32x64 with 8 hypotheses, 3 MaGNet samples and a 3D UNet of base 8.

Tolerances: float32 parity at 1e-4 of each output's scale (measured
errors are ~1e-6 of the scale); BatchNorm in eval mode adds no noise.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from panogrf_tpu.core import cubemap as jcube
from panogrf_tpu.core.sphere import get_convention as jconv
from panogrf_tpu.data import imgs_info as jinfo
from panogrf_tpu.data import synthetic as jsyn
from panogrf_tpu.models import depth_stack as jds
from panogrf_tpu.models import mvs as jmvs
from panogrf_tpu.models.unifuse import Equi as JEqui, UniFuse as JUniFuse
from panogrf_tpu.nn import blocks as jblocks
from panogrf_tpu.nn import fusion as jfusion
from panogrf_tpu.nn.resnet import ResNetEncoder as JResNet
from panogrf_tpu.ops import cost_volume as jcv
from panogrf_tpu.ops import resample as jres
from panogrf_tpu.utils import torch_convert as tcv
from panogrf_tpu_torch.core import cubemap as tcube
from panogrf_tpu_torch.core.sphere import get_convention as tconv
from panogrf_tpu_torch.models import depth_stack as tds
from panogrf_tpu_torch.models import mvs as tmvs
from panogrf_tpu_torch.models.unifuse import Equi as TEqui, UniFuse as TUniFuse
from panogrf_tpu_torch.nn import blocks as tblocks
from panogrf_tpu_torch.nn import fusion as tfusion
from panogrf_tpu_torch.nn.resnet import ResNetEncoder as TResNet
from panogrf_tpu_torch.ops import cost_volume as tcv_ops
from panogrf_tpu_torch.ops import resample as tres
from panogrf_tpu_torch.utils import from_jax
from torch_port_threads import one_torch_thread  # noqa: F401

MH, MW = 64, 128                 # UniFuse minimum (cube fusion at 1/32)
DH, DW = 32, 64                  # MVS working resolution
MVS_KW = {"num_hypotheses": 8, "magnet_num_samples": 3, "cnn3d_base": 8}
REL = 1e-4


def assert_close(got, want, rel=REL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


def seeded(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded weights and random BatchNorm statistics; eval mode."""
    tblocks.init_parameters_(module, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.num_features, generator=g)
                                 * 0.2)
            m.running_var.copy_(torch.rand(m.num_features, generator=g)
                                + 0.5)
    return module.eval()


def numpy_sd(module: torch.nn.Module) -> dict:
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def same_tree(a: dict, b: dict) -> None:
    fa = dict(jax.tree_util.tree_leaves_with_path(a))
    fb = dict(jax.tree_util.tree_leaves_with_path(b))
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(fb[k]),
                                      err_msg=jax.tree_util.keystr(k))


def jit_apply(module, variables, *args):
    return jax.tree.map(np.asarray, jax.jit(module.apply)(variables, *args))


# ---------------------------------------------------------------------------
# geometry, resampling, resize
# ---------------------------------------------------------------------------

def test_sphere_center_mode_matches_jax():
    rng = np.random.default_rng(0)
    j, t = jconv("m3d"), tconv("m3d")
    xy = rng.uniform(-2, 70, size=(50, 2)).astype(np.float32)
    pts = rng.normal(size=(40, 3)).astype(np.float32)

    @jax.jit
    def reference(xy, pts):
        sph = j.equi_to_spherical(xy, 32, 64, mode="center")
        return (sph, j.spherical_to_equi(sph, 32, 64, mode="center"),
                j.ray_directions(16, 32, mode="center"),
                *j.project_to_pixels(pts, 32, 64, mode="center"))
    sph_j, xy_j, dirs_j, uv_j, d_j = reference(xy, pts)
    sph_t = t.equi_to_spherical(torch.tensor(xy), 32, 64, mode="center")
    assert_close(sph_t, sph_j, 1e-6)
    assert_close(t.spherical_to_equi(torch.tensor(np.asarray(sph_j)), 32, 64,
                                     mode="center"), xy_j, 1e-6)
    assert_close(t.ray_directions(16, 32, mode="center"), dirs_j, 1e-6)
    uv_t, d_t = t.project_to_pixels(torch.tensor(pts), 32, 64, mode="center")
    assert_close(uv_t, uv_j, 1e-6)
    assert_close(d_t, d_j, 1e-6)
    with pytest.raises(ValueError):
        t.equi_to_spherical(torch.tensor(xy), 32, 64, mode="edge")


def test_bilinear_border_x_matches_jax():
    """wrap_x=False: x clamped, the padded column is column W-1; points on
    and past both borders, on integer columns and at x = W-1 exactly."""
    rng = np.random.default_rng(1)
    img = rng.normal(size=(6, 9, 4)).astype(np.float32)
    xy = np.concatenate([rng.uniform(-3, 12, size=(200, 2)),
                         [[8.0, 2.5], [8.0, 5.0], [0.0, 0.0], [7.0, 6.0],
                          [9.5, -1.0], [-0.5, 3.25]]]).astype(np.float32)
    want = jres.bilinear_sample(jnp.asarray(img), jnp.asarray(xy),
                                wrap_x=False, pad_mode="border")
    got = tres.bilinear_sample(torch.tensor(img), torch.tensor(xy),
                               wrap_x=False)
    assert_close(got, want, 1e-6)
    # the zeros pad mode: points more than a pixel outside the map are 0
    want = jres.bilinear_sample(jnp.asarray(img), jnp.asarray(xy),
                                wrap_x=False, pad_mode="zeros")
    got = tres.bilinear_sample(torch.tensor(img), torch.tensor(xy),
                               wrap_x=False, pad_mode="zeros")
    assert_close(got, want, 1e-6)


def test_resize_linear_three_axes_matches_jax():
    """The UNet3D's trilinear upsample: align_corners=False over (D, H, W),
    up and down, and the 2x nearest upsample."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 5, 7, 4)).astype(np.float32)
    for sizes in ((6, 10, 14), (2, 4, 3)):
        want = jax.jit(lambda a: jblocks.resize_linear(
            a, sizes, axes=(1, 2, 3), align_corners=False))(jnp.asarray(x))
        got = tblocks.resize_linear(torch.tensor(x), sizes, axes=(1, 2, 3))
        assert_close(got, want, 1e-6, sizes)
    assert_close(tblocks.upsample2x_nearest(torch.tensor(x[:, 0])),
                 jblocks.upsample2x_nearest(jnp.asarray(x[:, 0])), 0)


# ---------------------------------------------------------------------------
# cubemap
# ---------------------------------------------------------------------------

def test_cubemap_matches_jax():
    rng = np.random.default_rng(3)
    equi = rng.uniform(size=(2, 32, 64, 5)).astype(np.float32)
    faces = rng.normal(size=(2, 6, 16, 16, 3)).astype(np.float32)
    want_cube, want_erp = jax.jit(lambda e, f: (
        jax.vmap(lambda x: jcube.equi_to_cube(x, 16))(e),
        jax.vmap(lambda x: jcube.cube_to_equi(x, 32, 64))(f)))(equi, faces)
    assert_close(tcube.equi_to_cube(torch.tensor(equi), 16), want_cube, 1e-6)
    assert_close(tcube.cube_to_equi(torch.tensor(faces), 32, 64), want_erp,
                 1e-6)
    np.testing.assert_array_equal(tcube.zdepth_cosine(16),
                                  np.asarray(jcube.zdepth_cosine(16)))
    strip = tcube.stacked_to_strip(torch.tensor(faces[0]))
    np.testing.assert_array_equal(
        strip.numpy(), np.asarray(jcube.stacked_to_strip(jnp.asarray(
            faces[0]))))
    np.testing.assert_array_equal(tcube.strip_to_stacked(strip, 16).numpy(),
                                  faces[0])


# ---------------------------------------------------------------------------
# conv blocks, encoders, fusion
# ---------------------------------------------------------------------------

def _conv(m) -> dict:
    p = {"kernel": (tcv.t2f_conv3d if m.weight.dim() == 5 else tcv.t2f_conv)(
        m.weight.detach().numpy())}
    if m.bias is not None:
        p["bias"] = m.bias.detach().numpy()
    return {"Conv_0": p}


@pytest.mark.parametrize("upscale,act", [(True, True), (False, False)])
def test_conv_block2_matches_jax(upscale, act):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 8, 16, 6)).astype(np.float32)
    tm = seeded(tblocks.ConvBlock2(6, 5, upscale=upscale, use_activation=act,
                                   pool=not upscale), 4)
    params = {"WrapConv_0": _conv(tm.conv1), "WrapConv_1": _conv(tm.conv2)}
    jm = jblocks.ConvBlock2(5, upscale=upscale, use_activation=act,
                            pool=not upscale)
    want = jit_apply(jm, {"params": params}, jnp.asarray(x))
    got = tm(torch.tensor(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        assert_close(g.permute(0, 2, 3, 1), w)


def test_unet3d_matches_jax():
    """UNet3D (and so Conv3DBlock and WrapConv3D): no skip into the first
    decoder, the deepest skip unread, decoders[j] returning to level j."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 8, 8, 16, 6)).astype(np.float32)   # NDHWC
    tm = seeded(tblocks.UNet3D(6, 4, 3, 1), 5)
    u3 = {}
    for i in range(4):
        u3[f"Conv3DBlock_{i}"] = {
            f"WrapConv3D_{c}": _conv(getattr(tm.encoders[i], f"conv{c + 1}"))
            for c in range(2)}
    for j, tdec in enumerate((2, 1, 0)):
        u3[f"Conv3DBlock_{4 + j}"] = {
            f"WrapConv3D_{c}": _conv(getattr(tm.decoders[tdec],
                                             f"conv{c + 1}"))
            for c in range(2)}
    want = jit_apply(jblocks.UNet3D(base_features=4, num_layers=3),
                     {"params": u3}, jnp.asarray(x))
    got = tm(torch.tensor(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    assert_close(got, want)


@pytest.mark.parametrize("wrap", [True, False])
def test_resnet_encoder_matches_jax(wrap):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, MH, MW, 3)).astype(np.float32)
    tm = seeded(TResNet(wrap=wrap), 6)
    p, s = tcv.convert_resnet_encoder({f"e.{k}": v for k, v in
                                       numpy_sd(tm).items()}, "e")
    want = jit_apply(JResNet(wrap=wrap), {"params": p, "batch_stats": s},
                     jnp.asarray(x))
    got = tm(torch.tensor(x).permute(0, 3, 1, 2))
    assert len(got) == 5
    for g, w in zip(got, want):
        assert_close(g.permute(0, 2, 3, 1), w)


@pytest.mark.parametrize("kind", ["cee", "cat", "biproj"])
def test_fusion_layers_match_jax(kind):
    rng = np.random.default_rng(7)
    e, c = (rng.normal(size=(2, 8, 16, 32)).astype(np.float32)
            for _ in range(2))
    tm = seeded(tfusion.make_fusion(kind, 32), 7)
    sd = {f"f.{k}": v for k, v in numpy_sd(tm).items()}
    stats = {}
    if kind == "cee":
        params, stats = tcv._convert_cee(sd, "f")
    elif kind == "cat":
        params = {"Conv_0": {"kernel": tcv.t2f_conv(sd["f.conv.weight"])}}
    else:
        params = {n: {"kernel": tcv.t2f_conv(sd[f"f.{n}.0.weight"]),
                      "bias": sd[f"f.{n}.0.bias"]}
                  for n in ("conv_e2c", "conv_c2e", "conv_mask")}
    want = jfusion.make_fusion(kind, 32).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(e),
        jnp.asarray(c))
    got = tm(torch.tensor(e).permute(0, 3, 1, 2),
             torch.tensor(c).permute(0, 3, 1, 2))
    assert_close(got.permute(0, 2, 3, 1), want)


# ---------------------------------------------------------------------------
# UniFuse, Equi
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def unifuse():
    """(port UniFuse, its JAX variables) with seeded weights."""
    tm = seeded(TUniFuse(), 10)
    variables = tcv.convert_unifuse(numpy_sd(tm))
    equi = jnp.zeros((1, MH, MW, 3))
    shapes = jax.eval_shape(JUniFuse().init, jax.random.PRNGKey(0), equi,
                            jnp.zeros((1, 6, MH // 2, MH // 2, 3)))
    for col in ("params", "batch_stats"):
        assert tcv.verify_tree_shapes(variables[col], shapes[col]) == []
    return tm, variables


def test_unifuse_matches_jax(unifuse):
    tm, variables = unifuse
    rng = np.random.default_rng(11)
    equi = rng.normal(size=(2, MH, MW, 3)).astype(np.float32)
    cube = tcube.equi_to_cube(torch.tensor(equi), MH // 2)
    want = jit_apply(JUniFuse(), variables, jnp.asarray(equi),
                     jnp.asarray(cube.numpy()))
    with torch.no_grad():
        got = tm(torch.tensor(equi), cube)
    for k in ("pred_depth", "mono_feat"):
        assert_close(got[k], want[k], what=k)
    assert got["mono_feat"].shape == (2, MH // 2, MW // 2, 32)


def test_unifuse_state_dict_round_trip(unifuse):
    """JAX variables -> unifuse_state_dict -> port module -> state_dict()
    -> convert_unifuse gives the same tree back."""
    _, variables = unifuse
    tm = from_jax.load_jax_params(TUniFuse(), variables)
    same_tree(tcv.convert_unifuse(numpy_sd(tm)), variables)
    assert all(tm.state_dict()[k] == 0 for k in tm.state_dict()
               if k.endswith("num_batches_tracked"))


def test_equi_matches_jax():
    tm = seeded(TEqui(), 12)
    p, s = tcv.convert_equi({f"unet.{k}": v for k, v in
                             numpy_sd(tm).items()}, "unet")
    x = np.random.default_rng(12).uniform(size=(2, DH, DW, 3)) \
        .astype(np.float32)
    want = jit_apply(JEqui(), {"params": p, "batch_stats": s},
                     jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.tensor(x))
    assert got.shape == (2, DH // 4, DW // 4, 32)
    assert_close(got, want)


# ---------------------------------------------------------------------------
# hypotheses, sweep, MVS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("uniform_in_depth,sigma_map",
                         [(True, False), (False, True)])
def test_depth_hypotheses_match_jax(uniform_in_depth, sigma_map):
    rng = np.random.default_rng(13)
    np.testing.assert_array_equal(tmvs.magnet_k_list(5, 3.0),
                                  jmvs.magnet_k_list(5, 3.0))
    mu = rng.uniform(0.0, 11.0, size=(2, 8, 16, 1)).astype(np.float32)
    sig = rng.uniform(0.1, 1.0, size=mu.shape).astype(np.float32)
    ks = jmvs.magnet_k_list(5, 3.0)
    want = jmvs.build_depth_hypotheses(
        jnp.asarray(mu), ks, 64, 0.1, 10.0,
        jnp.asarray(sig) if sigma_map else 0.5, uniform_in_depth)
    got = tmvs.build_depth_hypotheses(
        torch.tensor(mu), ks, 64, 0.1, 10.0,
        torch.tensor(sig) if sigma_map else 0.5, uniform_in_depth)
    assert got.shape == (2, 64, 8, 16)
    assert bool((got[:, 1:] >= got[:, :-1]).all())
    assert_close(got, want, 1e-6)


def _sweep_inputs(seed):
    rng = np.random.default_rng(seed)
    h, w, d, c = 8, 16, 6, 5
    ref, src = (rng.normal(size=(h, w, c)).astype(np.float32)
                for _ in range(2))
    dvol = rng.uniform(0.3, 8.0, size=(d, h, w)).astype(np.float32)
    ang = rng.uniform(-0.3, 0.3, size=2)
    rots = []
    for a in ang:
        ca, sa = np.cos(a), np.sin(a)
        rots.append(np.asarray([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]],
                               np.float32))
    trans = rng.normal(scale=0.5, size=(2, 3)).astype(np.float32)
    return ref, src, dvol, rots, trans


def test_sweep_matches_jax():
    """The sweep's coordinates agree to 1e-4 px (a floor near an integer
    coordinate may fall on either side between the packages); the warped
    features agree to 1e-6 when both samplers read the same coordinates,
    and the whole costs on average."""
    ref, src, dvol, rots, trans = _sweep_inputs(14)
    h, w = ref.shape[:2]
    jc, tc = jconv("m3d"), tconv("m3d")
    costs = ("abs_diff", "dot", "none")

    @jax.jit
    def reference(ref, src, dvol, r_ref, t_ref, r_src, t_src):
        uv, dist = jcv.sweep_coordinates(dvol, jcv.dirs_for(jc, h, w), r_ref,
                                         t_ref, r_src, t_src, jc, h, w)
        return uv, dist, jres.bilinear_sample(src, uv), [
            jcv.spherical_sweep_cost(ref, src, dvol, r_ref, t_ref, r_src,
                                     t_src, jc, cost_type=c) for c in costs]
    args = (ref, src, dvol, rots[1], trans[1], rots[0], trans[0])
    uv_j, dist_j, warped_j, costs_j = jax.tree.map(np.asarray,
                                                   reference(*args))
    args_t = [torch.tensor(a) for a in args]
    uv_t, dist_t = tcv_ops.sweep_coordinates(
        args_t[2], tcv_ops.dirs_for(tc, h, w), *args_t[3:], tc, h, w)
    assert float(np.abs(uv_t.numpy() - uv_j).max()) <= 1e-4
    assert_close(dist_t, dist_j, 1e-5)
    assert_close(tres.bilinear_sample(args_t[1], torch.tensor(uv_j)),
                 warped_j, 1e-6)
    for cost, want in zip(costs, costs_j):
        got = tcv_ops.spherical_sweep_cost(*args_t, tc, cost_type=cost)
        assert got.shape == (dvol.shape[0], h, w, ref.shape[-1])
        assert float(np.mean(np.abs(got.numpy() - want))) <= 1e-4
    with pytest.raises(ValueError):
        tcv_ops.spherical_sweep_cost(*args_t, tc, cost_type="l2")


def test_batched_sweep_matches_per_pair():
    ref, src, dvol, rots, trans = _sweep_inputs(15)
    tc = tconv("m3d")
    r = torch.tensor(np.stack(rots))[None].repeat(2, 1, 1, 1)
    t = torch.tensor(trans)[None].repeat(2, 1, 1)
    got = tcv_ops.batched_sweep_cost(
        torch.tensor(ref)[None].repeat(2, 1, 1, 1),
        torch.tensor(src)[None].repeat(2, 1, 1, 1),
        torch.tensor(dvol)[None].repeat(2, 1, 1, 1), r, t, tc)
    one = tcv_ops.spherical_sweep_cost(
        torch.tensor(ref), torch.tensor(src), torch.tensor(dvol), r[0, 1],
        t[0, 1], r[0, 0], t[0, 0], tc)
    for b in range(2):
        np.testing.assert_allclose(got[b].numpy(), one.numpy(), atol=1e-6)


def _mvs_inputs(seed):
    rng = np.random.default_rng(seed)
    panos = rng.uniform(size=(2, 2, DH, DW, 3)).astype(np.float32)
    rots = np.broadcast_to(np.eye(3, dtype=np.float32), (2, 2, 3, 3)).copy()
    trans = np.zeros((2, 2, 3), np.float32)
    trans[:, 0, 2] = 0.6
    trans[:, 0, 0] = -0.2
    mono_depth = rng.uniform(0.5, 8.0, size=(2, MH, MW, 1)).astype(np.float32)
    mono_feat = rng.normal(size=(2, MH // 2, MW // 2, 32)).astype(np.float32)
    return panos, rots, trans, mono_depth, mono_feat


def mvs_variables(tm) -> dict:
    return tcv.convert_mvs(numpy_sd(tm))


@pytest.mark.parametrize("uncertainty", [False, True])
def test_mvs_model_matches_jax(uncertainty):
    kw = {**MVS_KW, "mvs_uncertainty": uncertainty}
    tm = seeded(tmvs.MVSDepthModel(**kw), 16)
    variables = mvs_variables(tm)
    inputs = _mvs_inputs(16)
    shapes = jax.eval_shape(jmvs.MVSDepthModel(**kw).init,
                            jax.random.PRNGKey(0), *inputs)
    for col in ("params", "batch_stats"):
        assert tcv.verify_tree_shapes(variables[col], shapes[col]) == []
    want = jit_apply(jmvs.MVSDepthModel(**kw), variables,
                     *map(jnp.asarray, inputs))
    with torch.no_grad():
        got = tm(*map(torch.tensor, inputs))
    keys = ["depth", "rectified_depth_d1", "cost_reg", "depth_volume"] + (
        ["pred_final"] if uncertainty else [])
    for k in keys:
        assert_close(got[k], want[k], what=k)
    assert got["depth"].shape == (2, DH, DW, 1)
    assert got["cost_reg"].shape == (2, 8, DH // 4, DW // 4)


def test_mvs_state_dict_round_trip():
    tm = seeded(tmvs.MVSDepthModel(**MVS_KW), 17)
    variables = mvs_variables(tm)
    back = from_jax.load_jax_params(tmvs.MVSDepthModel(**MVS_KW), variables)
    same_tree(tcv.convert_mvs(numpy_sd(back)), variables)


# ---------------------------------------------------------------------------
# the composed stack and its checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stacks(unifuse):
    """(port stack, JAX stack) with the same weights; and the JAX MVS
    variables."""
    tmono, mono_vars = unifuse
    tm = seeded(tmvs.MVSDepthModel(**MVS_KW), 18)
    mvs_vars = mvs_variables(tm)
    tstack = tds.DepthStack(tmono, tm, (MH, MW), (DH, DW))
    jstack = jds.DepthStack(JUniFuse(), mono_vars,
                            jmvs.MVSDepthModel(**MVS_KW), mvs_vars,
                            (MH, MW), (DH, DW))
    return tstack, jstack, mvs_vars


@pytest.fixture(scope="module")
def sample():
    js = jsyn.make_three_view_sample(jsyn.SphereScene.random(21), DH, DW,
                                     m3d_dist=0.3, seed=3)
    return js, {k: torch.tensor(np.asarray(v)) for k, v in js.items()}


@pytest.mark.parametrize("wo_stereo", [False, True])
def test_depth_stack_matches_jax(stacks, sample, wo_stereo):
    tstack, jstack, _ = stacks
    js, ts = sample
    if wo_stereo:
        tstack = tds.DepthStack(tstack.mono_model, None, (MH, MW), (DH, DW),
                                wo_stereo=True)
        jstack = jds.DepthStack(jstack.mono_model, jstack.mono_params, None,
                                None, (MH, MW), (DH, DW), wo_stereo=True)
    want = jax.tree.map(np.asarray, jds.stack_depth_for_sample(
        jstack.jitted(), js, jinfo.REF_IDS, jinfo.SRC_IDS))
    got = tds.stack_depth_for_sample(tstack, ts, jinfo.REF_IDS,
                                     jinfo.SRC_IDS)
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], what=k)
    assert got["mvs_depth"].shape == (2, DH, DW, 1)
    assert bool((got["mvs_depth"] >= 0).all())
    assert not got["mvs_depth"].requires_grad


def test_depth_stack_is_frozen(stacks):
    tstack = stacks[0]
    assert not tstack.training and not tstack.mono_model.training
    assert not tstack.mvs_model.training
    assert not any(p.requires_grad for p in tstack.parameters())


def test_load_depth_stack_reads_reference_files(stacks, sample, tmp_path):
    """A UniFuse file in the reference layout (``model_state_dict`` with
    ``module.`` prefixes) and an MVS file holding its mono net under
    ``d_net.*`` load with no conversion step and give the JAX stack's
    depth."""
    tstack, jstack, mvs_vars = stacks
    _, ts = sample
    mono_sd = from_jax.unifuse_state_dict(jstack.mono_params)
    torch.save({"model_state_dict": {f"module.{k}": v
                                     for k, v in mono_sd.items()},
                "epoch": 3}, tmp_path / "mono.pth")
    mvs_sd = from_jax.mvs_state_dict(mvs_vars)
    torch.save({"model": {**mvs_sd, **{f"d_net.{k}": v
                                       for k, v in mono_sd.items()}}},
               tmp_path / "mvs.tar")
    want = tds.stack_depth_for_sample(tstack, ts, jinfo.REF_IDS)
    for mono in (str(tmp_path / "mono.pth"), None):
        loaded = tds.load_depth_stack(mono, str(tmp_path / "mvs.tar"),
                                      (MH, MW), (DH, DW), mvs_kwargs=MVS_KW,
                                      device="cpu")
        got = tds.stack_depth_for_sample(loaded, ts, jinfo.REF_IDS)
        np.testing.assert_array_equal(got["mvs_depth"].numpy(),
                                      want["mvs_depth"].numpy())
    # a mono checkpoint alone: the MVS net is skipped, as in the JAX package
    mono_only = tds.load_depth_stack(str(tmp_path / "mono.pth"), None,
                                     (MH, MW), (DH, DW), device="cpu")
    assert mono_only.mvs_model is None and mono_only.wo_stereo
    assert tds.load_depth_stack(None, None, (MH, MW), (DH, DW),
                                random_mvs=True, mvs_kwargs=MVS_KW,
                                device="cpu").mvs_model is not None
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="not readable by the port"):
        tds.load_depth_stack(str(tmp_path / "orbax"), device="cpu")
    torch.save({"model_state_dict": {"equi_encoder.conv1.weight":
                                     torch.zeros(64, 3, 7, 7)}},
               tmp_path / "partial.pth")
    with pytest.raises(KeyError, match="lacks"):
        tds.load_depth_stack(str(tmp_path / "partial.pth"), device="cpu")
