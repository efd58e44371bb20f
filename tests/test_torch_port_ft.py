"""Port parity for per-scene finetuning: the sampling utilities, the split
gather of ``project_points_dict``, the ft renderer (its initialisation from
the gen renderer, its forward with and without depth guidance and its
gradients, the ray features' included), the cached-depth prior, the ft
losses, the two-group Adam, the ft checkpoint's layout and the
``train_ft`` / ``render_ft`` CLIs (CPU, float32).

Shapes: 32x64 render, 32x64 depth (ray features 8x16), 32 + 32 samples,
16 rays of a procedural 3-view scene, the query a reference view as in
``train_ft``; the rays keep off the image's border and its middle column
(the cameras sit on one axis: there the views' longitude seams lie).
Weights come from JAX ``init`` of the gen renderer, carried over by
``init_ft_params_from_gen`` and ``load_jax_params``.  The port's sampling
draws are replaced by JAX's; the ft fine pass draws once and hands the
same uniforms to its hierarchical and its depth-guided samples, as the
JAX module's one key does.  The JAX step runs in float64, the port's in
float32 (see ``test_torch_port_mv.py``), both at JAX's float32 uniform
draws.  Tolerances: outputs and losses 1e-4, gradients 1e-2 of each
parameter's largest plus 1e-6 of the tree's largest
(``test_torch_port_train.py``'s).  One exception: a fine depth drawn in a
bin of near-zero probability (the CDF's 1e-5 floor) is ill-conditioned
in the CDF, whose float32 cumulative sum the two packages round
differently.  ``ill_conditioned`` flags the samples that the rounding of
that sum can move by more than 1e-4 (one of 512 here, where the port's
float32 depth is 2.2e-4 off float64 JAX); their depths, colours and
densities are held to 1e-3, every other sample to 1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from panogrf_tpu.core.sphere import get_convention as jconv
from panogrf_tpu.data import imgs_info as jinfo
from panogrf_tpu.data import synthetic as jsyn
from panogrf_tpu.renderer import render_ops as jro
from panogrf_tpu.renderer import sample_utils as jsu
from panogrf_tpu.renderer.ft_renderer import NeuralRayFtRenderer as JFT
from panogrf_tpu.renderer.ft_renderer import ft_depth_range_at_coords as jfdr
from panogrf_tpu.renderer.ft_renderer import init_ft_params_from_gen as jinit
from panogrf_tpu.renderer.renderer import NeuralRayGenRenderer as JR
from panogrf_tpu.train import ft_losses as jfl
from panogrf_tpu.train import losses as jl
from panogrf_tpu.utils import torch_convert as tcv
from panogrf_tpu_torch.core.sphere import get_convention as tconv
from panogrf_tpu_torch.renderer import render_ops as tro
from panogrf_tpu_torch.renderer import sample_utils as tsu
from panogrf_tpu_torch.renderer.ft_renderer import NeuralRayFtRenderer as TFT
from panogrf_tpu_torch.renderer.ft_renderer import ft_depth_range_at_coords
from panogrf_tpu_torch.renderer.ft_renderer import init_ft_params_from_gen
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer as TR
from panogrf_tpu_torch.tools import render_ft, train_ft
from panogrf_tpu_torch.train import ft_losses as tfl
from panogrf_tpu_torch.train import losses as tl
from panogrf_tpu_torch.train import trainer as ttr
from panogrf_tpu_torch.utils.from_jax import (ft_renderer_state_dict,
                                              load_jax_params)
from torch_port_parity import (OUT_TOL, assert_grads_close, f32_uniform,
                               ill_conditioned, inject_uniform,
                               off_seam_coords, seeded_renderer_params,
                               template_init, to_f64, to_torch)
from torch_port_threads import one_torch_thread  # noqa: F401

H, W, DH, DW, DN, RN = 32, 64, 32, 64, 32, 16
ILL_CONDITIONED_TOL = dict(atol=1e-3, rtol=1e-3)
FINE_SAMPLE_KEYS = ("que_depth_fine", "colors_nr_fine", "density_nr_fine")
REPO = __import__("pathlib").Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# sampling utilities and the split gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("random", [False, True])
def test_sample_utils_match_jax(monkeypatch, random):
    rng = np.random.default_rng(0)
    bins = np.sort(rng.uniform(0.5, 8.0, (3, 5, 9)), -1).astype(np.float32)
    weights = (rng.uniform(size=(3, 5, 8)) ** 3).astype(np.float32)
    key = jax.random.PRNGKey(3) if random else None
    n = 12
    want = jsu.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), n, key)
    draws = [jax.random.uniform(key, (3, 5, n))] if random else []
    low = rng.uniform(0.2, 3.0, (3, 5)).astype(np.float32)
    high = low + rng.uniform(0.1, 2.0, (3, 5)).astype(np.float32)
    want3 = jsu.sample_3sigma(jnp.asarray(low), jnp.asarray(high), n, 0.5,
                              4.0, key)
    draws += [jax.random.uniform(key, (3, 5, n))] if random else []
    queue = inject_uniform(monkeypatch, draws)
    g = torch.Generator() if random else None
    got = tsu.sample_pdf(torch.tensor(bins), torch.tensor(weights), n, g)
    got3 = tsu.sample_3sigma(torch.tensor(low), torch.tensor(high), n, 0.5,
                             4.0, g)
    assert not queue
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got3.numpy(), np.asarray(want3), rtol=1e-5,
                               atol=1e-5)
    # the same draws handed in as u
    if random:
        u = torch.tensor(np.asarray(draws[0]))
        np.testing.assert_allclose(
            tsu.sample_pdf(torch.tensor(bins), torch.tensor(weights), n,
                           u=u).numpy(), np.asarray(want), rtol=1e-5,
            atol=1e-5)
        z = np.sort(rng.uniform(0.5, 9.0, (2, 4, 7)), -1).astype(np.float32)
        inject_uniform(monkeypatch, [jax.random.uniform(key, z.shape)])
        np.testing.assert_allclose(
            tsu.perturb_z_vals(torch.tensor(z), g).numpy(),
            np.asarray(jsu.perturb_z_vals(jnp.asarray(z), key)), rtol=1e-6)
    d = rng.uniform(1, 5, (2, 6)).astype(np.float32)
    s = rng.uniform(0.01, 0.5, (2, 6)).astype(np.float32)
    np.testing.assert_allclose(
        tsu.precompute_depth_sampling(torch.tensor(d),
                                      torch.tensor(s)).numpy(),
        np.asarray(jsu.precompute_depth_sampling(jnp.asarray(d),
                                                 jnp.asarray(s))), rtol=1e-6)
    np.testing.assert_allclose(
        tsu.precompute_quadratic_samples(0.5, 15.0, 9).numpy(),
        np.asarray(jsu.precompute_quadratic_samples(0.5, 15.0, 9)),
        rtol=1e-6)


@pytest.mark.parametrize("depth_major", [False, True])
def test_split_gather_matches_jax(depth_major):
    """``project_points_dict`` without a merged map: rgb from ``imgs``, ray
    and image features each from its own map (8x16 and 16x32 here)."""
    rng = np.random.default_rng(1)
    rfn, qn, rn, dn = 2, 1, 6, 5
    ref = {"imgs": rng.uniform(size=(rfn, H, W, 3)),
           "ray_feats": rng.normal(size=(rfn, H // 4, W // 4, 32)),
           "img_feats": rng.normal(size=(rfn, H // 2, W // 2, 16)),
           "w2c": np.stack([np.eye(3, 4), np.concatenate(
               [np.eye(3), [[0.3], [0.1], [0.5]]], 1)])}
    ref = {k: v.astype(np.float32) for k, v in ref.items()}
    pts = rng.normal(size=(qn, rn, dn, 3)).astype(np.float32) * 3
    qdir = rng.normal(size=(qn, rn, dn, 3)).astype(np.float32)
    want = jro.project_points_dict(jax.tree.map(jnp.asarray, ref),
                                   jnp.asarray(pts), jconv("m3d"),
                                   que_dir=jnp.asarray(qdir),
                                   depth_major=depth_major)
    got = tro.project_points_dict(to_torch(ref), torch.tensor(pts),
                                  tconv("m3d"), torch.tensor(qdir),
                                  depth_major=depth_major)
    assert set(got) == set(want)
    for k in want:
        if k == "layout":
            assert got[k] == want[k]
            continue
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# the ft renderer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ft_setup():
    """The JAX gen renderer (JAX ``init``), the ft renderer initialised
    from it, and one float64 JAX step of the ft renderer on a reference
    view as the query: value_and_grad of the render loss with depth
    guidance (three rays of the cached depth below min_depth take the
    hierarchical samples), and the forward without it."""
    js = jax.tree.map(np.asarray, jsyn.make_three_view_sample(
        jsyn.SphereScene.random(6), H, W, 0.5, seed=6))
    coords = off_seam_coords(np.random.default_rng(2), RN, H, W)
    data = jinfo.build_render_sample(js, jnp.asarray(coords))
    data.pop("src_imgs_info")
    data["ref_imgs_info"]["mvs_depth"] = jnp.asarray(
        js["depth_panos"][list(jinfo.REF_IDS)])
    gen_kw = dict(height=H, width=W, depth_hw=(DH, DW), depth_sample_num=DN,
                  fine_depth_sample_num=DN)
    gen = JR(**gen_kw)
    gen_params = seeded_renderer_params(**gen_kw)
    ft = JFT(rfn=2, ray_feats_hw=(DH // 4, DW // 4), height=H, width=W,
             depth_sample_num=DN, fine_depth_sample_num=DN)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFT, "init", template_init)
        ft_params, cache = jinit(ft, gen, gen_params, data["ref_imgs_info"],
                                 jax.random.PRNGKey(1), data)
    ft_params = jax.tree.map(np.asarray, ft_params)
    init_params = jax.tree.map(np.copy, ft_params)
    # a positive density bias gives the fine pass density (and gradients)
    for n in ("agg_net", "fine_agg_net"):
        ft_params["params"][n]["agg_impl"]["out_geometry_fc"]["b1"] = \
            np.full((1,), 0.5, np.float32)
    c2w = np.asarray(jinfo.c2w_from_w2c(jinfo.pose_w2c(
        js["rots"], js["trans"])))
    fdr = np.array(jfdr(cache, 0, jnp.asarray(coords), H, W))
    fdr[0, :3] = [0.3, 0.1, 0.5]
    batch = {"ref_imgs_info": dict(data["ref_imgs_info"]),
             "que_imgs_info": {"coords": coords, "c2w": c2w[0],
                               "depth_range": np.asarray([[0.5, 15.0]]),
                               "imgs": js["rgb_panos"][:1],
                               "ft_depth_range": fdr}}
    batch["ref_imgs_info"].pop("mvs_depth")
    key = jax.random.PRNGKey(4)
    plain = {k: dict(v) for k, v in batch.items()}
    plain["que_imgs_info"].pop("ft_depth_range")
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        f32_uniform(mp)

        def loss_fn(p):
            out = ft.apply(p, to_f64(batch), rng=key)
            return jl.total_loss(jl.render_loss(out, to_f64(batch))), out
        (loss, out), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(to_f64(ft_params))
        out_plain = jax.jit(lambda p: ft.apply(p, to_f64(plain), rng=key))(
            to_f64(ft_params))
        r_coarse, r_fine = jax.random.split(key)
        draws = [np.asarray(jax.random.uniform(r_coarse, (1, RN, DN - 2)),
                            np.float32),
                 np.asarray(jax.random.uniform(r_fine, (1, RN, DN)),
                            np.float32)]

    # the guided rays take sample_3sigma's samples, the others the
    # hierarchical ones of the forward without guidance
    guided_rays = (fdr[..., 0] >= ft.min_depth)[..., None]
    ill = ill_conditioned(*(np.asarray(out_plain[k]) for k in (
        "que_depth", "hit_prob_nr", "que_depth_fine")))
    f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
    return dict(gen=gen, gen_params=gen_params, ft=ft, params=ft_params,
                init_params=init_params, cache=cache, data=data,
                batch=batch, plain=plain, draws=draws, loss=float(loss),
                out={True: f32(out), False: f32(out_plain)},
                ill_conditioned={True: ill & ~guided_rays, False: ill},
                grads=f32(grads["params"]))


def _port_ft(params):
    return load_jax_params(TFT(rfn=2, ray_feats_hw=(DH // 4, DW // 4),
                               height=H, width=W, depth_sample_num=DN,
                               fine_depth_sample_num=DN, device="cpu"),
                           params)


def test_ft_init_from_gen_matches_jax(ft_setup):
    """The ray features are the gen init net's output on the references,
    the shared submodules the gen weights; the cache holds mvs_depth."""
    gen = load_jax_params(TR(height=H, width=W, depth_hw=(DH, DW),
                             depth_sample_num=DN, fine_depth_sample_num=DN,
                             device="cpu"), ft_setup["gen_params"])
    ft = TFT(rfn=2, ray_feats_hw=(DH // 4, DW // 4), height=H, width=W,
             depth_sample_num=DN, fine_depth_sample_num=DN, device="cpu")
    ref_info = to_torch(ft_setup["data"]["ref_imgs_info"])
    cache = init_ft_params_from_gen(ft, gen, ref_info)
    assert set(cache) == set(ft_setup["cache"]) == {"mvs_depth"}
    np.testing.assert_array_equal(cache["mvs_depth"].numpy(),
                                  np.asarray(ft_setup["cache"]["mvs_depth"]))
    want = ft_renderer_state_dict(ft_setup["init_params"])
    got = ft.state_dict()
    assert set(got) == set(want)
    assert not any(k.startswith("init_net.") for k in got)
    assert got["ray_feats.1"].shape == (1, 32, DH // 4, DW // 4)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    bad = TFT(rfn=2, ray_feats_hw=(3, 5), height=H, width=W, device="cpu")
    with pytest.raises(ValueError, match="ray features"):
        init_ft_params_from_gen(bad, gen, ref_info)


def _port_forward(monkeypatch, ft_setup, guided):
    queue = inject_uniform(monkeypatch, ft_setup["draws"])
    model = _port_ft(ft_setup["params"])
    batch = to_torch(ft_setup["batch"] if guided else ft_setup["plain"])
    out = model(batch, torch.Generator())
    assert not queue
    return model, batch, out


@pytest.mark.parametrize("guided", [True, False])
def test_ft_forward_matches_jax(monkeypatch, ft_setup, guided):
    _, _, out = _port_forward(monkeypatch, ft_setup, guided)
    want = ft_setup["out"][guided]
    assert set(out) == set(want)
    ill = ft_setup["ill_conditioned"][guided]     # (1, RN, DN)
    assert ill.sum() <= 0.01 * ill.size
    for k in want:
        got, ref = out[k].detach().float().numpy(), want[k]
        if k in FINE_SAMPLE_KEYS:
            np.testing.assert_allclose(got[ill], ref[ill], err_msg=k,
                                       **ILL_CONDITIONED_TOL)
            got, ref = got[~ill], ref[~ill]
        np.testing.assert_allclose(got, ref, err_msg=k, **OUT_TOL)


def test_ft_gradients_match_jax_grad(monkeypatch, ft_setup):
    """The depth-guided step's render loss and every parameter's gradient,
    the ray features' included, against ``jax.grad``."""
    model, batch, out = _port_forward(monkeypatch, ft_setup, True)
    loss = tl.total_loss(tl.render_loss(out, batch))
    np.testing.assert_allclose(loss.item(), ft_setup["loss"], rtol=1e-5)
    loss.backward()
    want = ft_renderer_state_dict(ft_setup["grads"])
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want) and {"ray_feats.0", "ray_feats.1"} <= \
        set(got)
    assert float(got["ray_feats.0"].abs().max()) > 0
    assert_grads_close({k: v.numpy() for k, v in got.items()},
                       {k: v.numpy() for k, v in want.items()})


def test_ft_checkpoint_layout_read_by_jax(ft_setup, tmp_path):
    """The port's ft state dict, saved as ``train_ft`` saves it, gives the
    JAX ray features back through the JAX package's ``extract_ray_feats``
    and loads in ``render_ft``."""
    model = _port_ft(ft_setup["params"])
    path = tmp_path / "model.pth"
    torch.save({"step": 0, "network_state_dict": model.state_dict()}, path)
    sd = {k: v.numpy() for k, v in ttr.load_checkpoint_params(path).items()}
    feats = tcv.extract_ray_feats(sd)
    want = ft_setup["params"]["params"]["ray_feats"]
    assert len(feats) == 2
    for i in range(2):
        np.testing.assert_array_equal(feats[i], want[i])
    loaded = render_ft.load_ft(path, H, W, device="cpu")
    assert tuple(loaded.ray_feats_maps().shape) == want.shape
    assert not loaded.training


@pytest.mark.parametrize("kind", ["uncert", "fixed", "fallback"])
def test_ft_depth_range_at_coords_matches_jax(kind):
    rng = np.random.default_rng(3)
    cache = {"mvs_depth": rng.uniform(0.3, 6, (2, DH // 2, DW // 2, 1))}
    if kind == "uncert":
        cache["mvs_uncert"] = rng.uniform(0, 0.2, (2, DH // 2, DW // 2, 1))
    cache = {k: v.astype(np.float32) for k, v in cache.items()}
    coords = off_seam_coords(rng, 10, H, W)
    sigma = 0.25 if kind == "fixed" else None
    want = jfdr(jax.tree.map(jnp.asarray, cache), 1, jnp.asarray(coords), H,
                W, sigma)
    got = ft_depth_range_at_coords(to_torch(cache), 1, torch.tensor(coords),
                                   H, W, sigma)
    assert got.shape == (1, 10, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# losses and the optimiser
# ---------------------------------------------------------------------------

def test_ft_losses_match_jax():
    rng = np.random.default_rng(5)
    f = lambda *s, lo=0.0, hi=1.0: rng.uniform(lo, hi, s).astype(np.float32)
    mean, var = f(2, 30, lo=0.3, hi=16), f(2, 30, lo=0, hi=0.5)
    m_mean, m_var = f(2, 30, lo=0.3, hi=16), f(2, 30, lo=0.001, hi=0.3)
    tv, hit = np.sort(f(2, 30, 12, lo=0.4, hi=16), -1), f(2, 30, 12)
    wts = f(2, 30)
    arrays = (mean, var, m_mean, m_var, tv, hit, wts)
    J, T = jax.tree.map(jnp.asarray, arrays), to_torch(arrays)

    def close(a, b, tol=1e-5):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=tol,
                                   atol=1e-6)
    np.testing.assert_array_equal(
        tfl.is_not_in_expected_distribution(*T[:4]).numpy(),
        np.asarray(jfl.is_not_in_expected_distribution(*J[:4])))
    for kw in ({}, {"apply_all": True}, {"clip_sigma": 0.3},
               {"weights": "w"}):
        kj = {k: (J[6] if v == "w" else v) for k, v in kw.items()}
        kt = {k: (T[6] if v == "w" else v) for k, v in kw.items()}
        close(jfl.nll_depth_loss(*J[:4], 0.5, 15.0, **kj),
              tfl.nll_depth_loss(*T[:4], 0.5, 15.0, **kt))
    close(jfl.perpoint_depth_loss(J[5], J[4], J[2], J[3], 0.5, 1.5),
          tfl.perpoint_depth_loss(T[5], T[4], T[2], T[3], 0.5, 1.5))
    for a, b in zip(jfl.urf_depth_loss(J[0], J[4], J[5], J[2], J[3], 0.5),
                    tfl.urf_depth_loss(T[0], T[4], T[5], T[2], T[3], 0.5)):
        close(a, b)
    preds = {0: f(2, 16, 32, 3), 1: f(2, 8, 16, 3), 2: f(2, 5, 7, 3)}
    gt = f(2, 16, 32, 3)
    close(jfl.ae_recon_loss(jax.tree.map(jnp.asarray, preds),
                            jnp.asarray(gt)),
          tfl.ae_recon_loss(to_torch(preds), torch.tensor(gt)))
    # depth_ft: every loss type, through NAME2LOSS
    pr = {"render_depth": mean, "render_depth_fine": mean[::-1].copy(),
          "render_uncert": var, "render_uncert_fine": var + 0.1,
          "hit_prob_nr": hit, "hit_prob_nr_fine": hit[::-1].copy(),
          "que_depth": tv, "que_depth_fine": tv}
    for var_key in (True, False):
        gtd = {"que_imgs_info": {"mvs_depth_at_coords": m_mean}}
        if var_key:
            gtd["que_imgs_info"]["mvs_var_at_coords"] = m_var
        for lt in ("mse", "nll", "perpoint", "urf"):
            a = jl.NAME2LOSS["depth_ft"](jax.tree.map(jnp.asarray, pr),
                                         jax.tree.map(jnp.asarray, gtd),
                                         0, loss_type=lt)
            b = tl.NAME2LOSS["depth_ft"](to_torch(pr), to_torch(gtd), 0,
                                         loss_type=lt)
            assert set(a) == set(b) == {"loss_depth_ft",
                                        "loss_depth_ft_fine"}, lt
            for k in a:
                close(a[k], b[k])
    assert tl.NAME2LOSS["depth_ft"](to_torch(pr), {}, 0) == {}
    with pytest.raises(ValueError):
        tfl.depth_ft_loss(to_torch(pr), to_torch(gtd), loss_type="l1")


def test_two_group_adam_matches_optax():
    """Three updates on fixed gradients: ray features at 1e-2, the rest at
    1e-3, against ``optax.multi_transform`` of two ``optax.adam``; within
    rtol 1e-5 and atol 1e-6 (the parameters start at magnitudes up to ~3,
    where a float32 ulp is 2.4e-7)."""
    model = torch.nn.Module()
    g = torch.Generator().manual_seed(6)
    model.ray_feats = torch.nn.ParameterList(
        [torch.nn.Parameter(torch.randn(1, 4, 2, 3, generator=g) * 3)
         for _ in range(2)])
    model.head = torch.nn.Linear(4, 3)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    labels = {k: "ray_feats" if k.startswith("ray_feats.") else "net"
              for k in p0}
    tx = optax.multi_transform({"ray_feats": optax.adam(1e-2),
                                "net": optax.adam(1e-3)}, labels)
    jp = {k: jnp.asarray(v.numpy()) for k, v in p0.items()}
    state = tx.init(jp)
    opt = train_ft.make_optimizer(model, 1e-3, 1e-2)
    assert [g["lr"] for g in opt.param_groups] == [1e-2, 1e-3]
    rng = np.random.default_rng(6)
    for count in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in p0.items()}
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in model.named_parameters():
            p.grad = torch.tensor(g[k])
        opt.step()
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_train_ft_reads_its_recipe():
    """--cfg gives the recipe's defaults and flags win."""
    cfg = str(REPO / "configs/ft/neuray_ft_cv_m3d_diff_mono_uniform.yaml")
    args = train_ft.parse_args(["--cfg", cfg, "--height", str(H),
                                "--steps", "3", "--device", "cpu"])
    assert (args.height, args.width, args.depth_height, args.steps,
            args.lr, args.lr_ray_feats, args.name) == (
        H, 1024, 256, 3, 1e-4, 1e-2, "neuray_ft_m3d_diff_mono_uniform")


def test_train_ft_then_render_ft_cli(tmp_path, monkeypatch):
    """Two depth-guided CPU steps from a gen checkpoint: both groups move,
    the loss is finite, the checkpoint holds the ft layout; then
    ``render_ft`` renders the held-out view and a 1-pose path from it."""
    monkeypatch.chdir(tmp_path)
    gen = TR(height=H, width=W, depth_hw=(DH, DW), device="cpu",
             generator=torch.Generator().manual_seed(8))
    torch.save({"step": 0, "network_state_dict": gen.state_dict()},
               tmp_path / "gen.pth")
    logged = []
    argv = ["--gen-ckpt", str(tmp_path / "gen.pth"), "--steps", "2",
            "--height", str(H), "--width", str(W), "--depth-height",
            str(DH), "--depth-width", str(DW), "--rays", "64",
            "--depth-guided", "--ft-fixed-sigma", "0.3", "--log-interval",
            "1", "--device", "cpu", "--name", "ft_tiny"]
    trainer = train_ft.FtTrainer(train_ft.parse_args(argv),
                                 lambda st, m: logged.append(m["loss"]))
    init = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    # the ft renderer starts from the gen checkpoint
    assert torch.equal(init["agg_net.prob_embed.0.weight"],
                       gen.state_dict()["agg_net.prob_embed.0.weight"])
    batch = trainer.batch()
    assert batch["que_imgs_info"]["ft_depth_range"].shape == (1, 64, 3)
    trainer.fit(2)
    assert len(logged) == 2 and all(np.isfinite(logged))
    after = trainer.model.state_dict()
    assert not torch.equal(init["ray_feats.0"], after["ray_feats.0"])
    assert not torch.equal(init["fine_agg_net.prob_embed.0.weight"],
                           after["fine_agg_net.prob_embed.0.weight"])
    val = trainer.validate()
    assert np.isfinite(val["mse"]) and np.isfinite(val["psnr"])
    path = trainer.save()
    assert path.as_posix() == "data/model/ft_tiny/ft_latest/model.pth"
    main_run = train_ft.main(argv[:2] + ["--steps", "1"] + argv[4:])
    assert main_run.step == 1

    common = ["--ckpt", str(path), "--height", str(H), "--width", str(W),
              "--chunk", "512", "--device", "cpu", "--out",
              str(tmp_path / "out")]
    m = render_ft.main(common)
    assert set(m) == {"psnr_nr", "ssim_nr", "wspsnr_nr", "sec_per_frame"}
    assert all(np.isfinite(v) for v in m.values())
    stems = {p.name.split(".")[0] for p in (tmp_path / "out").iterdir()}
    assert {"que-nr_fine", "que-gt", "metric"} <= stems
    path_run = render_ft.main(common + ["--pose-type", "inter",
                                        "--inter-num", "1"])
    assert path_run["frames"] == 1
    assert "frame000" in {p.name.split(".")[0]
                          for p in (tmp_path / "out").iterdir()}
