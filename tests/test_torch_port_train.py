"""Port parity for renderer training: stochastic sampling, the renderer's
training forward and its gradients, losses, lr schedules, the Adam
trainer (clipping, count-jitter, checkpoints), the config loader, the
synthetic scenes and ``imgs_info``, and the training CLI — each against its
JAX counterpart on the same numpy inputs (CPU, float32).

Shapes: 32x64 render, 32x64 depth, 2 reference views, 32 + 32 samples,
16 rays (the other port tests' shapes); synthetic scenes at 16x32.
Randomness: the port draws its sampling noise through
``render_ops.uniform``; the tests replace it with JAX's own
``jax.random.uniform`` draws for the same key and split.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import __graft_entry__ as ge
from panogrf_tpu import config as jconfig
from panogrf_tpu.data import imgs_info as jinfo
from panogrf_tpu.data import synthetic as jsyn
from panogrf_tpu.renderer import render_ops as jro
from panogrf_tpu.renderer.renderer import NeuralRayGenRenderer as JR
from panogrf_tpu.train import losses as jl
from panogrf_tpu.train import lr as jlr
from panogrf_tpu.train import trainer as jtr
from panogrf_tpu.utils.torch_convert import convert_renderer
from panogrf_tpu_torch import config as tconfig
from panogrf_tpu_torch.data import imgs_info as tinfo
from panogrf_tpu_torch.data import synthetic as tsyn
from panogrf_tpu_torch.renderer import render_ops as tro
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer as TR
from panogrf_tpu_torch.tools import train_renderer as tcli
from panogrf_tpu_torch.train import losses as tl
from panogrf_tpu_torch.train import lr as tlr
from panogrf_tpu_torch.train import trainer as ttr
from panogrf_tpu_torch.utils.from_jax import load_jax_params
from torch_port_parity import seeded_renderer_params
from torch_port_threads import one_torch_thread  # noqa: F401

H, W, DH, DW, DN, RN = 32, 64, 32, 64, 32, 16
# forward outputs and loss (float32; convolution, matmul and reduction
# order differ between XLA and PyTorch): measured max 1.6e-5 abs
OUT_TOL = dict(atol=1e-4, rtol=1e-4)
# gradients: rtol of each parameter's own largest gradient, plus an atol
# of 1e-6 x the largest gradient of the tree for the parameters whose
# exact gradient is 0 (conv biases in front of an instance norm, the bias
# in front of the view softmax), where both sides return rounding noise.
# Measured worst relative error of a nonzero gradient: 2e-3.
GRAD_RTOL, GRAD_ATOL_REL = 1e-2, 1e-6
REPO = __import__("pathlib").Path(__file__).resolve().parents[1]


def _t(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def numpy_state(tensors: dict) -> dict:
    """{state-dict name: tensor} -> {name: float32 numpy array}, which
    ``convert_renderer`` maps onto the JAX tree."""
    return {k: v.detach().float().cpu().numpy() for k, v in tensors.items()}


def _inject(monkeypatch, draws):
    """Make ``render_ops.uniform`` return ``draws`` in order, checking
    each requested shape."""
    queue = [np.asarray(d) for d in draws]

    def uniform(generator, shape, device=None):
        want = queue.pop(0)
        assert tuple(shape) == want.shape, (shape, want.shape)
        return torch.tensor(want).to(device)
    monkeypatch.setattr(tro, "uniform", uniform)
    return queue


# ---------------------------------------------------------------------------
# stochastic sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_disp", [True, False])
def test_stochastic_sampling_matches_jax(monkeypatch, use_disp):
    key = jax.random.PRNGKey(5)
    r_coarse, r_fine = jax.random.split(key)
    jd, jdist = jro.sample_depth(2, 7, DN, 0.5, 15.0, use_disp, r_coarse)
    queue = _inject(monkeypatch, [
        jax.random.uniform(r_coarse, (2, 7, DN - 2)),
        jax.random.uniform(r_fine, (2, 7, 24))])
    td, tdist = tro.sample_depth(2, 7, DN, 0.5, 15.0, use_disp,
                                 generator=torch.Generator())
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    np.testing.assert_allclose(tdist.numpy(), np.asarray(jdist), rtol=1e-5,
                               atol=1e-6)
    hit = np.random.default_rng(6).uniform(size=(2, 7, DN)).astype(
        np.float32) ** 4
    qdr = np.asarray([[0.5, 15.0]], np.float32)
    jf = jro.sample_fine_depth(jd, jnp.asarray(hit), jnp.asarray(qdr), 24,
                               r_fine, inv_mode=use_disp)
    tf = tro.sample_fine_depth(td, torch.tensor(hit), torch.tensor(qdr), 24,
                               inv_mode=use_disp,
                               generator=torch.Generator())
    assert not queue
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5,
                               atol=1e-6)


def test_sampling_draws_come_from_the_cpu_generator():
    """The same seed gives the same depths; another seed other depths."""
    def draw(seed):
        return tro.sample_depth(1, 4, 8, 0.5, 15.0, True, generator=torch.
                                Generator().manual_seed(seed))[0]
    assert torch.equal(draw(0), draw(0))
    assert not torch.equal(draw(0), draw(1))
    grids = torch.arange(2 * 3 * 5 * 4.0).reshape(2, 3, 5, 4)
    coords = torch.tensor([[[1.0, 2.0], [4.0, 0.0]], [[0.0, 1.0],
                                                      [3.0, 2.0]]])
    a = jro.gather_at_coords_batched(jnp.asarray(grids.numpy()),
                                     jnp.asarray(coords.numpy()))
    b = tro.gather_at_coords_batched(grids, coords)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ---------------------------------------------------------------------------
# the renderer's training forward, loss and gradients
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_step():
    """One JAX value_and_grad of render + depth loss at the training
    recipe's renderer flags (depth-major gather), with JAX's sampling
    draws for the same key."""
    data = ge._tiny_data(H, W, DH, DW, rn=RN)
    rng = np.random.default_rng(3)
    data["ref_imgs_info"]["true_depth"] = jnp.asarray(
        rng.uniform(1, 6, (2, H, W, 1)), jnp.float32)
    kw = dict(height=H, width=W, depth_hw=(DH, DW), depth_sample_num=DN,
              fine_depth_sample_num=DN, gather_depth_major=True)
    model = JR(**kw)
    params = seeded_renderer_params(**kw)
    # a positive density bias gives the fine pass density (and gradients)
    # at this random initialisation
    for n in ("agg_net", "fine_agg_net"):
        params["params"][n]["agg_impl"]["out_geometry_fc"]["b1"] = \
            np.full((1,), 0.5, np.float32)
    key = jax.random.PRNGKey(1)

    def loss_fn(p):
        out = model.apply(p, data, rng=key)
        terms = {**jl.render_loss(out, data), **jl.depth_loss(out, data)}
        return jl.total_loss(terms), (out, terms)
    (loss, (out, terms)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    r_coarse, r_fine = jax.random.split(key)
    draws = [jax.random.uniform(r_coarse, (1, RN, DN - 2)),
             jax.random.uniform(r_fine, (1, RN, DN))]
    return dict(kw=kw, data=data, params=params, loss=float(loss),
                out=jax.tree.map(np.asarray, out),
                terms=jax.tree.map(np.asarray, terms),
                grads=jax.tree.map(np.asarray, grads["params"]), draws=draws)


def _port_step(monkeypatch, jax_step):
    queue = _inject(monkeypatch, jax_step["draws"])
    model = TR(**jax_step["kw"], device="cpu")
    load_jax_params(model, jax_step["params"])
    data = _t(jax_step["data"])
    loss_fn = ttr.make_loss_fn(ttr.TrainerConfig(losses=("render", "depth")))
    out = model(data, torch.Generator())
    loss, terms = loss_fn(out, data)
    loss.backward()
    assert not queue
    return model, out, loss, terms


def test_training_forward_and_loss_match_jax(monkeypatch, jax_step):
    _, out, loss, terms = _port_step(monkeypatch, jax_step)
    want = jax_step["out"]
    assert set(out) == set(want)
    for k in want:
        np.testing.assert_allclose(out[k].detach().float().numpy(),
                                   want[k].astype(np.float32), **OUT_TOL,
                                   err_msg=k)
    assert set(terms) == set(jax_step["terms"]) == {
        "loss_rgb_nr", "loss_rgb_nr_fine", "loss_depth", "loss_depth_fine"}
    for k, v in jax_step["terms"].items():
        np.testing.assert_allclose(terms[k].detach().numpy(), v, **OUT_TOL)
    np.testing.assert_allclose(loss.item(), jax_step["loss"], rtol=1e-5)


def test_training_gradients_match_jax_grad(monkeypatch, jax_step):
    """The gradient of the total loss for every parameter, mapped onto the
    JAX tree by ``convert_renderer``, against ``jax.grad``."""
    model, *_ = _port_step(monkeypatch, jax_step)
    assert all(p.grad is not None for p in model.parameters())
    got = convert_renderer(numpy_state(
        {n: p.grad for n, p in model.named_parameters()}))["params"]
    flat_a = dict(jax.tree_util.tree_leaves_with_path(jax_step["grads"]))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(got))
    assert flat_a.keys() == flat_b.keys()
    atol = GRAD_ATOL_REL * max(np.abs(v).max() for v in flat_a.values())
    for k, a in flat_a.items():
        np.testing.assert_allclose(
            flat_b[k], a, rtol=0, atol=GRAD_RTOL * np.abs(a).max() + atol,
            err_msg=jax.tree_util.keystr(k))


def test_fine_depth_use_all_and_flat_sampling(monkeypatch):
    """``fine_depth_use_all`` concatenates and sorts the coarse and fine
    depths; without hierarchical sampling there is no fine pass."""
    data = ge._tiny_data(H, W, DH, DW, rn=4)
    kw = dict(height=H, width=W, depth_hw=(DH, DW), depth_sample_num=8,
              fine_depth_sample_num=8)
    for flags, fine in [(dict(fine_depth_use_all=True), 16),
                        (dict(use_hierarchical_sampling=False), None)]:
        jm = JR(**kw, **flags)
        params = seeded_renderer_params(**kw, **flags)
        key = jax.random.PRNGKey(2)
        want = jax.jit(lambda p, d, k: jm.apply(p, d, rng=k))(params, data,
                                                               key)
        r_coarse, r_fine = jax.random.split(key)
        _inject(monkeypatch, [jax.random.uniform(r_coarse, (1, 4, 6)),
                              jax.random.uniform(r_fine, (1, 4, 8))][
            :2 if fine else 1])
        tm = load_jax_params(TR(**kw, **flags, device="cpu"), params)
        got = tm(_t(data), torch.Generator())
        assert set(got) == set(want)
        if fine:
            assert got["que_depth_fine"].shape == (1, 4, fine)
        for k in want:
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       np.asarray(want[k]), **OUT_TOL,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# losses and schedules
# ---------------------------------------------------------------------------

def test_losses_match_jax():
    rng = np.random.default_rng(9)
    f = lambda *s: rng.uniform(size=s).astype(np.float32)
    pr = {"pixel_colors_nr": f(1, 20, 3), "pixel_colors_nr_fine": f(1, 20, 3),
          "pixel_colors_gt": f(1, 20, 3),
          "ray_mask": rng.uniform(size=(1, 20)) > 0.3,
          "polar_weights": f(1, 20), "depth_mean": f(2, 20),
          "depth_mean_fine": f(2, 20),
          "depth_coords": np.stack([rng.uniform(0, W - 1, (2, 20)),
                                    rng.uniform(0, H - 1, (2, 20))],
                                   -1).astype(np.float32),
          "hit_prob_nr": f(1, 20, 8), "hit_prob_self": f(1, 20, 8),
          "hit_prob_nr_fine": f(1, 20, 8), "hit_prob_self_fine": f(1, 20, 8)}
    gt = {"ref_imgs_info": {"true_depth": rng.uniform(0.3, 20, (2, H, W, 1))
                            .astype(np.float32),
                            "depth_range": np.asarray([[0.5, 15.0],
                                                       [0.4, 12.0]],
                                                      np.float32)}}
    jpr, jgt = jax.tree.map(jnp.asarray, (pr, gt))
    tpr, tgt = _t(pr), _t(gt)
    cases = [(jl.render_loss, tl.render_loss, {}),
             (jl.render_loss, tl.render_loss, {"use_ray_mask": False}),
             (jl.render_loss, tl.render_loss,
              {"use_polar_weighted_loss": True}),
             (jl.render_loss, tl.render_loss,
              {"use_polar_weighted_loss": True, "use_ray_mask": False,
               "use_nr_fine_loss": False}),
             (jl.depth_loss, tl.depth_loss, {}),
             (jl.depth_loss, tl.depth_loss, {"loss_type": "smooth_l1"}),
             (jl.consistency_loss, tl.consistency_loss, {})]
    for jf, tf, kw in cases:
        a, b = jf(jpr, jgt, 0, **kw), tf(tpr, tgt, 0, **kw)
        assert set(a) == set(b), (jf.__name__, kw)
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]),
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tl.total_loss(b).item(),
                                   float(jl.total_loss(a)), rtol=1e-5)
    d = rng.uniform(0.0, 20.0, (2, 30)).astype(np.float32)
    dr = gt["ref_imgs_info"]["depth_range"]
    np.testing.assert_allclose(
        tl.normalize_inv_depth(torch.tensor(d), torch.tensor(dr)).numpy(),
        np.asarray(jl.normalize_inv_depth(jnp.asarray(d), jnp.asarray(dr))),
        atol=1e-6)
    assert set(tl.NAME2LOSS) == set(jl.NAME2LOSS)


@pytest.mark.parametrize("name,kw", [
    ("exp_decay", {}),
    ("exp_decay", {"lr_init": 1e-3, "decay_step": 3, "decay_rate": 0.1,
                   "lr_min": 2e-5}),
    ("warm_up_exp_decay", {"warmup_step": 5, "decay_step": 7})])
def test_lr_schedules_match_jax(name, kw):
    js, ts = jlr.NAME2LR[name](**kw), tlr.NAME2LR[name](**kw)
    for step in [0, 1, 2, 3, 4, 5, 6, 7, 13, 14, 20000, 39999, 40000, 10**6]:
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad_clip", [None, 1.0])
def test_adam_exp_decay_and_clip_match_optax(grad_clip):
    """Three updates on a fixed gradient sequence against optax (Adam at
    the schedule's lr, global-norm clipping first)."""
    rng = np.random.default_rng(10)
    shapes = {"a": (3, 4), "b": (5,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    # global norms ~3.1, ~0.3 and ~1.6: the clip scales steps 1 and 3 only
    grads = [{k: (rng.normal(size=s) * sc).astype(np.float32)
              for k, s in shapes.items()} for sc in (1.0, 0.1, 0.5)]
    cfg = dict(lr_cfg={"lr_init": 1e-2, "decay_step": 2, "decay_rate": 0.5},
               grad_clip=grad_clip)
    tx, _ = jtr.make_optimizer(jtr.TrainerConfig(**cfg))
    jp = jax.tree.map(jnp.asarray, p0)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}
    tcfg = ttr.TrainerConfig(**cfg)
    opt, schedule = ttr.make_optimizer(tcfg, list(tp.values()))
    for count, g in enumerate(grads):
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        ttr.apply_update(opt, schedule, count, tcfg.grad_clip)
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{k} {count}")


class _Lin(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(4, 4))


def _lin_out(x, w, scale):
    """The render-loss outputs of ``x @ w`` (scaled), for both frameworks."""
    out = scale * (x @ w)
    return {"pixel_colors_nr": out[None],
            "pixel_colors_gt": 0 * out[None],
            "ray_mask": (out[None, :, 0] * 0 + 1) > 0}


def test_count_jitter_sequence_matches_jax():
    """The variant drawn at each step equals the JAX Trainer's for the same
    seed and weights (read back from each step's loss: the variants scale
    the output by 1, 2 and 3)."""
    scales = {"f32": 1.0, "f48": 2.0, "f64": 3.0}
    probs = {"f32": 1, "f48": 1, "f64": 2}
    x = np.ones((5, 4), np.float32)
    cfg = dict(name="cj", losses=("render",), log_interval=1,
               val_interval=10**9, save_interval=10**9, seed=7,
               lr_cfg={"lr_init": 0.0, "decay_step": 10, "decay_rate": 0.5,
                       "lr_min": 0.0})
    jlog, tlog = [], []
    jt = jtr.Trainer({k: (lambda p, b, r, s=s: _lin_out(b["x"], p["w"], s))
                      for k, s in scales.items()},
                     {"w": jnp.ones((4, 4))}, jtr.TrainerConfig(**cfg),
                     log_fn=lambda st, m: jlog.append(round(m["loss"])),
                     variant_probs=probs)
    jt.fit([{"x": jnp.asarray(x)}] * 12)
    model = _Lin()
    tt = ttr.Trainer(model, {k: (lambda b, g, s=s: _lin_out(b["x"], model.w,
                                                             s))
                             for k, s in scales.items()},
                     ttr.TrainerConfig(**cfg),
                     log_fn=lambda st, m: tlog.append(round(m["loss"])),
                     variant_probs=probs)
    tt.fit([{"x": torch.tensor(x)}] * 12)
    assert tlog == jlog and len(set(jlog)) == 3
    assert [64 * scales[v] ** 2 for v in tt.variant_sequence(12)] == jlog


def test_trainer_resume_continues_step_optstate_and_lr(tmp_path):
    """Killed after 3 steps and restored, the trainer ends where an
    uninterrupted run ends: step, optimizer state, best metric and lr
    (the schedule reads the restored step)."""
    cfg = ttr.TrainerConfig(name="rs", save_dir=str(tmp_path),
                            losses=("render",),
                            lr_cfg={"lr_init": 1e-3, "decay_step": 4,
                                    "decay_rate": 0.5},
                            log_interval=1, val_interval=10**9,
                            save_interval=10**9)
    batch = {"x": torch.ones(5, 4)}

    def run(steps, restore=False):
        model = _Lin()
        tr = ttr.Trainer(model, lambda b, g: _lin_out(b["x"], model.w, 1.0),
                         cfg)
        if restore:
            tr.restore("latest")
        tr.fit([batch] * steps)
        return tr

    full = run(6)
    part = run(3)
    part.best_metric = 12.5
    path = part.save("latest")
    assert path == tmp_path / "rs" / "latest" / "model.pth"
    resumed = run(0, restore=True)
    assert resumed.step == 3 and resumed.best_metric == 12.5
    assert resumed.opt.state_dict()["state"][0]["step"] == 3
    resumed.fit([batch] * 3)
    assert resumed.step == 6
    assert resumed.opt.param_groups[0]["lr"] == full.opt.param_groups[0][
        "lr"] == 5e-4
    np.testing.assert_allclose(resumed.model.w.detach().numpy(),
                               full.model.w.detach().numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# config, data, CLI
# ---------------------------------------------------------------------------

def test_config_loader_matches_jax():
    for path in sorted((REPO / "configs").rglob("*.yaml")):
        assert dataclasses.asdict(tconfig.load_config(path)) == \
            dataclasses.asdict(jconfig.load_config(path)), path


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_sample_matches_jax(seed):
    """Scene draws, poses, depth and colour of a 16x32 three-view sample;
    a handful of silhouette pixels may flip between a sphere and the room
    (float rounding of the ray-sphere test)."""
    js = jsyn.SphereScene.random(seed)
    ts = tsyn.SphereScene.random(seed)
    for a in ("centers", "radii", "colors"):
        np.testing.assert_array_equal(getattr(ts, a).numpy(),
                                      np.asarray(getattr(js, a)))
    want = jax.tree.map(np.asarray,
                        jsyn.make_three_view_sample(js, 16, 32, 0.5, seed))
    got = {k: v.numpy() for k, v in
           tsyn.make_three_view_sample(ts, 16, 32, 0.5, seed).items()}
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    np.testing.assert_allclose(got["rots"], want["rots"], atol=1e-7)
    np.testing.assert_allclose(got["trans"], want["trans"], atol=1e-6)
    for k, tol in (("rgb_panos", 1e-5), ("depth_panos", 1e-4)):
        bad = np.abs(got[k] - want[k]).max(-1) > tol
        assert bad.sum() <= 4, (k, bad.sum())


def test_imgs_info_matches_jax():
    js = jsyn.make_three_view_sample(jsyn.SphereScene.random(1), 16, 32)
    ts = {k: torch.tensor(np.asarray(v)) for k, v in js.items()}
    coords_j = jinfo.sample_train_coords(np.random.default_rng(4), 16, 32, 9)
    coords_t = tinfo.sample_train_coords(np.random.default_rng(4), 16, 32, 9)
    np.testing.assert_array_equal(coords_t.numpy(), np.asarray(coords_j))
    a = jinfo.build_render_sample(js, coords_j, (0.5, 15.0))
    b = tinfo.build_render_sample(ts, coords_t, (0.5, 15.0))
    fa = dict(jax.tree_util.tree_leaves_with_path(a))
    fb = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), b)))
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        np.testing.assert_allclose(fb[k], np.asarray(v), atol=1e-6,
                                   err_msg=jax.tree_util.keystr(k))
    np.testing.assert_allclose(tinfo.polar_weights(16, 32).numpy(),
                               np.asarray(jinfo.polar_weights(16, 32)),
                               atol=1e-7)
    np.testing.assert_array_equal(tinfo.full_image_coords(16, 32).numpy(),
                                  np.asarray(jinfo.full_image_coords(16, 32)))
    assert (tinfo.REF_IDS, tinfo.QUE_ID, tinfo.SRC_IDS) == \
        (jinfo.REF_IDS, jinfo.QUE_ID, jinfo.SRC_IDS)


def test_cli_trains_and_its_checkpoint_loads_in_jax(tmp_path, monkeypatch):
    """Two CPU steps of the CLI on the small config: the loss is finite,
    the parameters moved, and the saved ``model.pth`` loads through the
    JAX package's ``load_checkpoint_params`` to the same parameters."""
    monkeypatch.chdir(tmp_path)
    argv = ["--cfg", str(REPO / "configs/gen_synthetic_small.yaml"),
            "--steps", "2", "--pool", "2", "--device", "cpu"]
    logged = []
    trainer = tcli.main(argv, log_fn=lambda st, m: logged.append((st, m)))
    assert trainer.step == 2 and np.isfinite(logged[0][1]["loss"])
    init = tcli.build(tcli.parse_args(argv))[0].model.state_dict()
    after = trainer.model.state_dict()
    assert any(not torch.equal(init[k], after[k]) for k in init)
    path = tmp_path / "data/model/gen_small/latest/model.pth"
    assert path.exists()
    loaded = jtr.load_checkpoint_params(path)["params"]
    want = convert_renderer(numpy_state(trainer.model.state_dict()))[
        "params"]
    flat_a = dict(jax.tree_util.tree_leaves_with_path(loaded))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(want))
    assert flat_a.keys() == flat_b.keys()
    for k, v in flat_a.items():
        np.testing.assert_array_equal(np.asarray(v), flat_b[k])
    sd = ttr.load_checkpoint_params(path)
    assert sd.keys() == trainer.model.state_dict().keys()


def test_cli_refuses_what_is_not_ported(tmp_path):
    """``--mesh`` is ported (``tests/test_torch_port_parallel.py``); a mesh
    that does not divide a step's rays is refused."""
    cfg = str(REPO / "configs/gen_synthetic_small.yaml")
    for extra in (["--mesh", "3"],):
        with pytest.raises(SystemExit, match="must divide the 512 rays"):
            tcli.main(["--cfg", cfg, "--device", "cpu", *extra])
