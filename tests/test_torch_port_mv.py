"""Port parity for the multi-view renderer protocol and the consistency
loss, and the repairs of the render and training CLIs: the multi-view
sample, the query view's self hit probabilities, one V = 4 training step
with the consistency loss (loss and every gradient against ``jax.grad``),
the training CLI's multi-view branch, ``render_mv``, the render CLI's
``--depth-stack`` without an MVS checkpoint and the training CLI without
``--cfg`` (CPU, float32).

Shapes: 32x64 render, 32x64 depth, 32 + 32 samples, 16 rays, V = 4 views
(references [0, 1, 2], query 3) of a procedural scene.  The cameras sit
on one axis, so the rays keep off the image's border and its middle
column: there a view's points lie on another view's longitude seam,
where the two packages' roundings may fetch pixels a column apart.
Randomness: the port's sampling draws are replaced by JAX's for the same
key and split.  Tolerances as ``test_torch_port_train.py``'s: outputs and
losses within 1e-4, each gradient within 1e-2 of its parameter's largest
plus 1e-6 of the tree's largest.  The JAX step runs in float64 and the
port's in float32, both at JAX's float32 uniform draws: JAX's float32
gradients of the init net's deepest blocks differ from the float64 ones
by up to 4e-2 of their scale in this step, the port's float32 ones by
6e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from panogrf_tpu.data import imgs_info as jinfo
from panogrf_tpu.data import synthetic as jsyn
from panogrf_tpu.models import depth_stack as jds
from panogrf_tpu.models import unifuse as junifuse
from panogrf_tpu.renderer import render_ops as jro
from panogrf_tpu.renderer.renderer import NeuralRayGenRenderer as JR
from panogrf_tpu.train import losses as jl
from panogrf_tpu.utils.torch_convert import convert_renderer
from panogrf_tpu_torch.data import imgs_info as tinfo
from panogrf_tpu_torch.models import unifuse as tunifuse
from panogrf_tpu_torch.nn.blocks import init_parameters_
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer as TR
from panogrf_tpu_torch.tools import render as trender
from panogrf_tpu_torch.tools import render_mv as trender_mv
from panogrf_tpu_torch.tools import train_renderer as tcli
from panogrf_tpu_torch.train import losses as tl
from panogrf_tpu_torch.train import trainer as ttr
from panogrf_tpu_torch.utils.from_jax import load_jax_params
from torch_port_parity import (OUT_TOL, assert_grads_close, f32_uniform,
                               inject_uniform, off_seam_coords,
                               template_init, to_f64, to_torch)
from torch_port_threads import one_torch_thread  # noqa: F401

H, W, DH, DW, DN, RN = 32, 64, 32, 64, 32, 16
V, REFS, QUE = 4, [0, 1, 2], 3
REPO = __import__("pathlib").Path(__file__).resolve().parents[1]
MV_CFG = REPO / ("configs/gen/"
                 "neuray_gen_cv_erp_mono_stereo_uniform_512x1024_mv_v4.yaml")


def mv_sample():
    return jax.tree.map(np.asarray, jsyn.make_multi_view_sample(
        jsyn.SphereScene.random(4), H, W, V, 0.25, seed=4))


def test_build_render_sample_mv_matches_jax():
    js = mv_sample()
    ts = to_torch(js)
    coords = off_seam_coords(np.random.default_rng(0), 9, H, W)
    a = jinfo.build_render_sample_mv(js, jnp.asarray(coords), REFS, QUE,
                                     (0.5, 12.0))
    b = tinfo.build_render_sample_mv(ts, torch.tensor(coords), REFS, QUE,
                                     (0.5, 12.0))
    fa = dict(jax.tree_util.tree_leaves_with_path(a))
    fb = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), b)))
    assert fa.keys() == fb.keys()
    assert "src_imgs_info" not in b
    for k, v in fa.items():
        np.testing.assert_allclose(fb[k], np.asarray(v), atol=1e-6,
                                   err_msg=jax.tree_util.keystr(k))
    assert b["ref_imgs_info"]["imgs"].shape == (3, H, W, 3)


# ---------------------------------------------------------------------------
# one V = 4 training step with the consistency loss
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mv_step():
    """JAX value_and_grad, in float64, of render + depth + consistency
    loss at the training recipe's flags with ``use_self_hit_prob``, on
    references [0, 1, 2] and query 3 (each view's depth its true depth),
    with JAX's float32 sampling draws for the same key on both sides."""
    js = mv_sample()
    coords = off_seam_coords(np.random.default_rng(1), RN, H, W)
    data = jinfo.build_render_sample_mv(js, jnp.asarray(coords), REFS, QUE)
    data["ref_imgs_info"]["mvs_depth"] = jnp.asarray(js["depth_panos"][REFS])
    data["que_imgs_info"]["mvs_depth"] = jnp.asarray(
        js["depth_panos"][[QUE]])
    kw = dict(height=H, width=W, depth_hw=(DH, DW), depth_sample_num=DN,
              fine_depth_sample_num=DN, gather_depth_major=True,
              use_self_hit_prob=True)
    model = JR(**kw)
    params = jax.tree.map(np.asarray,
                          jax.jit(model.init)(jax.random.PRNGKey(0), data))
    # a positive density bias gives the fine pass density (and gradients)
    # at this random initialisation
    for n in ("agg_net", "fine_agg_net"):
        params["params"][n]["agg_impl"]["out_geometry_fc"]["b1"] = \
            np.full((1,), 0.5, np.float32)
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        f32_uniform(mp)
        loss, out, terms, grads, draws = _jax_step64(model, params, data)
    return dict(kw=kw, model=model, data=data, params=params,
                loss=float(loss), out=jax.tree.map(np.asarray, out),
                terms=jax.tree.map(np.asarray, terms),
                grads=jax.tree.map(np.asarray, grads["params"]), draws=draws)


def _jax_step64(model, params, data):
    """(loss, outputs, loss terms, gradients, the two sampling draws) of
    the step in float64; call under ``jax.enable_x64``."""
    data64 = to_f64(data)
    key = jax.random.PRNGKey(1)

    def loss_fn(p):
        out = model.apply(p, data64, rng=key)
        terms = {**jl.render_loss(out, data64),
                 **jl.depth_loss(out, data64),
                 **jl.consistency_loss(out, data64)}
        return jl.total_loss(terms), (out, terms)
    (loss, (out, terms)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(to_f64(params))
    r_coarse, r_fine = jax.random.split(key)
    draws = [np.asarray(jax.random.uniform(r_coarse, (1, RN, DN - 2)),
                        np.float32),
             np.asarray(jax.random.uniform(r_fine, (1, RN, DN)), np.float32)]
    return loss, out, terms, grads, draws


def _port_step(monkeypatch, mv_step):
    queue = inject_uniform(monkeypatch, mv_step["draws"])
    model = load_jax_params(TR(**mv_step["kw"], device="cpu"),
                            mv_step["params"])
    data = to_torch(mv_step["data"])
    loss_fn = ttr.make_loss_fn(ttr.TrainerConfig(
        losses=("render", "depth", "consistency")))
    out = model(data, torch.Generator())
    loss, terms = loss_fn(out, data)
    loss.backward()
    assert not queue
    return model, out, loss, terms


def test_mv_consistency_forward_and_loss_match_jax(monkeypatch, mv_step):
    _, out, loss, terms = _port_step(monkeypatch, mv_step)
    want = mv_step["out"]
    assert set(out) == set(want)
    assert {"hit_prob_self", "hit_prob_self_fine"} <= set(out)
    for k in want:
        np.testing.assert_allclose(out[k].detach().float().numpy(),
                                   want[k].astype(np.float32), **OUT_TOL,
                                   err_msg=k)
    assert set(terms) == set(mv_step["terms"]) == {
        "loss_rgb_nr", "loss_rgb_nr_fine", "loss_depth", "loss_depth_fine",
        "loss_prob", "loss_prob_fine"}
    for k, v in mv_step["terms"].items():
        np.testing.assert_allclose(terms[k].detach().numpy(), v, **OUT_TOL,
                                   err_msg=k)
    np.testing.assert_allclose(loss.item(), mv_step["loss"], rtol=1e-5)


def test_mv_consistency_gradients_match_jax_grad(monkeypatch, mv_step):
    """Every parameter's gradient of the V = 4 step's total loss (render,
    depth, consistency), mapped onto the JAX tree by ``convert_renderer``,
    against ``jax.grad``."""
    model, *_ = _port_step(monkeypatch, mv_step)
    assert all(p.grad is not None for p in model.parameters())
    got = convert_renderer({n: p.grad.numpy() for n, p in
                            model.named_parameters()})["params"]
    flat = lambda t: {jax.tree_util.keystr(k): v for k, v in
                      jax.tree_util.tree_leaves_with_path(t)}
    assert_grads_close(flat(got), flat(mv_step["grads"]))


@pytest.mark.parametrize("is_fine", [False, True])
def test_predict_self_hit_prob_matches_jax(mv_step, is_fine):
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(1, RN, 32)).astype(np.float32)
    depth = np.sort(rng.uniform(0.5, 15.0, (1, RN, DN)), -1) \
        .astype(np.float32)
    qdr = np.asarray([[0.5, 15.0]], np.float32)
    dists = np.asarray(jro.depth2inv_dists(jnp.asarray(depth),
                                           jnp.asarray(qdr)))
    want = mv_step["model"].apply(
        mv_step["params"], jnp.asarray(feats), jnp.asarray(depth),
        jnp.asarray(dists), jnp.asarray(qdr), is_fine,
        method=JR.predict_self_hit_prob)
    model = load_jax_params(TR(**mv_step["kw"], device="cpu"),
                            mv_step["params"])
    got = model.predict_self_hit_prob(*map(torch.tensor, (feats, depth, dists,
                                                          qdr)), is_fine)
    assert got.shape == (1, RN, DN)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **OUT_TOL)


def test_consistency_loss_without_fine_matches_jax():
    rng = np.random.default_rng(8)
    pr = {k: rng.uniform(size=(2, 10, 8)).astype(np.float32)
          for k in ("hit_prob_nr", "hit_prob_self", "hit_prob_nr_fine")}
    a = jl.consistency_loss(jax.tree.map(jnp.asarray, pr), {})
    b = tl.consistency_loss(to_torch(pr), {})
    assert set(a) == set(b) == {"loss_prob"}
    np.testing.assert_allclose(b["loss_prob"].numpy(),
                               np.asarray(a["loss_prob"]), rtol=1e-5)
    assert tl.consistency_loss({"hit_prob_nr": pr["hit_prob_nr"]}, {}) == {}


# ---------------------------------------------------------------------------
# the training CLI's multi-view branch
# ---------------------------------------------------------------------------

def _tiny_mv_cfg(tmp_path, **extra) -> str:
    """The shipped V = 4 recipe's protocol and losses at 32x64 with 8 + 8
    samples."""
    cfg = yaml.safe_load(MV_CFG.read_text())
    cfg.update(name="mv_tiny", height=H, width=W, depth_height=DH,
               depth_width=DW, depth_sample_num=8, fine_depth_sample_num=8,
               **extra)
    path = tmp_path / "mv_tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_train_cli_mv_consistency_with_stack_depth(tmp_path, monkeypatch):
    """Two CPU steps of the V = 4 recipe with the consistency loss and the
    stack's depth: references [0, 1, 2] paired cyclically, the query view
    3 paired with reference 0; every term finite; validation on V = 4
    scenes."""
    monkeypatch.chdir(tmp_path)
    calls = []
    stack_depth = tcli.stack_depth_for_sample

    def record(stack, s, ids, srcs=None):
        calls.append((list(ids), None if srcs is None else list(srcs)))
        return stack_depth(stack, s, ids, srcs)
    monkeypatch.setattr(tcli, "stack_depth_for_sample", record)
    cfg = _tiny_mv_cfg(tmp_path, use_self_hit_prob=True, val_interval=2,
                       loss=["render", "depth", "consistency"])
    argv = ["--cfg", cfg, "--steps", "2", "--pool", "1", "--device", "cpu",
            "--depth-source", "stack", "--log-interval", "1"]
    logged = []
    trainer, stream, steps = tcli.build(tcli.parse_args(argv),
                                        lambda st, m: logged.append(m))
    batch = next(stream)
    assert batch["ref_imgs_info"]["imgs"].shape == (3, H, W, 3)
    assert batch["ref_imgs_info"]["mvs_depth"].shape == (3, DH, DW, 1)
    assert batch["que_imgs_info"]["mvs_depth"].shape == (1, DH, DW, 1)
    assert trainer.model.use_self_hit_prob
    trainer.fit(stream, steps)
    assert calls[:2] == [([0, 1, 2], None), ([3], [0])]
    terms = logged[0]
    assert {"loss_prob", "loss_prob_fine", "loss_depth"} <= set(terms)
    assert all(np.isfinite(v) for m in logged for v in m.values())
    assert "psnr_nr" in logged[-1]      # validation after step 2
    assert (tmp_path / "data/model/mv_tiny/vis").is_dir()


def test_train_cli_bare_mv_flag(tmp_path, monkeypatch):
    """``--mv 4`` on a 3-view config: references range(3), query 3, no
    query depth without the consistency loss."""
    monkeypatch.chdir(tmp_path)
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text("\n".join([
        "name: mv_bare", f"height: {H}", f"width: {W}",
        f"depth_height: {DH}", f"depth_width: {DW}", "depth_sample_num: 8",
        "fine_depth_sample_num: 8", "loss: [render]"]) + "\n")
    trainer, stream, _ = tcli.build(tcli.parse_args(
        ["--cfg", str(cfg), "--mv", "4", "--pool", "1", "--device", "cpu"]))
    batch = next(stream)
    assert batch["ref_imgs_info"]["imgs"].shape[0] == 3
    assert "mvs_depth" not in batch["que_imgs_info"]
    trainer.fit(stream, 1)
    assert trainer.step == 1


# ---------------------------------------------------------------------------
# render_mv
# ---------------------------------------------------------------------------

def test_render_mv_cli_writes_frames_and_metrics(tmp_path):
    """One 32x64 frame of a V = 3 scene from its 2 other views, on the
    CPU, from a checkpoint in the training CLI's layout."""
    model = TR(height=H, width=W, depth_hw=(DH, DW), device="cpu",
               generator=torch.Generator().manual_seed(3))
    ckpt = tmp_path / "model.pth"
    torch.save({"step": 0, "network_state_dict": model.state_dict()}, ckpt)
    summary = trender_mv.main(["--ckpt", str(ckpt), "--num", "1",
                               "--views", "3", "--que-idx", "1",
                               "--height", str(H), "--width", str(W),
                               "--depth-height", str(DH), "--depth-width",
                               str(DW), "--chunk", "4096", "--device", "cpu",
                               "--out", str(tmp_path / "out")])
    stems = {p.name.split(".")[0] for p in (tmp_path / "out").iterdir()}
    assert {"0-nr_fine", "0-gt", "metric"} <= stems
    mean = summary["mean"]
    assert set(mean) == {"psnr_nr", "ssim_nr", "wspsnr_nr", "sec_per_frame"}
    assert all(np.isfinite(v) for v in mean.values())


# ---------------------------------------------------------------------------
# the repairs
# ---------------------------------------------------------------------------

def test_render_cli_depth_stack_without_mvs_ckpt_is_mono(tmp_path,
                                                         monkeypatch):
    """``--depth-stack`` without ``--mvs-ckpt`` runs UniFuse alone, as the
    JAX package's ``load_depth_stack(mono, None)`` does: the reference
    depth the CLI renders from equals the JAX stack's from the same mono
    weights."""
    mono = tunifuse.UniFuse()
    init_parameters_(mono, torch.Generator().manual_seed(11))
    torch.save({"model_state_dict": mono.state_dict()},
               tmp_path / "mono.pth")
    seen = []
    stack_depth = trender.stack_depth_for_sample

    def record(stack, s, ids, srcs=None):
        out = stack_depth(stack, s, ids, srcs)
        seen.append(({k: v.numpy() for k, v in s.items()}, out))
        return out
    monkeypatch.setattr(trender, "stack_depth_for_sample", record)
    trender.main(["--height", str(H), "--width", str(W), "--depth-height",
                  str(DH), "--depth-width", str(DW), "--depth-stack",
                  "--mono-ckpt", str(tmp_path / "mono.pth"), "--num", "1",
                  "--samples", "8", "--fine-samples", "8", "--device", "cpu",
                  "--out", str(tmp_path / "out")])
    (sample, got), = seen
    monkeypatch.setattr(junifuse.UniFuse, "init", template_init)
    jstack = jds.load_depth_stack(str(tmp_path / "mono.pth"), None,
                                  (64, 128), (DH, DW))
    assert jstack.mvs_model is None
    want = jds.stack_depth_for_sample(jstack.jitted(), sample,
                                      jinfo.REF_IDS, jinfo.SRC_IDS)
    np.testing.assert_allclose(got["mvs_depth"].numpy(),
                               np.asarray(want["mvs_depth"]), rtol=1e-4,
                               atol=1e-4)


def test_train_cli_runs_without_cfg():
    """Without ``--cfg`` the training CLI builds the default config's
    trainer (512x1024, 64 + 64 samples, 100000 steps), as the JAX tool
    does."""
    args = tcli.parse_args([])
    assert args.cfg is None and args.device == "cuda"
    args.device, args.pool = "cpu", 1
    trainer, stream, steps = tcli.build(args)
    assert steps == 100000 and trainer.cfg.name == "run"
    assert (trainer.model.height, trainer.model.width) == (512, 1024)
    assert trainer.model.depth_sample_num == 64
    batch = next(stream)
    assert batch["que_imgs_info"]["coords"].shape == (1, 512, 2)
