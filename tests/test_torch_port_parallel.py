"""The port's multi-device paths (``panogrf_tpu_torch/parallel``) against
the JAX package's, on the CPU: the port's ranks are processes of
``parallel.launch.run_ranks`` joined by gloo (2 ranks, one case at 4); the
JAX package runs ``shard_map`` and GSPMD on the conftest's virtual CPU
devices.

* Cross-rank BatchNorm of a ResNet-18 encoder and a ``ConvBnLReLU3D``
  block: the running statistics and the gradients of a probe loss
  (``programs.probe_loss``) against ``shard_map`` with ``bn_axis='data'``
  (float32) and against the port's one-process step on the global batch.
* One data-parallel depth step (``EquiDepth``, float64 on both sides, as
  the earlier BatchNorm steps): loss, parameters and running statistics
  against ``make_sharded_depth_step`` and against the port's
  one-process ``DepthTrainer`` on the global batch.
* One renderer step of ``Trainer`` with the rays split over the ranks
  against the JAX ``Trainer(mesh=make_mesh(2))`` step (its sampling draws
  replaced by the port's) and against the port's one-rank step, and at 4
  ranks.
* ``render_image_sharded`` at ``coarse_lowres`` 1 and 2 against JAX's and
  against the port's ``render_image_device``, and at 4 ranks.
* ``--mesh 2 --device cpu`` through ``train_mono``, ``train_depth``,
  ``train_renderer`` and ``render`` against the same run without
  ``--mesh``, and the refusals.

Tolerances.  Port against port: one rank's and two ranks' arithmetic
differ in the order of their sums only: losses rtol 1e-5, gradients 1e-4
of each tensor's largest, frames 1e-6, float64 steps 1e-9.  Port against
JAX: running statistics 1e-4 of their scale, gradients 1e-3 of each
tensor's largest plus 1e-6 of the tree's largest in float32 (the float32
BatchNorm gradients 1e-2, the renderer's as in
``tests/test_torch_port_train.py``), the float64 depth step's parameters
within 1e-6 plus 1e-2 of the learning rate (its loss 1e-4: the packages'
sin(phi) weight maps round differently), frames 1e-3
(``tests/test_torch_port_render.py``).  The depth CLIs with ``--mesh 2``
hold their first step's clipped gradients (the ranks' mean) to the run
without a mesh within ``CLI_GRAD_RTOL`` of each tensor's largest (float32;
a gradient summed instead of averaged, of the wrong sign or missing is
off by its whole size), their logged losses and evaluation within 1e-4,
and their checkpoints' BatchNorm statistics within 1e-2 of their scale.
The renderer CLI's checkpoint holds Adam's first moment, 0.1 x the
gradient, which is compared instead.
"""

import ast
import copy
import json
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import __graft_entry__ as ge
from panogrf_tpu.models import unifuse as junifuse
from panogrf_tpu.nn import blocks as jblocks
from panogrf_tpu.nn import resnet as jresnet
from panogrf_tpu.parallel import mesh as jmesh
from panogrf_tpu.parallel import sharded_train as jst
from panogrf_tpu.parallel.sharded_render import render_image_sharded as \
    jrender_sharded
from panogrf_tpu.renderer.renderer import NeuralRayGenRenderer as JR
from panogrf_tpu.train import trainer as jtr
from panogrf_tpu.utils import torch_convert as tcv
from panogrf_tpu_torch.models import unifuse as tunifuse
from panogrf_tpu_torch.nn import blocks as tblocks
from panogrf_tpu_torch.nn import resnet as tresnet
from panogrf_tpu_torch.parallel import programs
from panogrf_tpu_torch.parallel.launch import run_ranks
from panogrf_tpu_torch.parallel.mesh import make_mesh
from panogrf_tpu_torch.renderer import full_render
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer as TR
from panogrf_tpu_torch.tools import render as trender
from panogrf_tpu_torch.tools import train_depth, train_mono, train_renderer
from panogrf_tpu_torch.train import depth_trainer as tdt
from panogrf_tpu_torch.train import trainer as ttr
from panogrf_tpu_torch.utils import from_jax
from torch_port_parity import seeded_renderer_params
from torch_port_threads import one_torch_thread  # noqa: F401

H, W, DH, DW, DN, RN = 32, 64, 32, 64, 8, 16
# every group of ranks must end within this, or it is killed
DEADLINE_S = 240.0


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(
        a, np.float64 if np.asarray(a).dtype == np.float32 else None), tree)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _probe(out):
    outs = out if isinstance(out, (list, tuple)) else [out]
    return sum(jnp.mean(jnp.sin(1.7 * o + 0.3)) for o in outs)


def _close(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


def _grads_close(got: dict, want: dict, rtol: float, atol_rel=1e-6):
    assert got.keys() == want.keys(), set(got) ^ set(want)
    floor = atol_rel * max(float(np.abs(v).max()) for v in want.values())
    bad = {}
    for k, v in want.items():
        err = float(np.abs(np.asarray(got[k]) - v).max())
        if err > rtol * float(np.abs(v).max()) + floor:
            bad[k] = (err, float(np.abs(v).max()))
    assert not bad, bad


def _bn_sd(params: dict, stats: dict, kind: str) -> dict:
    """JAX ResNetEncoder / ConvBnLReLU3D variables (or their gradients) ->
    the port's state-dict names, as numpy."""
    sd = from_jax._StateDict()
    if kind == "resnet":
        sd.resnet("e", params, stats)
        return {k[2:]: v.numpy() for k, v in sd.items()}
    sd.conv("conv", params["WrapConv3D_0"]["Conv_0"])
    sd.batch_norm("bn", params["BatchNorm_0"], stats["BatchNorm_0"])
    return {k: v.numpy() for k, v in sd.items()}


# ---------------------------------------------------------------------------
# inputs and the JAX side
# ---------------------------------------------------------------------------

def _bn_case(kind: str) -> dict:
    """A BatchNorm-bearing module on both sides with the JAX init, its
    global batch (samples offset so that each rank's statistics differ)
    in each package's layout."""
    rng = np.random.default_rng(11 if kind == "resnet" else 12)
    if kind == "resnet":
        x = rng.normal(size=(4, H, W, 3)).astype(np.float32)
        jm = jresnet.ResNetEncoder((2, 2, 2, 2), wrap=True, bn_axis="data")
        tm = tresnet.ResNetEncoder((2, 2, 2, 2), wrap=True)
        x_t = x.transpose(0, 3, 1, 2)
    else:
        x = rng.normal(size=(4, 4, 8, 16, 4)).astype(np.float32)
        jm = jblocks.ConvBnLReLU3D(6, bn_axis="data")
        tm = tblocks.ConvBnLReLU3D(4, 6)
        x_t = x.transpose(0, 4, 1, 2, 3)
    off = np.arange(4, dtype=np.float32).reshape(4, *[1] * (x.ndim - 1))
    x, x_t = x + 0.3 * off, np.ascontiguousarray(x_t + 0.3 * off)
    v = _np(jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(x[:1])))
    tm.load_state_dict({k: torch.tensor(a) for k, a in _bn_sd(
        v["params"], v["batch_stats"], kind).items()})
    return dict(kind=kind, jm=jm, tm=tm, v=v, x=x, x_t=x_t)


def _depth_case() -> dict:
    rng = np.random.default_rng(13)
    batch = {"equi": rng.uniform(size=(4, H, W, 3)).astype(np.float32),
             "gt_depth": rng.uniform(1.0, 5.0, (4, H, W, 1)).astype(
                 np.float32)}
    jm = junifuse.EquiDepth(max_depth=10.0, wrap=True, num_layers=18,
                            bn_axis="data")
    tm = tunifuse.EquiDepth(max_depth=10.0, num_layers=18)
    tblocks.init_parameters_(tm, torch.Generator().manual_seed(4))
    v = tcv.convert_equi_depth({k: a.numpy() for k, a in
                                tm.state_dict().items()})
    return dict(jm=jm, tm=tm.double(), v=_np(v), batch=batch)


def _renderer_case() -> dict:
    data = ge._tiny_data(H, W, DH, DW, rn=RN)
    data["ref_imgs_info"]["true_depth"] = jnp.asarray(
        np.random.default_rng(3).uniform(1, 6, (2, H, W, 1)), jnp.float32)
    kw = dict(height=H, width=W, depth_hw=(DH, DW), depth_sample_num=DN,
              fine_depth_sample_num=DN, gather_depth_major=True)
    jm = JR(**kw)
    params = seeded_renderer_params(**kw)
    # a positive density bias gives the fine pass density (and gradients)
    # at this random initialisation
    for n in ("agg_net", "fine_agg_net"):
        params["params"][n]["agg_impl"]["out_geometry_fc"]["b1"] = \
            np.full((1,), 0.5, np.float32)
    tm = from_jax.load_jax_params(TR(**kw, device="cpu"), params)
    cfg = ttr.TrainerConfig(losses=("render", "depth"))
    return dict(kw=kw, jm=jm, tm=tm, params=params, data=_np(data), cfg=cfg)


@pytest.fixture(scope="module")
def cases():
    return {"resnet": _bn_case("resnet"), "conv3d": _bn_case("conv3d"),
            "depth": _depth_case(), "renderer": _renderer_case()}


def _ref_info(data: dict) -> dict:
    return {k: data["ref_imgs_info"][k]
            for k in ("imgs", "mvs_depth", "w2c", "depth_range")}


def _frame_job(case: dict, clr: int) -> tuple:
    q = case["data"]["que_imgs_info"]
    return (programs.render_frame, dict(
        model=case["tm"], ref_info=_ref_info(case["data"]),
        que_c2w=q["c2w"], que_depth_range=q["depth_range"],
        device="cpu", coarse_lowres=clr, chunk=128))


@pytest.fixture(scope="module")
def port_runs(cases):
    """Every port program of this file at 2 ranks in one group, the
    renderer step and a frame at 4 ranks in another (the two groups at
    once), and the renderer step on one rank in this process."""
    c = cases
    step = (programs.renderer_steps, dict(model=c["renderer"]["tm"],
                                          batch=c["renderer"]["data"],
                                          cfg=c["renderer"]["cfg"],
                                          device="cpu"))
    jobs = [(programs.bn_step, dict(module=c[k]["tm"], x=c[k]["x_t"],
                                    device="cpu"))
            for k in ("resnet", "conv3d")]
    jobs += [(programs.depth_steps, dict(
        model=c["depth"]["tm"], batch=_f64(c["depth"]["batch"]),
        cfg=tdt.DepthTrainConfig(), inputs=("equi",), device="cpu")), step,
        _frame_job(c["renderer"], 1), _frame_job(c["renderer"], 2)]
    # the two groups of processes run side by side
    with ThreadPoolExecutor(2) as pool:
        two = pool.submit(run_ranks, programs.run_all, 2, "cpu", (jobs,),
                          deadline_s=DEADLINE_S)
        four = pool.submit(run_ranks, programs.run_all, 4, "cpu",
                           ([step, _frame_job(c["renderer"], 2)],),
                           deadline_s=DEADLINE_S)
        two, four = two.result(), four.result()
    one = run_ranks(programs.run_all, 1, "cpu", ([step],))
    return {"bn": dict(zip(("resnet", "conv3d"), two[:2])),
            "depth": two[2], "step": {1: one[0], 2: two[3], 4: four[0]},
            "frame": {(2, 1): two[4], (2, 2): two[5], (4, 2): four[1]}}


# ---------------------------------------------------------------------------
# cross-rank BatchNorm
# ---------------------------------------------------------------------------

def _jax_synced(case: dict):
    """(loss, new batch_stats, gradients) of the probe loss under
    ``shard_map`` over 2 virtual devices, BatchNorm on ``bn_axis='data'``
    and the gradients pmean'd, as ``make_sharded_depth_step`` does."""
    jm, v = case["jm"], case["v"]

    def step(params, stats, xs):
        def f(p):
            out, mut = jm.apply({"params": p, "batch_stats": stats}, xs,
                                True, mutable=["batch_stats"])
            return _probe(out), mut["batch_stats"]
        (loss, new), g = jax.value_and_grad(f, has_aux=True)(params)
        return jax.lax.pmean(loss, "data"), new, jax.lax.pmean(g, "data")
    fn = jax.shard_map(step, mesh=jmesh.make_mesh(2, data=2),
                       in_specs=(P(), P(), P("data")),
                       out_specs=(P(), P(), P()), check_vma=False)
    return _np(jax.jit(fn)(v["params"], v["batch_stats"],
                           jnp.asarray(case["x"])))


def _one_process(module: torch.nn.Module, x) -> tuple:
    """The port's step on the global batch in this process (BatchNorm on
    its local batch unless the module was given a mesh): (state,
    gradients, loss)."""
    m = copy.deepcopy(module).train()
    loss = programs.probe_loss(m(torch.as_tensor(x)))
    loss.backward()
    return ({k: t.numpy() for k, t in m.state_dict().items()},
            {k: p.grad.numpy() for k, p in m.named_parameters()},
            float(loss.detach()))


@pytest.mark.parametrize("kind", ["resnet", "conv3d"])
def test_cross_rank_batch_norm_matches_shard_map(kind, cases, port_runs):
    """2 ranks of 2 samples each: the running statistics and gradients
    equal JAX's ``shard_map`` with ``bn_axis='data'`` and the port's
    one-process step on all 4 samples; BatchNorm on one rank's samples
    alone gives other statistics (the inputs make the sync matter)."""
    case, got = cases[kind], port_runs["bn"][kind]
    jloss, jstats, jgrads = _jax_synced(case)
    want = _bn_sd(case["v"]["params"], jstats, kind)
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    for k in stats:
        _close(got["state"][k], want[k], 1e-4, k)
    jg = _bn_sd(jgrads, jstats, kind)
    _grads_close(got["grads"], {k: jg[k] for k in got["grads"]}, 1e-2)
    np.testing.assert_allclose(got["loss"], float(jloss), rtol=1e-4)
    state, grads, loss = _one_process(case["tm"], case["x_t"])
    for k in stats:
        _close(got["state"][k], state[k], 1e-5, k)
    _grads_close(got["grads"], grads, 1e-4)
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-6)
    half, _, _ = _one_process(case["tm"], case["x_t"][:2])
    assert max(float(np.abs(half[k] - state[k]).max()) for k in stats) > 1e-3


def test_bn_axis_trains_only_under_a_mesh(cases):
    """``bn_axis`` comes with the mesh whose axis it names; on a mesh of
    one rank the synced statistics are the local batch's."""
    case = cases["conv3d"]
    with pytest.raises(ValueError, match="needs the mesh"):
        tblocks.set_bn_axis(copy.deepcopy(case["tm"]), "data")
    synced = tblocks.set_bn_axis(copy.deepcopy(case["tm"]).train(), "data",
                                 make_mesh(1, data=1, device="cpu"))
    x = torch.as_tensor(case["x_t"])
    state, grads, loss = _one_process(synced, x)
    want_state, want_grads, want_loss = _one_process(case["tm"], x)
    for k, v in want_state.items():
        _close(state[k], v, 1e-5, k)
    _grads_close(grads, want_grads, 1e-4)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    # eval mode reads the running statistics and communicates nothing
    assert torch.isfinite(synced.eval()(x)).all()
    # None takes the mesh away with the axis
    plain = tblocks.set_bn_axis(synced, None)
    assert all(getattr(m, "bn_mesh", None) is None for m in plain.modules())


# ---------------------------------------------------------------------------
# the data-parallel depth step
# ---------------------------------------------------------------------------

def test_sharded_depth_step_matches_jax_and_one_process(cases, port_runs):
    """One ``EquiDepth`` step of 2 ranks x 2 samples in float64: loss,
    parameters and running statistics equal JAX's
    ``make_sharded_depth_step`` (clip + Adam as ``DepthTrainer``) and the
    port's ``DepthTrainer`` on the 4 samples in one process."""
    case, got = cases["depth"], port_runs["depth"]
    cfg = tdt.DepthTrainConfig()
    jm = case["jm"]

    def forward_fn(variables, batch, train):
        out, mut = jm.apply(variables, batch["equi"], train,
                            mutable=["batch_stats"] if train else [])
        return out, dict(mut) if train else {}
    with jax.enable_x64(True):
        v = _f64(case["v"])
        tx = optax.chain(optax.clip(cfg.clip_grad_value),
                         optax.adam(cfg.learning_rate, b1=cfg.opt_beta1,
                                    b2=cfg.opt_beta2))
        step = jst.make_sharded_depth_step(forward_fn, tx,
                                           jmesh.make_mesh(2, data=2))
        params, state, _, jloss = step(
            v["params"], {"batch_stats": v["batch_stats"]},
            tx.init(v["params"]), _f64(case["batch"]))
        want = {k: t.numpy() for k, t in from_jax.equi_depth_state_dict(
            {"params": _np(params), **_np(state)}).items()}
    # the packages' sin(phi) weight maps round differently (measured
    # 4.6e-6 of the loss); the predictions agree to 1e-13
    np.testing.assert_allclose(got["losses"][0], float(jloss), rtol=1e-4)
    # Adam divides each gradient by its size + 1e-8, which magnifies the
    # loss's difference in the elements whose gradient is near 1e-8
    lr_atol = 1e-2 * cfg.learning_rate
    for k, a in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got["state"][k], a, rtol=1e-6,
                                   atol=lr_atol, err_msg=k)

    model = copy.deepcopy(case["tm"])
    trainer = tdt.DepthTrainer(model, lambda b: model(b["equi"]), cfg)
    batch = {k: torch.tensor(a).double() for k, a in case["batch"].items()}
    loss = trainer.train_step(batch)
    np.testing.assert_allclose(got["losses"][0], float(loss), rtol=1e-9)
    for k, t in model.state_dict().items():
        np.testing.assert_allclose(got["state"][k], t.numpy(), rtol=1e-9,
                                   atol=1e-9 * cfg.learning_rate, err_msg=k)


# ---------------------------------------------------------------------------
# the renderer step and the sharded frame
# ---------------------------------------------------------------------------

def _port_draws(cfg) -> list:
    """The sampling draws of the port's first step: its generator seeded
    with ``cfg.seed``, the whole batch's coarse then fine draws."""
    g = torch.Generator().manual_seed(cfg.seed)
    return [torch.rand((1, RN, DN - 2), generator=g).numpy(),
            torch.rand((1, RN, DN), generator=g).numpy()]


def _jax_mesh_step(case: dict, monkeypatch) -> tuple:
    """One step of the JAX ``Trainer`` on ``make_mesh(2)`` (rays sharded
    by GSPMD), its draws the port's: (metrics, Adam's first moment)."""
    queue = _port_draws(case["cfg"])

    def uniform(key, shape, *a, **kw):
        want = queue.pop(0)
        assert tuple(shape) == want.shape, (shape, want.shape)
        return jnp.asarray(want)
    monkeypatch.setattr(jax.random, "uniform", uniform)
    jm, logged = case["jm"], []
    tc = jtr.TrainerConfig(losses=("render", "depth"), log_interval=1)
    trainer = jtr.Trainer(lambda p, b, r: jm.apply(p, b, rng=r),
                          case["params"], tc,
                          log_fn=lambda s, m: logged.append(m),
                          mesh=jmesh.make_mesh(2))
    trainer.fit(iter([jax.tree.map(jnp.asarray, case["data"])]), 1)
    assert not queue
    mu = next(s.mu for s in trainer.state.opt_state if hasattr(s, "mu"))
    return logged[0], mu


def test_sharded_renderer_step_matches_jax_and_one_rank(cases, port_runs,
                                                        monkeypatch):
    """The 16 rays of a step over 2 ranks: the loss, its terms and the
    gradients equal the port's one-rank step and the JAX ``Trainer`` on a
    2-device mesh (its Adam first moment, 0.1 x the gradient)."""
    case = cases["renderer"]
    one, two = port_runs["step"][1], port_runs["step"][2]
    assert two["metrics"][0].keys() == one["metrics"][0].keys()
    for k, v in one["metrics"][0].items():
        np.testing.assert_allclose(two["metrics"][0][k], v, rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _grads_close(two["grads"], one["grads"], 1e-4)
    jmetrics, mu = _jax_mesh_step(case, monkeypatch)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(two["metrics"][0][k], v, rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    jgrad = {k: t.numpy() * 10.0 for k, t in
             from_jax.renderer_state_dict(_np(mu)).items()}
    _grads_close(two["grads"], {k: jgrad[k] for k in two["grads"]}, 1e-2)
    # every rank ran the same kernel path: the plain mlp2 on the CPU
    assert two["launches"]["mlp2"] == [0, 0]


def test_sharded_renderer_step_at_4_ranks(port_runs):
    one, four = port_runs["step"][1], port_runs["step"][4]
    for k, v in one["metrics"][0].items():
        np.testing.assert_allclose(four["metrics"][0][k], v, rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _grads_close(four["grads"], one["grads"], 1e-4)
    assert four["launches"]["mlp2"] == [0] * 4


@pytest.mark.parametrize("ranks,clr", [(2, 1), (2, 2), (4, 2)])
def test_render_image_sharded_matches_jax_and_one_device(ranks, clr, cases,
                                                         port_runs):
    """A 32x64 frame with its rays (and with ``coarse_lowres`` 2 its
    low-res coarse rays) split over the ranks equals the port's
    ``render_image_device`` and, at 2 ranks, JAX's
    ``render_image_sharded`` on 2 virtual devices."""
    case = cases["renderer"]
    got = port_runs["frame"][(ranks, clr)]["rgb"]
    q = case["data"]["que_imgs_info"]
    ref_info = _ref_info(case["data"])
    tm = case["tm"].eval()
    want = full_render.render_image_device(
        tm, full_render.prepare_ref_data(tm, ref_info, device="cpu"),
        q["c2w"], q["depth_range"], ref_info["depth_range"], chunk=128,
        coarse_lowres=clr, device="cpu")
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-6, rtol=0)
    if ranks != 2:
        return
    jm, params = case["jm"], case["params"]
    ref_data = jax.jit(lambda *a: jm.apply(*a, method=JR.prepare_ref))(
        params, jnp.asarray(ref_info["imgs"]),
        jnp.asarray(ref_info["mvs_depth"]))
    ref_data["w2c"] = jnp.asarray(ref_info["w2c"])
    jrgb = jrender_sharded(jm, params, ref_data, jnp.asarray(q["c2w"]),
                           jnp.asarray(q["depth_range"]),
                           jnp.asarray(ref_info["depth_range"]),
                           jmesh.make_mesh(ranks), coarse_lowres=clr)
    np.testing.assert_allclose(got, np.asarray(jrgb), atol=1e-3, rtol=0)


# ---------------------------------------------------------------------------
# --mesh through the CLIs, and the refusals
# ---------------------------------------------------------------------------

TINY_YAML = "\n".join([
    "name: gen_tiny", f"height: {H}", f"width: {W}", f"depth_height: {DH}",
    f"depth_width: {DW}", "depth_sample_num: 8", "fine_depth_sample_num: 8",
    "use_hierarchical_sampling: true", "loss: [render, depth]",
    "val_interval: 100000", "save_interval: 1000", "seed: 3"]) + "\n"

CLI_ARGV = {
    "train_mono": ["--mono-net", "Equi", "--height", str(H), "--width",
                   str(W), "--batch", "2", "--steps", "2",
                   "--vis-interval", "0", "--log-interval", "1"],
    "train_depth": ["--height", "64", "--width", "128", "--hypotheses",
                    "8", "--batch", "2", "--steps", "2", "--vis-interval",
                    "0", "--log-interval", "1"],
    "train_renderer": ["--cfg", "tiny.yaml", "--steps", "1", "--pool", "1",
                       "--log-interval", "1"],
    "render": ["--height", str(H), "--width", str(W), "--depth-height",
               str(DH), "--depth-width", str(DW), "--num", "1"],
}
TOOLS = {"train_mono": train_mono, "train_depth": train_depth,
         "train_renderer": train_renderer, "render": trender}


def _read_frame(path):
    """A frame the render CLI wrote: its PNG, or the ``.npy`` written
    without imageio."""
    if path.exists():
        import imageio.v2 as imageio
        return np.asarray(imageio.imread(path))
    return np.load(path.with_suffix(".npy"))


def _checkpoint(root) -> dict:
    files = sorted(root.glob("data/**/*.pth"))
    assert len(files) == 1, files
    return torch.load(files[0], map_location="cpu", weights_only=False)


# the first step's clipped gradients of --mesh 2 against one process, of
# each tensor's largest: the MVS net's deepest encoder layers normalise 16
# values a channel at 64x128, whose float32 gradients are ill-conditioned
# (measured 2.2e-2 of a tensor's largest; the mono net's 1.3e-4)
CLI_GRAD_RTOL = {"train_mono": 1e-3, "train_depth": 5e-2}


@pytest.mark.parametrize("tool", sorted(CLI_ARGV))
def test_cli_mesh_2_matches_one_device(tool, tmp_path, monkeypatch, capfd):
    """``--mesh 2 --device cpu`` against the same CLI without ``--mesh``:
    the depth CLIs' logged losses, metrics, first-step gradients and
    checkpointed BatchNorm statistics (2 steps), the renderer's logged
    step and its checkpoint's Adam first moment, the render CLI's frame
    and ``metric.txt``."""
    runs = {}
    for name, extra in (("one", []), ("mesh", ["--mesh", "2"])):
        root = tmp_path / name
        root.mkdir()
        (root / "tiny.yaml").write_text(TINY_YAML)
        monkeypatch.chdir(root)
        argv = [*CLI_ARGV[tool], "--device", "cpu", *extra]
        if tool in CLI_GRAD_RTOL and not extra:
            # the CLI's run without a mesh, with its first gradients
            result = TOOLS[tool].run_rank(TOOLS[tool].parse_args(argv))
        else:
            result = TOOLS[tool].main(argv)
        out = capfd.readouterr().out
        runs[name] = (root, [ln for ln in out.splitlines()
                             if ln.startswith(("step", "eval:", "mean:"))],
                      result)
    (r1, log1, res1), (r2, log2, res2) = runs["one"], runs["mesh"]
    if tool == "render":
        out1, out2 = r1 / "data/render_out", r2 / "data/render_out"
        assert sorted(p.name for p in out1.iterdir()) == \
            sorted(p.name for p in out2.iterdir())
        m1 = json.loads((out1 / "metric.txt").read_text())
        m2 = json.loads((out2 / "metric.txt").read_text())
        for k in ("psnr_nr", "ssim_nr", "wspsnr_nr"):
            np.testing.assert_allclose(m2[k], m1[k], rtol=1e-5, err_msg=k)
        f1, f2 = (_read_frame(o / "0-nr_fine.png") for o in (out1, out2))
        assert f1.shape == (H, W, 3)
        assert np.abs(f1.astype(np.int16) - f2).max() <= 1
        return
    assert len(log1) == len(log2) and log1
    if tool == "train_renderer":
        # a step's losses (its log line's numbers) and gradients
        n1 = [float(t.split("=")[1]) for t in log1[0].split()[3:]]
        n2 = [float(t.split("=")[1]) for t in log2[0].split()[3:]]
        np.testing.assert_allclose(n2, n1, rtol=1e-5)
        o1 = _checkpoint(r1)["optimizer_state_dict"]["state"]
        o2 = _checkpoint(r2)["optimizer_state_dict"]["state"]
        _grads_close({k: s["exp_avg"].numpy() for k, s in o2.items()},
                     {k: s["exp_avg"].numpy() for k, s in o1.items()}, 1e-4)
        return
    for a, b in zip(log1, log2):
        v1 = ast.literal_eval(a.split(": ", 1)[1])
        v2 = ast.literal_eval(b.split(": ", 1)[1])
        for k in v1:
            if k != "sec":
                np.testing.assert_allclose(v2[k], v1[k], rtol=1e-4,
                                           err_msg=f"{a} / {b}")
    assert res2["losses"] == pytest.approx(res1["losses"], rel=1e-4)
    _grads_close(res2["grads"], res1["grads"], CLI_GRAD_RTOL[tool])
    s1, s2 = _checkpoint(r1)["model_state_dict"], \
        _checkpoint(r2)["model_state_dict"]
    assert s1.keys() == s2.keys()
    for k in s1:
        if k.endswith(("running_mean", "running_var")):
            _close(s2[k], s1[k], 1e-2, k)


@pytest.mark.parametrize("tool,argv,error,match", [
    ("train_mono", ["--mesh", "2", "--batch", "3", "--device", "cpu"],
     SystemExit, "multiple of --mesh"),
    ("train_depth", ["--mesh", "2", "--batch", "3", "--device", "cpu"],
     SystemExit, "multiple of --mesh"),
    ("train_renderer", ["--mesh", "3", "--device", "cpu"], SystemExit,
     "must divide the 512 rays"),
    ("render", ["--mesh", "3", "--height", "32", "--width", "64",
                "--device", "cpu"], ValueError, "do not split over 3"),
    ("train_mono", ["--mesh", "2"], ValueError, "device_count"),
    ("render", ["--mesh", "2"], ValueError, "device_count"),
])
def test_cli_mesh_refusals(tool, argv, error, match, tmp_path, monkeypatch):
    """The JAX tools' errors (a batch the mesh does not divide, rays the
    ranks do not split) and more ranks than CUDA devices under NCCL (here
    none), before any rank starts."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(error, match=match):
        TOOLS[tool].main(argv)


def test_make_mesh_refusals():
    with pytest.raises(ValueError, match="device_count"):
        make_mesh(2, device="cuda")
    with pytest.raises(ValueError, match="world of 1"):
        make_mesh(2, device="cpu")
    mesh = make_mesh(1, device="cpu")
    assert mesh.shape == {"data": 1, "ray": 1} and not mesh.distributed
    # the rank programs run on the card unless the caller passes the CPU
    with pytest.raises(ValueError, match="device_count"):
        programs.bn_step(tblocks.ConvBnLReLU3D(4, 6),
                         np.zeros((2, 4, 4, 8, 16), np.float32))


def test_run_ranks_ends_a_failing_or_stuck_group(cases):
    """A rank's exception ends the run with its traceback; a group past
    its deadline is killed."""
    case = cases["conv3d"]
    with pytest.raises(RuntimeError, match="not divisible"):
        run_ranks(programs.bn_step, 2, "cpu",
                  (case["tm"], case["x_t"][:3], "cpu"), deadline_s=DEADLINE_S)
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        run_ranks(time.sleep, 2, "cpu", (120,), deadline_s=3)
    assert time.perf_counter() - t0 < 60
