"""The port's depth-network training against the JAX package, on the CPU
in float32: BatchNorm in training mode, the sweep's image gradient, the
depth losses and metrics, the training forward of every mono net and of
the MVS net (outputs, loss, updated BatchNorm statistics), every
parameter's gradient of both recipes' losses, the clip + Adam update, the
trainer's rolling checkpoints and resume, the multi-view sample, the three
CLIs (``train_mono``, ``train_depth``, ``eval_depth``) and their
checkpoints read by the JAX package's ``load_depth_stack``.

Weights are drawn by the port's seeded initialiser with random BatchNorm
statistics and carried to the JAX modules by the JAX package's converters
(``torch_convert``; ``CubeDepth``, which has none, through
``convert_equi_depth`` with its encoder renamed), the trees checked
against ``jax.eval_shape`` of each ``init``.  Shapes follow
``tests/test_torch_port_depth.py``: mono 64x128, MVS 32x64 with 8
hypotheses, 3 MaGNet samples and a 3D UNet of base 8; the CLIs run at
64x128 (UniFuse's cube fusion needs W >= 128).

Tolerances: outputs, losses, metrics and BatchNorm statistics within 1e-4
of each quantity's scale (measured ~1e-6); the sampler's image gradient
with both packages fed the same coordinates within 1e-5 of its scale; the
sweep's within 1e-4 (its coordinates differ by up to 1e-4 px between the
packages, and bilinear weights are continuous in them); each parameter's
gradient within 1e-3 of that parameter's largest gradient plus 1e-6 of
the tree's largest (parameters whose exact gradient is 0 carry rounding
noise on both sides); the parameters after clip + Adam within rtol 1e-5
plus 1e-4 of the learning rate (the two libraries round the update's
terms in another order, and values that cross 0 have no relative
scale).
"""

import json
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import optax
import pytest
import torch

from panogrf_tpu.core import cubemap as jcube
from panogrf_tpu.data import imgs_info as jinfo
from panogrf_tpu.data import synthetic as jsyn
from panogrf_tpu.models import depth_stack as jds
from panogrf_tpu.models import mvs as jmvs
from panogrf_tpu.models import unifuse as junifuse
from panogrf_tpu.nn import resnet as jresnet
from panogrf_tpu.ops import cost_volume as jcv
from panogrf_tpu.ops import resample as jres
from panogrf_tpu.core.sphere import get_convention as jconv
from panogrf_tpu.train import depth_trainer as jdt
from panogrf_tpu.train import losses as jl
from panogrf_tpu.train import metrics as jm
from panogrf_tpu.utils import torch_convert as tcv
from panogrf_tpu_torch.core.sphere import get_convention as tconv
from panogrf_tpu_torch.data import shards as tshards
from panogrf_tpu_torch.data import synthetic as tsyn
from panogrf_tpu_torch.models import depth_stack as tds
from panogrf_tpu_torch.models import mvs as tmvs
from panogrf_tpu_torch.models import unifuse as tunifuse
from panogrf_tpu_torch.nn import blocks as tblocks
from panogrf_tpu_torch.nn import resnet as tresnet
from panogrf_tpu_torch.ops import cost_volume as tcv_ops
from panogrf_tpu_torch.ops import resample as tres
from panogrf_tpu_torch.parallel.mesh import make_mesh
from panogrf_tpu_torch.tools import eval_depth, train_depth, train_mono
from panogrf_tpu_torch.train import depth_trainer as tdt
from panogrf_tpu_torch.train import losses as tl
from panogrf_tpu_torch.train import metrics as tmetrics
from panogrf_tpu_torch.utils import from_jax
from torch_port_threads import one_torch_thread  # noqa: F401

MH, MW = 64, 128
DH, DW = 32, 64
MVS_KW = {"num_hypotheses": 8, "magnet_num_samples": 3, "cnn3d_base": 8}
REL = 1e-4
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-6
REPO = Path(__file__).resolve().parents[1]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_close(got, want, rel=REL, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


def close_trees(got: dict, want: dict, rel=REL) -> None:
    fg = dict(jax.tree_util.tree_leaves_with_path(got))
    fw = dict(jax.tree_util.tree_leaves_with_path(want))
    assert fg.keys() == fw.keys()
    for k, v in fw.items():
        assert_close(fg[k], v, rel, jax.tree_util.keystr(k))


def seeded(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded weights and random BatchNorm statistics."""
    tblocks.init_parameters_(module, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.num_features, generator=g)
                                 * 0.2)
            m.running_var.copy_(torch.rand(m.num_features, generator=g)
                                + 0.5)
    return module


def numpy_sd(tensors: dict) -> dict:
    return {k: v.detach().float().numpy().copy() for k, v in tensors.items()}


def grad_state(module: torch.nn.Module) -> dict:
    """The module's state dict with each parameter replaced by its
    gradient (0 where the loss does not reach it, as JAX gives): the
    converters then map the gradients onto the JAX tree."""
    sd = numpy_sd(module.state_dict())
    sd.update({k: np.zeros(p.shape, np.float32) if p.grad is None
               else p.grad.numpy() for k, p in module.named_parameters()})
    return sd


def jax_loss_fn(trainer: "jdt.DepthTrainer"):
    """The JAX ``DepthTrainer``'s own ``loss_fn(params, state, batch) ->
    (loss, new_state)``, taken from the closure of its jitted step."""
    fn = trainer._train_step.__wrapped__
    cells = dict(zip(fn.__code__.co_freevars, fn.__closure__))
    return cells["loss_fn"].cell_contents


def assert_grads_close(got: dict, want: dict) -> None:
    fg = dict(jax.tree_util.tree_leaves_with_path(got))
    fw = dict(jax.tree_util.tree_leaves_with_path(want))
    assert fg.keys() == fw.keys()
    floor = GRAD_ATOL_REL * max(float(np.abs(v).max()) for v in fw.values())
    bad = {}
    for k, v in fw.items():
        v = np.asarray(v)
        err = float(np.abs(np.asarray(fg[k]) - v).max())
        if err > GRAD_RTOL * float(np.abs(v).max()) + floor:
            bad[jax.tree_util.keystr(k)] = (err, float(np.abs(v).max()))
    assert not bad, bad


# ---------------------------------------------------------------------------
# (a) BatchNorm in training mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 1, 1, 6), (2, 5, 7, 6), (3, 4, 6, 6)])
def test_batch_norm_training_matches_jax(shape):
    """Batch statistics normalise the output, and the running statistics
    move towards the batch mean and BIASED variance with momentum 0.9.
    At shape (2, 1, 1, C) each channel has 2 values, where torch's own
    BatchNorm2d (unbiased variance) would move them by twice as much."""
    rng = np.random.default_rng(0)
    c = shape[-1]
    x = (rng.normal(size=shape) * 2.0 + 0.7).astype(np.float32)
    scale, bias = (rng.normal(size=c).astype(np.float32) for _ in range(2))
    mean = rng.normal(size=c).astype(np.float32)
    var = rng.uniform(0.5, 1.5, size=c).astype(np.float32)
    variables = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
                 "batch_stats": {"BatchNorm_0": {"mean": mean, "var": var}}}
    want, new = jresnet._BN().apply(variables, jnp.asarray(x), True,
                                    mutable=["batch_stats"])
    bn = tresnet.batch_norm(c).train()
    sd = {"weight": scale, "bias": bias, "running_mean": mean,
          "running_var": var}
    with torch.no_grad():
        for k, v in sd.items():
            getattr(bn, k).copy_(torch.tensor(v))
    got = bn(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert_close(got, want)
    stats = new["batch_stats"]["BatchNorm_0"]
    assert_close(bn.running_mean, stats["mean"])
    assert_close(bn.running_var, stats["var"])
    assert int(bn.num_batches_tracked) == 1
    # eval mode normalises with the running statistics, as use_running_average
    want_eval = jresnet._BN().apply(
        {"params": variables["params"], "batch_stats": new["batch_stats"]},
        jnp.asarray(x), False)
    assert_close(bn.eval()(torch.tensor(x).permute(0, 3, 1, 2))
                 .permute(0, 2, 3, 1), want_eval)
    if shape[1:3] == (1, 1):
        plain = torch.nn.BatchNorm2d(c, momentum=0.1).train()
        plain.running_var.copy_(torch.tensor(var))
        plain(torch.tensor(x).permute(0, 3, 1, 2))
        moved_plain = plain.running_var.numpy() - 0.9 * var
        np.testing.assert_allclose(moved_plain, 2 * (np.asarray(
            stats["var"]) - 0.9 * var), rtol=1e-4)


# ---------------------------------------------------------------------------
# (b) the sweep's gradient
# ---------------------------------------------------------------------------

def _sample_points(rng, h, w, n):
    """Random points over and past every border, plus the cases: x on
    the x = W-1 seam and between it and column 0, x past W and below 0
    (wrapping), y past both borders, integer pixels, repeated points."""
    xy = np.stack([rng.uniform(-3, w + 3, n), rng.uniform(-2, h + 1, n)],
                  -1)
    special = [[w - 1.0, 1.5], [w - 0.5, 2.25], [w - 0.01, 0.0],
               [-0.5, 3.0], [w + 0.25, h - 1.0], [-w - 0.75, 1.0],
               [0.0, 0.0], [3.0, 2.0], [2.5, -1.5], [4.25, h + 0.5],
               [w - 0.5, 2.25]]
    return np.concatenate([xy, special]).astype(np.float32)


@pytest.mark.parametrize("wrap_x", [True, False])
def test_sampler_image_gradient_matches_mm_backward(wrap_x):
    """d(sum(g * sample(img, xy)))/d img: autograd's scatter transpose of
    the port's 4-tap gather against the JAX package's dense one-hot
    matmul backward, both fed the same coordinates."""
    rng = np.random.default_rng(1)
    b, h, w, c = 2, 6, 9, 4
    img = rng.normal(size=(b, h, w, c)).astype(np.float32)
    xy = np.stack([_sample_points(rng, h, w, 60) for _ in range(b)])
    g = rng.normal(size=xy.shape[:-1] + (c,)).astype(np.float32)
    sampler = jax.vmap(jres.make_mm_backward_sampler(wrap_x=wrap_x))

    def jloss(im):
        return jnp.sum(sampler(im, jnp.asarray(xy)) * g)
    want_out = sampler(jnp.asarray(img), jnp.asarray(xy))
    want = jax.grad(jloss)(jnp.asarray(img))
    img_t = torch.tensor(img, requires_grad=True)
    xy_t = torch.tensor(xy)
    out = tres.batched_bilinear_sample(img_t, xy_t, wrap_x)
    assert_close(out, want_out, 1e-6)
    (out * torch.tensor(g)).sum().backward()
    assert_close(img_t.grad, want, 1e-5)
    assert xy_t.grad is None


def test_sampler_gradient_where_x_wraps_to_w():
    """An x just below 0 wraps to exactly W in float32: the forward reads
    column W-1 (the window start is clamped), and the port's gradient goes
    there too, as jax.grad of the JAX ``bilinear_sample`` (its scatter
    transpose) gives.  The JAX matmul backward drops such a point's
    gradient (its one-hot of column W is empty); ROADMAP Queue 3."""
    rng = np.random.default_rng(3)
    img = rng.normal(size=(4, 8, 2)).astype(np.float32)
    xy = np.asarray([[-1e-7, 1.5], [7.5, 2.0], [3.5, 0.5]], np.float32)
    want = jax.grad(lambda im: jnp.sum(jres.bilinear_sample(im, xy)))(
        jnp.asarray(img))
    img_t = torch.tensor(img, requires_grad=True)
    tres.batched_bilinear_sample(img_t[None], torch.tensor(xy)[None]).sum() \
        .backward()
    assert_close(img_t.grad, want, 1e-6)
    # column 7 takes all of the first point and half of the second
    assert float(img_t.grad[:, 7].sum()) == pytest.approx(2 * (1.0 + 0.5))


def test_sweep_gradient_matches_jax():
    """The cost volume's gradient w.r.t. both feature maps against
    jax.grad through ``spherical_sweep_cost`` (the matmul backward; zero
    cotangent for the coordinates); the port builds no graph for the
    coordinates."""
    rng = np.random.default_rng(2)
    h, w, d, c = 8, 16, 6, 5
    ref, src = (rng.normal(size=(h, w, c)).astype(np.float32)
                for _ in range(2))
    dvol = rng.uniform(0.3, 8.0, size=(d, h, w)).astype(np.float32)
    rots = []
    for a in rng.uniform(-0.3, 0.3, size=2):
        ca, sa = np.cos(a), np.sin(a)
        rots.append(np.asarray([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]],
                               np.float32))
    trans = rng.normal(scale=0.5, size=(2, 3)).astype(np.float32)
    g = rng.normal(size=(d, h, w, c)).astype(np.float32)
    jc, tc = jconv("m3d"), tconv("m3d")

    def jloss(ref, src):
        return jnp.sum(g * jcv.spherical_sweep_cost(
            ref, src, dvol, rots[1], trans[1], rots[0], trans[0], jc))
    want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(ref, src)
    ref_t, src_t = (torch.tensor(a, requires_grad=True) for a in (ref, src))
    rot_t = torch.tensor(np.stack(rots))[None]
    dvol_t = torch.tensor(dvol, requires_grad=True)
    cost = tcv_ops.batched_sweep_cost(ref_t[None], src_t[None], dvol_t[None],
                                      rot_t, torch.tensor(trans)[None], tc)
    (cost[0] * torch.tensor(g)).sum().backward()
    assert_close(ref_t.grad, want[0], what="ref")
    assert_close(src_t.grad, want[1], what="src")
    assert dvol_t.grad is None


# ---------------------------------------------------------------------------
# (c) losses and metrics
# ---------------------------------------------------------------------------

def _depth_pair(seed, shape=(2, 8, 16, 1)):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0.0, 11.0, size=shape).astype(np.float32)
    pred = (gt + rng.normal(scale=1.5, size=shape)).astype(np.float32)
    mask = (rng.uniform(size=shape) > 0.3).astype(np.float32)
    return pred, gt, mask


@pytest.mark.parametrize("masked", [False, True])
def test_depth_losses_match_jax(masked):
    pred, gt, mask = _depth_pair(3)
    rng = np.random.default_rng(4)
    sigma = rng.uniform(0.2, 2.0, size=pred.shape).astype(np.float32)
    # the Gaussian NLL's variance floor (1e-6) and the Laplacian scale's
    # (1e-4) bind at these sigmas
    sigma.reshape(-1)[:7] = [0.0, 1e-5, 5e-4, -1e-4, 2e-3, 1e-3, 1e-7]
    m = mask if masked else None
    J = lambda a: None if a is None else jnp.asarray(a)      # noqa: E731
    T = lambda a: None if a is None else torch.tensor(a)     # noqa: E731
    cases = [
        (jl.l1_sphere_loss(J(pred), J(gt), J(m)),
         tl.l1_sphere_loss(T(pred), T(gt), T(m))),
        (jl.gaussian_nll_loss(J(pred), J(sigma), J(gt), J(m)),
         tl.gaussian_nll_loss(T(pred), T(sigma), T(gt), T(m))),
        (jl.gaussian_nll_loss(J(pred), J(sigma), J(gt), J(m), False),
         tl.gaussian_nll_loss(T(pred), T(sigma), T(gt), T(m), False)),
        (jl.laplacian_nll_loss(J(pred), J(sigma), J(gt), J(m)),
         tl.laplacian_nll_loss(T(pred), T(sigma), T(gt), T(m)))]
    for thr in (0.2, 0.05, 1.0):
        cases.append((jl.berhu_loss(J(pred), J(gt), J(m), thr),
                      tl.berhu_loss(T(pred), T(gt), T(m), thr)))
    for i, (want, got) in enumerate(cases):
        assert_close(got, want, what=i)
    for kind in ("l1_sphere", "berhu", "gaussian_nll"):
        assert_close(tdt.depth_loss_fn(kind, T(pred), T(gt), T(m), T(sigma)),
                     jdt.depth_loss_fn(kind, J(pred), J(gt), J(m), J(sigma)),
                     what=kind)
    assert_close(tl.sin_phi_map(8, 16), jl.sin_phi_map(8, 16), 1e-6)


def test_depth_metrics_match_jax():
    """Both ERP tables (``l2_error`` deliberately unmasked), the cube-face
    z-depth table and ``distance_to_zdepth``; the predictions and truths
    reach past both ends of the depth range."""
    pred, gt, _ = _depth_pair(5, (16, 32, 1))
    gt.reshape(-1)[:20] = 12.0                     # beyond max_depth
    gt.reshape(-1)[20:40] = 0.05                   # below min_depth
    pred.reshape(-1)[40:50] = -1.0
    for fn, args in (("depth_metrics_erp", ()),
                     ("depth_metrics_erp", (0.5, 8.0)),
                     ("depth_metrics_erp_full", ()),
                     ("depth_metrics_zdepth", ())):
        want = getattr(jm, fn)(jnp.asarray(pred), jnp.asarray(gt), *args)
        got = getattr(tmetrics, fn)(torch.tensor(pred), torch.tensor(gt),
                                    *args)
        assert set(got) == set(want), fn
        for k in want:
            assert_close(got[k], want[k], what=(fn, k))
    for x in (pred, pred[..., 0]):
        assert_close(tmetrics.distance_to_zdepth(torch.tensor(x)),
                     jm.distance_to_zdepth(jnp.asarray(x)), 1e-6)


# ---------------------------------------------------------------------------
# (d, e) training forwards and gradients
# ---------------------------------------------------------------------------

MONO = {"UniFuse": (tunifuse.UniFuse, junifuse.UniFuse),
        "Equi": (tunifuse.EquiDepth, junifuse.EquiDepth),
        "Cube": (tunifuse.CubeDepth, junifuse.CubeDepth)}


def mono_variables(name: str, sd: dict) -> dict:
    """The JAX variables of a port mono net's numpy state dict,
    uncertainty head included."""
    if name == "UniFuse":
        v = tcv.convert_unifuse(sd)
    elif name == "Equi":
        v = tcv.convert_equi_depth(sd)
    else:         # no converter of its own: EquiDepth's, encoder renamed
        v = tcv.convert_equi_depth({k.replace("cube_encoder", "equi_encoder"):
                                    a for k, a in sd.items()})
        v = {col: {("cube_encoder" if k == "equi_encoder" else k): t
                   for k, t in tree.items()} for col, tree in v.items()}
    if "uncert_head.conv.weight" in sd:
        v["params"]["uncert_head"] = {"Conv_0": {
            "kernel": tcv.t2f_conv(sd["uncert_head.conv.weight"]),
            "bias": sd["uncert_head.conv.bias"]}}
    return v


def _mono_batch(seed, with_cube):
    rng = np.random.default_rng(seed)
    equi = rng.normal(size=(2, MH, MW, 3)).astype(np.float32)
    batch = {"equi": equi,
             "gt_depth": rng.uniform(0.2, 9.0, size=(2, MH, MW, 1))
             .astype(np.float32)}
    if with_cube:
        batch["cube"] = np.asarray(jax.vmap(
            lambda e: jcube.equi_to_cube(e, MH // 2))(jnp.asarray(equi)))
    return batch


def _mono_setup(name, uncertainty, seed):
    tcls, jcls = MONO[name]
    tm = seeded(tcls(uncertainty=uncertainty), seed).train()
    variables = mono_variables(name, numpy_sd(tm.state_dict()))
    with_cube = name != "Equi"
    batch = _mono_batch(seed, with_cube)
    args = ("equi", "cube") if with_cube else ("equi",)
    jmodel = jcls(uncertainty=uncertainty)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            *(jnp.asarray(batch[a]) for a in args))
    for col in ("params", "batch_stats"):
        assert tcv.verify_tree_shapes(variables[col], shapes[col]) == []
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}

    def tforward(b):
        return tm(*(b[a] for a in args))

    def jforward(v, b, train):
        if train:
            return jmodel.apply(v, *(b[a] for a in args), train=True,
                                mutable=["batch_stats"])
        return jmodel.apply(v, *(b[a] for a in args)), {}
    loss_type = "gaussian_nll" if uncertainty else "l1_sphere"
    return tm, variables, batch, tbatch, tforward, jforward, loss_type


@pytest.mark.parametrize("name,uncertainty", [
    ("UniFuse", False), ("UniFuse", True), ("Equi", False), ("Equi", True),
    ("Cube", False), ("Cube", True)])
def test_mono_training_forward_matches_jax(name, uncertainty):
    """One training-mode forward: outputs, the trainer's loss and the
    updated BatchNorm statistics; then the weights' round trip through
    ``from_jax``."""
    tm, variables, batch, tbatch, tforward, jforward, loss_type = \
        _mono_setup(name, uncertainty, 20)
    want, new_state = jax.jit(lambda v, b: jforward(v, b, True))(
        variables, batch)
    cfg = tdt.DepthTrainConfig(loss_type=loss_type, aux_d1_weight=0.0)
    trainer = tdt.DepthTrainer(tm, tforward, cfg)
    with torch.no_grad():
        got = tforward(tbatch)
        loss = trainer.loss(got, tbatch)
    for k in want:
        assert_close(got[k], want[k], what=k)
    sigma = want["pred"][..., 1:] if uncertainty else None
    pred = want["pred"][..., :1] if uncertainty else want["pred_depth"]
    assert_close(loss, jdt.depth_loss_fn(loss_type, pred, batch["gt_depth"],
                                         None, sigma), what="loss")
    close_trees(mono_variables(name, numpy_sd(tm.state_dict()))[
        "batch_stats"], new_state["batch_stats"])
    # JAX variables -> the port module -> the same variables back
    back = from_jax.load_jax_params(MONO[name][0](uncertainty=uncertainty),
                                    variables)
    close_trees(mono_variables(name, numpy_sd(back.state_dict())),
                variables, 0)


@pytest.mark.parametrize("name,uncertainty", [("UniFuse", False),
                                              ("Equi", True)])
def test_mono_gradients_match_jax(name, uncertainty):
    """Every parameter's gradient of the trainer's loss against
    ``jax.value_and_grad`` of the JAX DepthTrainer's ``loss_fn`` (the mono
    recipe's l1_sphere, and the Gaussian NLL of an uncertainty head)."""
    tm, variables, batch, tbatch, tforward, jforward, loss_type = \
        _mono_setup(name, uncertainty, 21)
    cfg = dict(loss_type=loss_type, aux_d1_weight=0.0)
    jtrainer = jdt.DepthTrainer(jforward, variables,
                                jdt.DepthTrainConfig(**cfg))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jax_loss_fn(jtrainer), has_aux=True))(
        variables["params"], {"batch_stats": variables["batch_stats"]},
        batch)
    trainer = tdt.DepthTrainer(tm, tforward, tdt.DepthTrainConfig(**cfg))
    tm.zero_grad()
    loss = trainer.loss(tforward(tbatch), tbatch)
    loss.backward()
    assert_close(loss, jloss, what="loss")
    assert_grads_close(mono_variables(name, grad_state(tm))["params"],
                       jgrads)


def _mvs_batch(seed):
    """A 2-view MVS batch: the source 0.6 along z and 0.2 along -x of the
    reference, off the reference's longitude seam."""
    rng = np.random.default_rng(seed)
    rots = np.broadcast_to(np.eye(3, dtype=np.float32), (2, 2, 3, 3)).copy()
    trans = np.zeros((2, 2, 3), np.float32)
    trans[:, 0, 2] = 0.6
    trans[:, 0, 0] = -0.2
    return {"panos": rng.uniform(size=(2, 2, DH, DW, 3)).astype(np.float32),
            "rots": rots, "trans": trans,
            "mono_depth": rng.uniform(0.5, 8.0, size=(2, MH, MW, 1))
            .astype(np.float32),
            "mono_feat": rng.normal(size=(2, MH // 2, MW // 2, 32))
            .astype(np.float32),
            "gt_depth": rng.uniform(0.3, 9.0, size=(2, DH, DW, 1))
            .astype(np.float32)}


_MVS_ARGS = ("panos", "rots", "trans", "mono_depth", "mono_feat")


@pytest.mark.parametrize("uncertainty", [False, True])
def test_mvs_training_matches_jax(uncertainty):
    """The MVS recipe's training step on the JAX DepthTrainer's own
    ``loss_fn`` (l1_sphere, or the Gaussian NLL of ``pred_final``, plus
    0.5 x the L1 of ``rectified_depth_d1``): the loss, the feature net's
    updated BatchNorm statistics (over the B x V views) and every
    parameter's gradient, the sweep's included."""
    kw = {**MVS_KW, "mvs_uncertainty": uncertainty}
    tm = seeded(tmvs.MVSDepthModel(**kw), 30).train()
    variables = tcv.convert_mvs(numpy_sd(tm.state_dict()))
    batch = _mvs_batch(30)
    jmodel = jmvs.MVSDepthModel(**kw)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            *(batch[a] for a in _MVS_ARGS))
    for col in ("params", "batch_stats"):
        assert tcv.verify_tree_shapes(variables[col], shapes[col]) == []

    def jforward(v, b, train):
        out, mut = jmodel.apply(v, *(b[a] for a in _MVS_ARGS), train=True,
                                mutable=["batch_stats"])
        out = dict(out)
        out["pred_depth"] = out.pop("depth")
        if uncertainty:
            out["pred"] = out["pred_final"]
        return out, dict(mut)
    cfg = dict(loss_type="gaussian_nll" if uncertainty else "l1_sphere")
    jtrainer = jdt.DepthTrainer(jforward, variables,
                                jdt.DepthTrainConfig(**cfg))
    (jloss, new_state), jgrads = jax.jit(jax.value_and_grad(
        jax_loss_fn(jtrainer), has_aux=True))(
        variables["params"], {"batch_stats": variables["batch_stats"]},
        batch)

    def tforward(b):
        out = tm(*(b[a] for a in _MVS_ARGS))
        out["pred_depth"] = out.pop("depth")
        if uncertainty:
            out["pred"] = out["pred_final"]
        return out
    trainer = tdt.DepthTrainer(tm, tforward, tdt.DepthTrainConfig(**cfg))
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    loss = trainer.loss(tforward(tbatch), tbatch)
    loss.backward()
    assert_close(loss, jloss, what="loss")
    close_trees(tcv.convert_mvs(numpy_sd(tm.state_dict()))["batch_stats"],
                new_state["batch_stats"])
    assert_grads_close(tcv.convert_mvs(grad_state(tm))["params"], jgrads)
    # the round trip of the uncertainty head's weights
    back = from_jax.load_jax_params(tmvs.MVSDepthModel(**kw), variables)
    close_trees(tcv.convert_mvs(numpy_sd(back.state_dict())), variables, 0)


# ---------------------------------------------------------------------------
# (f, g) the optimiser and the trainer
# ---------------------------------------------------------------------------

class _TinyDepth(torch.nn.Module):
    """conv -> BatchNorm -> conv -> 10 sigmoid: a depth net of a few
    parameters for the trainer's bookkeeping."""

    def __init__(self):
        super().__init__()
        self.conv1 = torch.nn.Conv2d(3, 4, 3, padding=1)
        self.bn = tresnet.batch_norm(4)
        self.conv2 = torch.nn.Conv2d(4, 1, 3, padding=1)

    def forward(self, equi):
        x = torch.relu(self.bn(self.conv1(equi.permute(0, 3, 1, 2))))
        return {"pred_depth": 10 * torch.sigmoid(self.conv2(x))
                .permute(0, 2, 3, 1)}


def test_clip_and_adam_match_optax():
    """Three updates on fixed gradients against optax.chain(clip(1.0),
    adam(lr)): elements past +-1 are clipped, the moments carry over."""
    rng = np.random.default_rng(40)
    model = _TinyDepth()
    p0 = {k: p.detach().numpy().copy() for k, p in model.named_parameters()}
    cfg = tdt.DepthTrainConfig(learning_rate=1e-2)
    trainer = tdt.DepthTrainer(model, lambda b: model(b["equi"]), cfg)
    tx = optax.chain(optax.clip(cfg.clip_grad_value),
                     optax.adam(cfg.learning_rate, b1=cfg.opt_beta1,
                                b2=cfg.opt_beta2))
    jp = jax.tree.map(jnp.asarray, p0)
    state = tx.init(jp)
    for sc in (3.0, 0.1, 1.0):
        grads = {k: (rng.normal(size=v.shape) * sc).astype(np.float32)
                 for k, v in p0.items()}
        upd, state = tx.update(jax.tree.map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in model.named_parameters():
            p.grad = torch.tensor(grads[k])
        trainer.update()
        for k, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def _tiny_batches(seed):
    rng = np.random.default_rng(seed)
    while True:
        yield {"equi": torch.tensor(rng.normal(size=(2, 8, 16, 3))
                                    .astype(np.float32)),
               "gt_depth": torch.tensor(rng.uniform(0.5, 9, (2, 8, 16, 1))
                                        .astype(np.float32))}


def test_trainer_rolls_checkpoints_and_resumes(tmp_path):
    """Checkpoints every step keep the newest ``checkpoint_count`` files,
    with the frozen modules under their prefix; a new trainer restores the
    newest and continues its step count; every ``vis_interval`` steps a
    turbo sheet is written; ``evaluate`` gives the ERP metrics."""
    def trainer(seed):
        torch.manual_seed(seed)
        model, frozen = _TinyDepth(), _TinyDepth()
        cfg = tdt.DepthTrainConfig(name="tiny", save_dir=str(tmp_path),
                                   checkpoint_interval=1, checkpoint_count=2,
                                   log_interval=1, vis_interval=2)
        return tdt.DepthTrainer(model, lambda b: model(b["equi"]), cfg,
                                frozen={"d_net": frozen})
    a = trainer(0)
    logged = []
    a.log_fn = lambda s, m: logged.append((s, m))
    a.fit(_tiny_batches(0), 3)
    assert [s for s, _ in logged] == [1, 2, 3]
    assert all(np.isfinite(m["loss"]) for _, m in logged)
    root = tmp_path / "tiny"
    assert [p.name for p in a.checkpoints()] == ["checkpoint_2.pth",
                                                 "checkpoint_3.pth"]
    assert sorted(p.name for p in (root / "vis").iterdir()) == [
        "step000002-0-depth.png"]
    sd = tds.read_checkpoint(root / "checkpoint_3.pth")
    assert {k[len("d_net."):] for k in sd if k.startswith("d_net.")} == \
        set(a.frozen["d_net"].state_dict())
    assert int(sd["bn.num_batches_tracked"]) == 3
    b = trainer(1)
    assert b.restore() and b.step == 3
    for k, v in a.model.state_dict().items():
        torch.testing.assert_close(b.model.state_dict()[k], v, rtol=0,
                                   atol=0)
    b.fit(_tiny_batches(1), 2)
    assert b.step == 5
    assert [p.name for p in b.checkpoints()] == ["checkpoint_4.pth",
                                                 "checkpoint_5.pth"]
    m = b.evaluate(_tiny_batches(2), 2)
    assert set(m) == {"mae", "rmse", "abs_rel", "delta1", "delta2",
                      "delta3"}
    assert all(np.isfinite(v) for v in m.values())
    # a world-1 mesh trains on its rank as the plain trainer does
    c = tdt.DepthTrainer(a.model, a.forward_fn, a.cfg,
                         mesh=make_mesh(1, device="cpu"))
    assert c.is_chief and torch.isfinite(c.train_step(
        next(_tiny_batches(3))))


# ---------------------------------------------------------------------------
# (i) the multi-view sample, (j, h) the CLIs and their checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("views", [2, 4])
def test_multi_view_sample_matches_jax(views):
    want = jsyn.make_multi_view_sample(jsyn.SphereScene.random(50), 16, 32,
                                       views, 0.25, seed=51)
    got = tsyn.make_multi_view_sample(tsyn.SphereScene.random(50), 16, 32,
                                      views, 0.25, seed=51)
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], 1e-5, k)
    assert got["rgb_panos"].shape == (views, 16, 32, 3)
    assert train_depth.view_order(views) == (
        [0, 1] if views == 2 else [0, 3, 1, 2])


CLI_HW = ["--height", str(MH), "--width", str(MW)]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Two CPU steps of train_mono and of train_depth on its checkpoint
    (64x128, 8 hypotheses), run in a scratch working directory."""
    root = tmp_path_factory.mktemp("cli")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        logs = {"mono": [], "mvs": []}
        mono = train_mono.main(
            ["--steps", "2", *CLI_HW, "--device", "cpu", "--log-interval",
             "1", "--vis-interval", "2"],
            log_fn=lambda s, m: logs["mono"].append((s, m)))
        mono_ckpt = root / "data/depth_model/mono_run/checkpoint_2.pth"
        mvs = train_depth.main(
            ["--steps", "2", *CLI_HW, "--hypotheses", "8", "--device", "cpu",
             "--log-interval", "1", "--mono-ckpt", str(mono_ckpt)],
            log_fn=lambda s, m: logs["mvs"].append((s, m)))
    return {"root": root, "logs": logs, "mono": mono, "mvs": mvs,
            "mono_ckpt": mono_ckpt,
            "mvs_ckpt": root / "data/depth_model/mvs_run/checkpoint_2.pth"}


def test_cli_train_two_steps(cli_runs):
    for net in ("mono", "mvs"):
        logs = cli_runs["logs"][net]
        assert [s for s, _ in logs] == [1, 2], net
        assert all(np.isfinite(m["loss"]) for _, m in logs)
        assert cli_runs[net].step == 2
        assert cli_runs[f"{net}_ckpt"].exists()
    assert (cli_runs["root"] / "data/depth_model/mono_run/vis/"
            "step000002-0-depth.png").exists()
    # the MVS checkpoint carries the frozen mono prior, unchanged
    mono_sd = tds.read_checkpoint(cli_runs["mono_ckpt"])
    dnet = tds.extract_dnet(tds.read_checkpoint(cli_runs["mvs_ckpt"]))
    assert dnet.keys() == mono_sd.keys()
    for k, v in mono_sd.items():
        torch.testing.assert_close(dnet[k], v, rtol=0, atol=0)


def test_cli_first_batch_follows_the_jax_tools_draws():
    """train_mono's first training batch is the second batch the JAX
    tool's draws give (its first initialises the net): the same scenes,
    view 1, clipped depth, normalised ERP and cubemap."""
    _, stream, _ = train_mono.build(train_mono.parse_args(
        [*CLI_HW, "--batch", "1", "--device", "cpu"]))
    got = next(stream)
    rng = np.random.default_rng(2022)
    for _ in range(2):
        scene = jsyn.SphereScene.random(int(rng.integers(1 << 30)))
        s = jsyn.make_three_view_sample(scene, MH, MW, 0.5,
                                        seed=int(rng.integers(1 << 30)))
    equi = junifuse.normalize_imagenet(s["rgb_panos"][1][None])
    want = {"equi": equi,
            "gt_depth": jnp.clip(s["depth_panos"][1], 0, 10.0)[None],
            "cube": jax.vmap(lambda e: jcube.equi_to_cube(e, MH // 2))(equi)}
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], 1e-4, k)


def _template_init(self, *args):
    """``init`` by shapes alone: ``load_depth_stack`` reads a torch file's
    weights through its converter and uses the initialised tree only as
    the template of an orbax restore, while an eager ``init`` of both nets
    takes ~80 s on the CPU."""
    return jax.eval_shape(lambda *a: fnn.Module.init(self, *a), *args)


def test_cli_checkpoints_load_in_jax_depth_stack(cli_runs, monkeypatch):
    """The port-written mono and MVS checkpoints, read by the JAX
    package's load_depth_stack (torch files through its converters) and by
    the port's from the MVS file alone, give the same depth; their
    BatchNorm statistics come from two training steps."""
    for cls in (junifuse.UniFuse, jmvs.MVSDepthModel):
        monkeypatch.setattr(cls, "init", _template_init)
    js = jsyn.make_three_view_sample(jsyn.SphereScene.random(21), DH, DW,
                                     m3d_dist=0.3, seed=3)
    ts = {k: torch.tensor(np.asarray(v)) for k, v in js.items()}
    jstack = jds.load_depth_stack(str(cli_runs["mono_ckpt"]),
                                  str(cli_runs["mvs_ckpt"]), (MH, MW),
                                  (DH, DW), mvs_kwargs={"num_hypotheses": 8})
    tstack = tds.load_depth_stack(None, str(cli_runs["mvs_ckpt"]), (MH, MW),
                                  (DH, DW), device="cpu")
    assert tstack.mvs_model.num_hypotheses == 8
    want = jax.tree.map(np.asarray, jds.stack_depth_for_sample(
        jstack.jitted(), js, jinfo.REF_IDS, jinfo.SRC_IDS))
    got = tds.stack_depth_for_sample(tstack, ts, jinfo.REF_IDS,
                                     jinfo.SRC_IDS)
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], what=k)
    assert int(tds.read_checkpoint(cli_runs["mvs_ckpt"])[
        "unet.equi_encoder.bn1.num_batches_tracked"]) == 2


def test_cli_eval_depth_prints_the_table(cli_runs, capsys, monkeypatch):
    monkeypatch.chdir(cli_runs["root"])
    table = eval_depth.main(["--num", "1", *CLI_HW, "--device", "cpu",
                             "--mvs-ckpt", str(cli_runs["mvs_ckpt"])])
    printed = json.loads(capsys.readouterr().out)
    assert printed == table and set(table) == {"mono", "mvs"}
    for net in table.values():
        assert set(net) == {"mae", "rmse", "abs_rel", "delta1", "delta2",
                            "delta3"}
        assert all(np.isfinite(v) for v in net.values())


def test_cli_train_depth_reads_its_recipe(tmp_path, monkeypatch):
    """--cfg supplies the defaults and flags win: one step of the V = 4
    recipe at 64x128, 8 hypotheses."""
    monkeypatch.chdir(tmp_path)
    argv = ["--cfg", str(REPO / "configs/depth/m3d_mvs_v4.yaml"), *CLI_HW,
            "--hypotheses", "8", "--steps", "1", "--batch", "1",
            "--vis-interval", "0", "--device", "cpu"]
    args = train_depth.parse_args(argv)
    assert (args.views, args.m3d_dist, args.name, args.height,
            args.hypotheses, args.batch) == (4, 0.25, "m3d_mvs_v4", MH, 8, 1)
    trainer, stream, steps = train_depth.build(args)
    batch = next(stream)
    assert batch["panos"].shape == (1, 4, MH, MW, 3)
    trainer.fit(stream, steps)
    assert trainer.step == 1


@pytest.mark.parametrize("tool,argv", [
    ("train_mono", ["--mesh", "2", "--batch", "3"]),
    ("train_depth", ["--mesh", "2", "--batch", "3"])])
def test_cli_refuses_what_is_not_ported(tool, argv, tmp_path, monkeypatch):
    """``--mesh`` is ported (``tests/test_torch_port_parallel.py``); a batch
    it does not divide is refused with the JAX tools' error."""
    monkeypatch.chdir(tmp_path)
    mod = {"train_mono": train_mono, "train_depth": train_depth}[tool]
    with pytest.raises(SystemExit, match="multiple of --mesh"):
        mod.main([*argv, *CLI_HW, "--device", "cpu"])


@pytest.fixture(scope="module")
def shards_64(tmp_path_factory):
    """3 procedural three-view samples at 64x128 in a shard directory."""
    root = tmp_path_factory.mktemp("shards") / "s"
    tshards.write_synthetic_dataset(root, 3, MH, MW, seed=6,
                                    samples_per_shard=2, device="cpu")
    return root


def _jax_tool_first_batch(tool: str, argv: list, monkeypatch) -> dict:
    """The first training batch of the JAX tool ``tools/<tool>.py`` on
    ``argv``, as numpy: its nets are stubs (the batch takes nothing from
    their weights but the frozen mono prior's outputs, which the stubs
    fill with zeros) and its trainer hands over the first batch of the
    stream it is given."""
    import importlib.util
    import sys

    class Net:
        def __init__(self, *a, **kw):
            pass

        def init(self, key, *a, **kw):
            return {"params": {"w": jnp.zeros(1)}}

        def apply(self, variables, equi, *a, **kw):
            zeros = jnp.zeros(equi.shape[:-1] + (1,))
            return {"pred_depth": zeros, "mono_feat": zeros}

    class FirstBatch(Exception):
        pass

    class Trainer:
        def __init__(self, *a, **kw):
            pass

        def restore(self):
            pass

        def fit(self, batches, steps):
            raise FirstBatch(next(batches))

    monkeypatch.setattr(junifuse, "select_mono", lambda cfg: Net())
    monkeypatch.setattr(junifuse, "UniFuse", Net)
    monkeypatch.setattr(jmvs, "MVSDepthModel", Net)
    monkeypatch.setattr(jdt, "DepthTrainer", Trainer)
    monkeypatch.setattr(sys, "argv", [tool, *argv])
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{tool}", REPO / "tools" / f"{tool}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(FirstBatch) as got:
        mod.main()
    return {k: np.asarray(v) for k, v in got.value.args[0].items()}


@pytest.mark.parametrize("tool", ["train_mono", "train_depth"])
def test_cli_trains_on_shards(tool, shards_64, tmp_path, monkeypatch):
    """``--shards`` at 64x128, batch 1: the first training batch equals the
    JAX tool's first on the same shards and flags (the same shard sample
    and, for train_mono, view: its rgb as the network input and cube
    faces within 1e-6, the ground-truth depth, and for train_depth the
    views and their poses, exactly), and one step trains; train_depth
    refuses more views than the shards hold."""
    monkeypatch.chdir(tmp_path)
    mod = {"train_mono": train_mono, "train_depth": train_depth}[tool]
    flags = ["--shards", str(shards_64), *CLI_HW, "--batch", "1",
             "--steps", "1", "--vis-interval", "0"]
    if tool == "train_depth":
        flags += ["--hypotheses", "8"]
    argv = flags + ["--device", "cpu"]
    trainer, stream, steps = mod.build(mod.parse_args(argv))
    batch = {k: v.numpy() for k, v in next(stream).items()}
    want = _jax_tool_first_batch(tool, flags, monkeypatch)
    exact = ["gt_depth"] + (["panos", "rots", "trans"]
                            if tool == "train_depth" else [])
    assert set(want) - {"mono_depth", "mono_feat"} <= set(batch)
    for k in want:
        if k in ("mono_depth", "mono_feat"):
            continue
        assert batch[k].shape == want[k].shape, k
        if k in exact:
            np.testing.assert_array_equal(batch[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(batch[k], want[k], rtol=0, atol=1e-6,
                                       err_msg=k)
    trainer.fit(stream, steps)
    assert trainer.step == 1
    if tool == "train_depth":
        with pytest.raises(SystemExit, match="--views 4"):
            mod.build(mod.parse_args(argv + ["--views", "4"]))


def test_clis_default_to_cuda(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod, argv in ((train_mono, CLI_HW), (train_depth, CLI_HW),
                      (eval_depth, ["--num", "1", *CLI_HW])):
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main(argv)
