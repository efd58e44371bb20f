"""Port parity for the depth-net variants and the renderer's ERP+TP
encoders: the tangent-patch grids and resampling, the ERP+TP / TP / Cube
encoders, the MobileNetV2 encoder, ``CostRegNet``, ``ERPTPDepth``,
UniFuse and EquiDepth on MobileNetV2, ``Equi(with_sin)``, each new knob of
``MVSDepthModel``, ``FNetDepthModel``, ``DepthUncertHead`` with
``uncert_nll_loss``, one Adam step of each new ``train_mono`` /
``train_depth`` recipe, and the renderer with ERP+TP encoders — each
against the JAX package on the same numpy inputs and weights (CPU,
float32).

Weights are random numpy draws on the JAX package's parameter tree (a
shape-only ``init``; BatchNorm means ~N(0, 0.2), variances in [0.5, 1.5])
carried into the port by ``utils/from_jax``; the JAX side runs as one
``jax.jit`` program per case.  Shapes: tangent resampling 32x64 with 3
and 4 patch rows of 16 pixels; mono nets 64x128 with 3 rows of 32-pixel
patches (at 16 pixels the patch encoders' deepest maps are 1x1, where
torch's instance norm refuses a training batch); MVS nets 32x64, 8
hypotheses, 3 MaGNet samples, a 3D UNet of base 8; FNET 32x64 with 16
depths; the renderer 32x64, depth 32x64, 32 + 32 samples, 3 rows of
64-pixel patches (with 32-pixel patches the tangent branch's deepest
instance norms, over 2x2 maps, move single gradients of the training step
past 1e-2).

Tolerances: the grids bit for bit; the resampling and its gradients 1e-5
of their scale; forwards (encoders, ``Equi(with_sin)``, ``CostRegNet``,
FNET, the uncertainty head) and their updated BatchNorm statistics 1e-4
of each quantity's scale and their gradients 1e-3 of each parameter's
largest plus 1e-6 of the tree's largest (parameters whose exact gradient
is 0 carry rounding noise on both sides).  The training steps of the nets
that stack many training-mode BatchNorms (EquiDepth on MobileNetV2, the
MVS knobs, the CLI recipes, which hold ERPTPDepth and UniFuse on
MobileNetV2) run in float64 on both sides: in float32 their
gradients are ill-conditioned (BatchNorms over the deepest maps' few
values; measured on the MobileNetV2 encoder at 32x64, each package's
deepest map 4.4e-3 / 8.6e-3 of its scale off float64, and single
gradients of the ERP+TP and ``with_sin`` MVS nets 1e-3 to 1e-2 apart),
so their outputs, losses, statistics and gradients are held to 1e-6 of
scale, except the MVS and FNET nets, whose sweeps keep float32
coordinates and hypotheses in both packages (4.6e-6 of the loss apart
under float64), held to the float32 limits above; after one clip + Adam
step every parameter element is held to 1e-2 of the learning rate,
except the elements whose two gradients differ by more than 1e-2 of the
element's own (a first Adam step moves an element by ~lr x the sign of
its gradient), which are counted and may be at most 1%.  The renderer's
``prepare_ref`` maps 5e-4 (``test_torch_port_modes.py``'s measure for
random-weight encoders), its frame 1e-4, and its training step 1e-4 with
the gradients 1e-2 of each parameter's largest against the JAX step in
float64 at float32 inputs and draws (``test_torch_port_train.py``'s and
``test_torch_port_mv.py``'s measures).
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import __graft_entry__ as ge
from panogrf_tpu.core import cubemap as jcube
from panogrf_tpu.core import tangent as jtan
from panogrf_tpu.models import fnet as jfnet
from panogrf_tpu.models import mvs as jmvs
from panogrf_tpu.models import uncert as juncert
from panogrf_tpu.models import unifuse as juni
from panogrf_tpu.nn import blocks as jblocks
from panogrf_tpu.nn import erp_tp as jerp
from panogrf_tpu.nn import resnet as jresnet
from panogrf_tpu.renderer import full_render as jfr
from panogrf_tpu.renderer.renderer import NeuralRayGenRenderer as JR
from panogrf_tpu.train import depth_trainer as jdt
from panogrf_tpu.train import losses as jl
from panogrf_tpu.utils import torch_convert as tcv
from panogrf_tpu_torch.core import tangent as ttan
from panogrf_tpu_torch.models import fnet as tfnet
from panogrf_tpu_torch.models import mvs as tmvs
from panogrf_tpu_torch.models import uncert as tuncert
from panogrf_tpu_torch.models import unifuse as tuni
from panogrf_tpu_torch.nn import blocks as tblocks
from panogrf_tpu_torch.nn import erp_tp as terp
from panogrf_tpu_torch.nn import resnet as tresnet
from panogrf_tpu_torch.renderer import full_render as tfr
from panogrf_tpu_torch.renderer.presets import preset_kwargs as tpreset
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer as TR
from panogrf_tpu_torch.tools import train_depth, train_mono
from panogrf_tpu_torch.train import depth_trainer as tdt
from panogrf_tpu_torch.train import trainer as ttr
from panogrf_tpu_torch.utils import from_jax
from torch_port_parity import (f32_uniform, inject_uniform, template_init,
                               to_torch)
from torch_port_threads import one_torch_thread  # noqa: F401

MH, MW = 64, 128
DH, DW = 32, 64
TP_KW = dict(nrows=3, patch_size=32)
MVS_KW = {"num_hypotheses": 8, "magnet_num_samples": 3, "cnn3d_base": 8}
REL = 1e-4
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-6
F64_REL = 1e-6


def f64(tree):
    """float32 numpy leaves -> float64 (for ``jax.enable_x64``)."""
    return jax.tree.map(lambda a: np.asarray(
        a, np.float64 if np.asarray(a).dtype == np.float32 else None), tree)


def double(batch: dict) -> dict:
    return {k: torch.tensor(np.asarray(a)).double() if
            np.asarray(a).dtype.kind == "f" else torch.tensor(np.asarray(a))
            for k, a in batch.items()}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_close(got, want, rel=REL, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


def random_variables(tree: dict, seed: int) -> dict:
    """Random numpy leaves on a (shape-only) JAX variables tree: LeCun
    normal kernels, scales ~1 + N(0, 0.1), biases N(0, 0.05), BatchNorm
    means N(0, 0.2) and variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        if name.endswith("['var']"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name.endswith("['mean']"):
            return (0.2 * rng.normal(size=x.shape)).astype(np.float32)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
        if len(x.shape) <= 1:
            return (0.05 * rng.normal(size=x.shape)).astype(np.float32)
        fan_in = int(np.prod(x.shape[:-1]))
        return (rng.normal(size=x.shape) / np.sqrt(fan_in)).astype(
            np.float32)
    return jax.tree_util.tree_map_with_path(leaf, dict(tree))


def jax_variables(module, seed: int, *args) -> dict:
    return random_variables(template_init(module, jax.random.PRNGKey(0),
                                          *args), seed)


def bn_buffers(model: torch.nn.Module) -> dict:
    return {k: v for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def assert_state_close(model: torch.nn.Module, want: dict, rel=REL,
                       keys=None) -> None:
    """``model``'s state dict against a port-layout state dict ``want``
    (the JAX variables through ``from_jax``), on ``keys`` or all."""
    got = model.state_dict()
    keys = want.keys() if keys is None else keys
    for k in keys:
        if not k.endswith("num_batches_tracked"):
            assert_close(got[k], want[k], rel, k)


def assert_grads_close(model: torch.nn.Module, want: dict,
                       rtol=GRAD_RTOL) -> None:
    """Each parameter's ``.grad`` against the port-layout gradients
    ``want``."""
    grads = {k: (np.zeros(p.shape, np.float32) if p.grad is None
                 else p.grad.numpy()) for k, p in model.named_parameters()}
    floor = GRAD_ATOL_REL * max(float(np.abs(_np(want[k])).max())
                                for k in grads)
    bad = {}
    for k, g in grads.items():
        w = _np(want[k])
        err = float(np.abs(g - w).max())
        if err > rtol * float(np.abs(w).max()) + floor:
            bad[k] = (err, float(np.abs(w).max()))
    assert not bad, bad


# ---------------------------------------------------------------------------
# 1. the tangent-patch grids and resampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nrows", [3, 4])
def test_tangent_grids_equal_jax(nrows):
    """Both grid functions, and so every boundary pixel's owning patch, bit
    for bit."""
    args = (32, 64, nrows, 16, 16, 80.0, 80.0)
    np.testing.assert_array_equal(ttan._e2p_grid(*args),
                                  jtan._e2p_grid(*args))
    for a, b in zip(ttan._p2e_grid(*args), jtan._p2e_grid(*args)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ttan.patch_centers(nrows),
                                  jtan.patch_centers(nrows))
    assert ttan.NPATCHES == jtan.NPATCHES
    assert ttan.PATCH_LAYOUTS == jtan.PATCH_LAYOUTS


@pytest.mark.parametrize("nrows", [3, 4])
def test_tangent_resampling_and_gradients_match_jax(nrows):
    """``equi_to_tangent`` then ``tangent_to_equi`` of a batch of 2, and
    the gradient of a weighted sum of both outputs, against ``jax.grad``
    (1e-5 of scale)."""
    rng = np.random.default_rng(nrows)
    erp = rng.normal(size=(2, 32, 64, 5)).astype(np.float32)
    n = jtan.NPATCHES[nrows]
    wp = rng.normal(size=(2, n, 16, 16, 5)).astype(np.float32)
    we = rng.normal(size=(2, 32, 64, 5)).astype(np.float32)

    def jfn(x):
        p = jax.vmap(lambda e: jtan.equi_to_tangent(e, nrows, (16, 16)))(x)
        back = jax.vmap(lambda q: jtan.tangent_to_equi(q, (32, 64),
                                                       nrows))(p)
        return jnp.sum(p * wp) + jnp.sum(back * we), (p, back)
    (_, (jp, jback)), jgrad = jax.jit(jax.value_and_grad(
        jfn, has_aux=True))(jnp.asarray(erp))
    x = torch.tensor(erp, requires_grad=True)
    p = ttan.equi_to_tangent(x, nrows, (16, 16))
    back = ttan.tangent_to_equi(p, (32, 64), nrows)
    ((p * torch.tensor(wp)).sum() + (back * torch.tensor(we)).sum()) \
        .backward()
    assert_close(p, jp, 1e-5, "patches")
    assert_close(back, jback, 1e-5, "erp")
    assert_close(x.grad, jgrad, 1e-5, "grad")


def test_tangent_to_equi_lower_tap_has_weight_zero():
    """A pixel whose in-patch v is clipped to ph - 1 reads its lower tap
    from the next patch's first row with weight exactly 0: changing that
    row leaves every such pixel unchanged (64x128, 3 rows of 16-pixel
    patches, where 8 pixels reach the edge)."""
    idx, xy = ttan._p2e_grid(64, 128, 3, 16, 16, 80.0, 80.0)
    edge = (xy[..., 1] >= 15.0) & (idx < ttan.NPATCHES[3] - 1)
    assert edge.any()
    rng = np.random.default_rng(3)
    p = torch.tensor(rng.normal(size=(1, 10, 16, 16, 2)).astype(np.float32))
    a = ttan.tangent_to_equi(p, (64, 128), 3)
    q = p.clone()
    q[:, 1:, 0] = 1e30
    b = ttan.tangent_to_equi(q, (64, 128), 3)
    assert torch.isfinite(b[0][torch.tensor(edge)]).all()
    assert torch.equal(a[0][torch.tensor(edge)], b[0][torch.tensor(edge)])


# ---------------------------------------------------------------------------
# 2. encoders and CostRegNet
# ---------------------------------------------------------------------------

class _Holder(torch.nn.Module):
    """A port encoder under the prefix ``unet`` (the MVS feature net's),
    so that ``from_jax``'s MVS layouts load it."""

    def __init__(self, enc):
        super().__init__()
        self.unet = enc


def _encoder_state(kind: str, v: dict) -> dict:
    sd = from_jax._StateDict()
    p, s = v["params"], v.get("batch_stats", {})
    if kind == "ERP+TP":
        sd.erp_tp("unet", p, s, (1, 2, 6))
    elif kind in ("TP", "Cube"):
        sd.single_branch("unet", p)
    else:
        sd.mobilenet("unet", p, s)
    return dict(sd)


ENCODER_CASES = {
    "ERP+TP-eval": ("ERP+TP", False), "ERP+TP-train": ("ERP+TP", True),
    "TP": ("TP", False), "Cube": ("Cube", False),
    "MobileNetV2-eval": ("MobileNetV2", False),
    "MobileNetV2-train": ("MobileNetV2", True)}


@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
def test_encoder_matches_jax(case):
    """The feature maps (all five taps of MobileNetV2) of a batch of 2 at
    32x64; with ``train`` the fusion / encoder BatchNorms normalise with
    batch statistics and their updated running statistics match."""
    kind, train = ENCODER_CASES[case]
    x = np.random.default_rng(1).normal(size=(2, DH, DW, 3)).astype(
        np.float32)
    # 17 training-mode BatchNorms, the last over 4 values: float64
    x64 = kind == "MobileNetV2" and train
    if kind == "MobileNetV2":
        jm, tm = jresnet.MobileNetV2Encoder(), tresnet.MobileNetV2Encoder()
    else:
        kw = TP_KW if kind != "Cube" else {}
        jm, tm = jerp.ENCODERS[kind](32, **kw), terp.ENCODERS[kind](32, **kw)
    v = jax_variables(jm, 2, jnp.asarray(x))
    holder = _Holder(tm)
    holder.load_state_dict(_encoder_state(kind, v), strict=True)
    if x64:
        holder.double()
        x, v = f64(x), f64(v)
    with jax.enable_x64(x64):
        want, new = jax.jit(lambda v, x: jm.apply(
            v, x, train, mutable=["batch_stats"]))(v, x)
    with torch.no_grad():
        if kind == "MobileNetV2":
            got = [f.permute(0, 2, 3, 1) for f in
                   tm.train(train)(torch.tensor(x).permute(0, 3, 1, 2))]
        else:
            got = tm(torch.tensor(x), train)
    rel = F64_REL if x64 else REL
    for i, (a, b) in enumerate(zip(jax.tree.leaves(got),
                                   jax.tree.leaves(want))):
        assert_close(a, b, rel, what=f"out {i}")
    if "batch_stats" in v:
        moved = _encoder_state(kind, {"params": v["params"], **new})
        assert_state_close(holder, moved, rel, keys=bn_buffers(holder))
        assert train or all(
            np.array_equal(_np(a), moved[k])
            for k, a in bn_buffers(holder).items())


@pytest.mark.parametrize("train", [False, True])
def test_cost_reg_net_matches_jax(train):
    """CostRegNet on a (2, 8, 8, 16, 4) cost: output, updated BatchNorm3d
    statistics and every parameter's gradient; the weights' round trip
    through ``torch_convert.convert_cost_reg``."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 8, 8, 16, 4)).astype(np.float32)
    wout = rng.normal(size=(2, 8, 8, 16, 1)).astype(np.float32)
    jm = jblocks.CostRegNet()
    v = jax_variables(jm, 5, jnp.asarray(x))

    def f(params, stats, x):
        out, new = jm.apply({"params": params, "batch_stats": stats}, x,
                            train, mutable=["batch_stats"])
        return jnp.sum(out * wout), (out, new)
    (_, (want, new)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        v["params"], v["batch_stats"], jnp.asarray(x))
    tm = tblocks.CostRegNet(4)
    holder = torch.nn.Module()
    holder.unet3d = tm

    def state(p, s):
        sd = from_jax._StateDict()
        for name in ("conv0", "conv1", "conv2", "conv3", "conv4", "conv5",
                     "conv6", "conv7", "conv9", "conv11"):
            sd.conv(f"unet3d.{name}.conv", p[name]["WrapConv3D_0"]["Conv_0"])
            sd.batch_norm(f"unet3d.{name}.bn", p[name]["BatchNorm_0"],
                          s[name]["BatchNorm_0"])
        sd.conv("unet3d.prob.conv", p["prob"]["Conv_0"])
        return dict(sd)
    holder.load_state_dict(state(v["params"], v["batch_stats"]), strict=True)
    tm.train(train)
    out = tm(torch.tensor(x).permute(0, 4, 1, 2, 3))
    (out * torch.tensor(wout).permute(0, 4, 1, 2, 3)).sum().backward()
    assert_close(out.permute(0, 2, 3, 4, 1), want, what="out")
    assert_state_close(holder, state(v["params"], new["batch_stats"]),
                       keys=bn_buffers(holder))
    assert_grads_close(holder, state(grads, v["batch_stats"]))
    back = tcv.convert_cost_reg({k: a.numpy() for k, a in
                                 holder.state_dict().items()})
    np.testing.assert_array_equal(back[0]["conv5"]["WrapConv3D_0"]["Conv_0"]
                                  ["kernel"], v["params"]["conv5"]
                                  ["WrapConv3D_0"]["Conv_0"]["kernel"])
    for (ka, a), (kb, b) in zip(
            jax.tree_util.tree_leaves_with_path(back[0]),
            jax.tree_util.tree_leaves_with_path(v["params"])):
        assert ka == kb
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# 3. the mono variants and Equi(with_sin)
# ---------------------------------------------------------------------------

# ERPTPDepth and UniFuse on MobileNetV2 are held through their CLI
# recipes' steps (section 6)
MONO_CASES = {
    "Equi-MobileNetV2": (lambda: juni.EquiDepth(num_layers=2),
                         lambda: tuni.EquiDepth(num_layers=2), False)}


def _mono_batch(seed, with_cube):
    rng = np.random.default_rng(seed)
    equi = rng.normal(size=(2, MH, MW, 3)).astype(np.float32)
    batch = {"equi": equi, "gt_depth": rng.uniform(
        0.2, 9.0, size=(2, MH, MW, 1)).astype(np.float32)}
    if with_cube:
        batch["cube"] = np.asarray(jax.vmap(
            lambda e: jcube.equi_to_cube(e, MH // 2))(jnp.asarray(equi)))
    return batch


@pytest.mark.parametrize("case", sorted(MONO_CASES))
def test_mono_variant_training_matches_jax(case):
    """A training-mode forward of the mono recipe's loss (l1_sphere):
    outputs, loss, updated BatchNorm statistics and every parameter's
    gradient; ``select_mono`` builds the same net."""
    jmake, tmake, with_cube = MONO_CASES[case]
    jm, tm = jmake(), tmake().train()
    args = ("equi", "cube") if with_cube else ("equi",)
    batch = _mono_batch(6, with_cube)
    v = jax_variables(jm, 7, *(jnp.asarray(batch[a]) for a in args))
    from_jax.load_jax_params(tm, v).double()
    batch, v = f64(batch), f64(v)

    def f(params, stats, b):
        out, new = jm.apply({"params": params, "batch_stats": stats},
                            *(b[a] for a in args), train=True,
                            mutable=["batch_stats"])
        loss = jdt.depth_loss_fn("l1_sphere", out["pred_depth"],
                                 b["gt_depth"])
        return loss, (out, new)
    with jax.enable_x64(True):
        (jloss, (want, new)), grads = jax.jit(jax.value_and_grad(
            f, has_aux=True))(v["params"], v["batch_stats"], batch)
    tb = double(batch)
    out = tm(*(tb[a] for a in args))
    loss = tdt.depth_loss_fn("l1_sphere", out["pred_depth"], tb["gt_depth"])
    loss.backward()
    assert set(out) == set(want)
    for k in want:
        assert_close(out[k], want[k], F64_REL, what=k)
    assert_close(loss, jloss, F64_REL, what="loss")
    fn = from_jax.equi_depth_state_dict
    assert_state_close(tm, fn({"params": v["params"], **new}), F64_REL,
                       keys=bn_buffers(tm))
    assert_grads_close(tm, fn({"params": grads,
                               "batch_stats": v["batch_stats"]}), F64_REL)
    built = tuni.select_mono({"mono_net": "Equi", "mono_num_layers": 2})
    assert type(built) is type(tm)
    assert {k: a.shape for k, a in built.state_dict().items()} == \
        {k: a.shape for k, a in tm.state_dict().items()}


def test_equi_with_sin_matches_jax():
    """``Equi(with_sin=True)``: the sin(latitude) channel, a 4-channel
    first conv, the features in eval and training mode; the weights'
    round trip through ``torch_convert.convert_equi``."""
    x = np.random.default_rng(8).uniform(size=(2, DH, DW, 3)).astype(
        np.float32)
    jm, tm = juni.Equi(with_sin=True), tuni.Equi(with_sin=True)
    v = jax_variables(jm, 9, jnp.asarray(x))
    holder = _Holder(tm)
    sd = from_jax._StateDict()
    sd.encoder("unet.equi_encoder", v["params"]["equi_encoder"],
               v["batch_stats"]["equi_encoder"])
    for i in range(7):
        sd.conv(f"unet.equi_decoder.{i}.conv.conv",
                v["params"][f"ConvELU_{i}"]["Conv_0"])
    holder.load_state_dict(dict(sd), strict=True)
    assert tm.equi_encoder.conv1.weight.shape[1] == 4
    for train in (False, True):
        want = jax.jit(lambda v, x: jm.apply(v, x, train,
                                             mutable=["batch_stats"])[0])(
            v, x)
        with torch.no_grad():
            assert_close(tm.train(train)(torch.tensor(x)), want,
                         what=f"train={train}")
    np.testing.assert_allclose(
        tuni.sin_channel(1, 8, 2, "cpu")[0, :, 0, 0].numpy(),
        np.sin((np.arange(8) + 0.5) * np.pi / 8), rtol=1e-6)
    back, _ = tcv.convert_equi({k: a.numpy() for k, a in
                                holder.state_dict().items()})
    for (ka, a), (kb, b) in zip(
            jax.tree_util.tree_leaves_with_path(back),
            jax.tree_util.tree_leaves_with_path(v["params"])):
        assert ka == kb
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# 4. the MVS net's knobs
# ---------------------------------------------------------------------------

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
MVS_CASES = {"ERP+TP": dict(feature_net_type="ERP+TP", **TP_KW),
             "TP": dict(feature_net_type="TP", **TP_KW),
             "Cube": dict(feature_net_type="Cube"),
             "with_sin": dict(with_sin=True),
             "new_reg3dnet": dict(use_new_reg3dnet=True)}


@pytest.mark.parametrize("case", sorted(MVS_CASES))
def test_mvs_variant_training_matches_jax(case):
    """The MVS recipe's training loss (l1_sphere + 0.5 x the aux L1, the
    JAX DepthTrainer's own ``loss_fn``) with each new knob: outputs, loss,
    updated BatchNorm statistics (feature net and CostRegNet) and every
    parameter's gradient; ``convert_mvs`` reads the ``with_sin`` net's
    weights back."""
    kw = {**MVS_KW, **MVS_CASES[case]}
    jm, tm = jmvs.MVSDepthModel(**kw), tmvs.MVSDepthModel(**kw).train()
    batch = _mvs_batch(10)
    v = jax_variables(jm, 11, *(jnp.asarray(batch[a]) for a in _MVS_ARGS))
    v.setdefault("batch_stats", {})
    from_jax.load_jax_params(tm, v).double()
    v32, batch, v = v, f64(batch), f64(v)

    def jforward(variables, b, train):
        out, mut = jm.apply(variables, *(b[a] for a in _MVS_ARGS),
                            train=True, mutable=["batch_stats"])
        out = dict(out)
        out["pred_depth"] = out.pop("depth")
        return out, dict(mut)
    with jax.enable_x64(True):
        jtrainer = jdt.DepthTrainer(jforward, v, jdt.DepthTrainConfig())
        (jloss, new), grads = jax.jit(jax.value_and_grad(
            _jax_loss_fn(jtrainer), has_aux=True))(
            v["params"], {"batch_stats": v["batch_stats"]}, batch)

    def tforward(b):
        out = tm(*(b[a] for a in _MVS_ARGS))
        out["pred_depth"] = out.pop("depth")
        return out
    trainer = tdt.DepthTrainer(tm, tforward, tdt.DepthTrainConfig())
    tb = double(batch)
    loss = trainer.loss(tforward(tb), tb)
    loss.backward()
    assert_close(loss, jloss, what="loss")
    assert_state_close(tm, from_jax.mvs_state_dict(
        {"params": v["params"], **new}), keys=bn_buffers(tm))
    assert_grads_close(tm, from_jax.mvs_state_dict(
        {"params": grads, "batch_stats": v["batch_stats"]}))
    if case == "with_sin":
        back = tcv.convert_mvs({k: a.detach().numpy() for k, a in
                                from_jax.mvs_state_dict(v32).items()})
        for (ka, a), (kb, b) in zip(
                jax.tree_util.tree_leaves_with_path(back),
                jax.tree_util.tree_leaves_with_path(v32)):
            assert ka == kb
            np.testing.assert_array_equal(a, b)


def _jax_loss_fn(trainer: "jdt.DepthTrainer"):
    """The JAX ``DepthTrainer``'s own ``loss_fn(params, state, batch) ->
    (loss, new_state)``, taken from the closure of its jitted step."""
    fn = trainer._train_step.__wrapped__
    cells = dict(zip(fn.__code__.co_freevars, fn.__closure__))
    return cells["loss_fn"].cell_contents


# ---------------------------------------------------------------------------
# 5. FNET and the uncertainty head
# ---------------------------------------------------------------------------

def test_fnet_matches_jax():
    """FNetDepthModel at 32x64 with 16 inverse-uniform depths: depth,
    softmax and every parameter's gradient of the sin-weighted L1."""
    b = _mvs_batch(12)
    jm = jfnet.FNetDepthModel(num_depths=16)
    tm = tfnet.FNetDepthModel(num_depths=16)
    args = tuple(jnp.asarray(b[a]) for a in ("panos", "rots", "trans"))
    v = jax_variables(jm, 13, *args)
    from_jax.load_jax_params(tm, v)

    def f(params, *a):
        out = jm.apply({"params": params}, *a)
        return jdt.depth_loss_fn("l1_sphere", out["depth"],
                                 b["gt_depth"]), out
    (jloss, want), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        v["params"], *args)
    out = tm(*(torch.tensor(b[a]) for a in ("panos", "rots", "trans")))
    loss = tdt.depth_loss_fn("l1_sphere", out["depth"],
                             torch.tensor(b["gt_depth"]))
    loss.backward()
    for k in want:
        assert_close(out[k], want[k], what=k)
    assert_close(loss, jloss, what="loss")
    assert_grads_close(tm, from_jax.fnet_state_dict({"params": grads}))


def test_uncert_head_and_nll_match_jax():
    """DepthUncertHead on (2, 8, 16, 8) features and a 32x64 depth: sigma,
    ``uncert_nll_loss`` (the depth detached in the loss's residual, so
    the depth's gradient comes through the head's input alone) and every
    parameter's gradient."""
    rng = np.random.default_rng(14)
    feats = rng.normal(size=(2, 8, 16, 8)).astype(np.float32)
    depth = rng.uniform(0.5, 8.0, size=(2, DH, DW, 1)).astype(np.float32)
    gt = rng.uniform(0.05, 11.0, size=(2, DH, DW, 1)).astype(np.float32)
    jm = juncert.DepthUncertHead()
    v = jax_variables(jm, 15, jnp.asarray(feats), jnp.asarray(depth))

    def f(params, d):
        sigma = jm.apply({"params": params}, feats, d)
        return juncert.uncert_nll_loss(d, sigma, gt, 0.1, 10.0), sigma
    (jloss, want), (grads, dgrad) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(depth))
    tm = from_jax.load_jax_params(tuncert.DepthUncertHead(8), v)
    td = torch.tensor(depth, requires_grad=True)
    sigma = tm(torch.tensor(feats), td)
    loss = tuncert.uncert_nll_loss(td, sigma, torch.tensor(gt), 0.1, 10.0)
    loss.backward()
    assert_close(sigma, want, what="sigma")
    assert_close(loss, jloss, what="loss")
    assert_grads_close(tm, from_jax.uncert_head_state_dict(
        {"params": grads}))
    assert_close(td.grad, dgrad, 1e-3, what="depth grad")


# ---------------------------------------------------------------------------
# 6. one Adam step of each new CLI recipe
# ---------------------------------------------------------------------------

CLI_CASES = {
    "train_mono-ERP+TP": (train_mono, ["--mono-net", "ERP+TP", "--nrows",
                                       "3", "--patch-size", "32"]),
    "train_mono-num_layers_2": (train_mono, ["--num-layers", "2"]),
    "train_depth-new_reg3dnet": (train_depth, ["--new-reg3dnet",
                                               "--hypotheses", "8"]),
    "train_depth-fnet": (train_depth, ["--model", "fnet", "--hypotheses",
                                       "8"])}


def _jax_recipe(case: str, batch: dict):
    """(the JAX module, its forward_fn as the JAX tool builds it, the
    arrays its ``init`` takes, its DepthTrainConfig)."""
    if case.startswith("train_mono"):
        if "ERP" in case:
            jm, names = juni.ERPTPDepth(**TP_KW), ("equi",)
        else:
            jm, names = juni.UniFuse(num_layers=2), ("equi", "cube")

        def forward(v, b, train):
            return jm.apply(v, *(b[a] for a in names), train=True,
                            mutable=["batch_stats"])
        return jm, forward, [batch[a] for a in names], \
            jdt.DepthTrainConfig(aux_d1_weight=0.0)
    if "fnet" in case:
        jm = jfnet.FNetDepthModel(min_depth=0.1, num_depths=8)
        names = ("panos", "rots", "trans")

        def forward(v, b, train):
            out = jm.apply(v, *(b[a][:, :2] for a in names))
            return {"pred_depth": out["depth"]}, {}
        return jm, forward, [batch[a][:, :2] for a in names], \
            jdt.DepthTrainConfig()
    jm = jmvs.MVSDepthModel(num_hypotheses=8, use_new_reg3dnet=True)

    def forward(v, b, train):
        out, mut = jm.apply(v, *(b[a] for a in _MVS_ARGS), train=True,
                            mutable=["batch_stats"])
        out = dict(out)
        out["pred_depth"] = out.pop("depth")
        return out, dict(mut)
    return jm, forward, [batch[a] for a in _MVS_ARGS], jdt.DepthTrainConfig()


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_recipe_step_matches_jax(case, tmp_path, monkeypatch):
    """The CLI's trainer (``build`` at 64x128, batch 2) on its first
    batch, with JAX-drawn weights, against the JAX DepthTrainer's jitted
    step (clip + Adam) on the same batch and weights, both in float64: the
    loss, each clipped gradient, the updated BatchNorm statistics and every
    parameter after the step.  The depth recipes' sweeps keep float32
    coordinates and hypotheses (4.6e-6 of the loss apart under float64),
    so they are held to the float32 limits."""
    monkeypatch.chdir(tmp_path)
    tool, argv = CLI_CASES[case]
    rel, grad_rtol = ((F64_REL, F64_REL) if tool is train_mono
                      else (REL, GRAD_RTOL))
    trainer, stream, _ = tool.build(tool.parse_args(
        [*argv, "--height", str(MH), "--width", str(MW), "--device", "cpu",
         "--vis-interval", "0"]))
    batch = {k: v.numpy().copy() for k, v in next(stream).items()}
    jm, jforward, init_args, jcfg = _jax_recipe(case, batch)
    v = jax_variables(jm, 16, *map(jnp.asarray, init_args))
    tm = from_jax.load_jax_params(trainer.model, v).double()
    # the optimiser holds the parameters themselves, now float64
    trainer.opt = type(trainer.opt)(tm.parameters(), **trainer.opt.defaults)
    to_port = (from_jax.unifuse_state_dict if tool is train_mono
               else from_jax.fnet_state_dict if "fnet" in case
               else from_jax.mvs_state_dict)
    batch, v = f64(batch), f64(v)
    state = {k: a for k, a in v.items() if k != "params"}
    with jax.enable_x64(True):
        jtrainer = jdt.DepthTrainer(jforward, v, jcfg)
        loss_fn = _jax_loss_fn(jtrainer)

        @jax.jit
        def jstep(params, state, b):
            (loss, new), g = jax.value_and_grad(loss_fn, has_aux=True)(
                params, state, b)
            upd, _ = jtrainer.tx.update(g, jtrainer.tx.init(params), params)
            return loss, new, optax.clip(1.0).update(g, None)[0], \
                optax.apply_updates(params, upd)
        jloss, new, jgrads, jparams = jstep(v["params"], state, batch)
    tloss = trainer.train_step(double(batch))
    assert_close(tloss, jloss, rel, what="loss")
    stats = v.get("batch_stats", {})
    jgrads_port = to_port({"params": jgrads, "batch_stats": stats})
    assert_grads_close(tm, jgrads_port, grad_rtol)
    after = to_port({"params": jparams, **(new or {"batch_stats": stats})})
    assert_state_close(tm, after, rel, keys=bn_buffers(tm))
    # a first Adam step moves an element by lr * g / (|g| + eps), ~lr x
    # the sign of its gradient, so an update is determined to 1e-2 lr
    # where the two gradients agree to 1e-2 of the element's own; the
    # others (near-zero gradients within the tolerance above, such as
    # FNET's final bias, whose exact gradient is 0: it shifts both views'
    # features alike) are counted
    lr = trainer.cfg.learning_rate
    unsure = total = 0
    for k, p in tm.named_parameters():
        g, gp = _np(jgrads_port[k]), p.grad.numpy()
        sure = np.abs(gp - g) <= 1e-2 * np.abs(g)
        np.testing.assert_allclose(p.detach().numpy()[sure],
                                   _np(after[k])[sure], rtol=0,
                                   atol=1e-2 * lr, err_msg=k)
        unsure += int((~sure).sum())
        total += g.size
    print(f"{case}: {unsure} of {total} elements' updates undetermined")
    assert unsure <= 0.01 * total


# ---------------------------------------------------------------------------
# 7. the renderer with ERP+TP encoders
# ---------------------------------------------------------------------------

RH, RW, RDN, RRN = 32, 64, 32, 16
RENDER_KW = dict(height=RH, width=RW, depth_hw=(DH, DW), depth_sample_num=RDN,
                 fine_depth_sample_num=RDN, local_feature_type="ERP+TP",
                 init_net_feature_type="ERP+TP", nrows=3, patch_size=64)
PREP_TOL = dict(atol=5e-4, rtol=5e-4)


@pytest.fixture(scope="module")
def erp_tp_renderer():
    """Training data and random weights on the JAX ERP+TP renderer's tree
    (with its fusion BatchNorms' statistics); a positive density bias
    gives every pass density."""
    data = ge._tiny_data(RH, RW, DH, DW, rn=RRN)
    rng = np.random.default_rng(17)
    data["ref_imgs_info"]["true_depth"] = jnp.asarray(
        rng.uniform(1, 6, (2, RH, RW, 1)), jnp.float32)
    jm = JR(gather_depth_major=True, **RENDER_KW)
    v = random_variables(template_init(jm, jax.random.PRNGKey(0), data), 18)
    for n in ("agg_net", "fine_agg_net"):
        v["params"][n]["agg_impl"]["out_geometry_fc"]["b1"] = np.full(
            (1,), 0.5, np.float32)
    assert "CEELayer_0" in v["batch_stats"]["image_encoder"]
    assert "CEELayer_2" in v["batch_stats"]["init_net"]["res_net"]
    return jm, jax.tree.map(np.array, data), v


def test_erp_tp_renderer_prepare_ref_and_frame_match_jax(erp_tp_renderer):
    """``prepare_ref`` under the serving flags in float32 (both encoders
    ERP+TP) within 5e-4, then a 32x64 frame from JAX's maps within 1e-4
    off the seam pixels; the weights' round trip through ``from_jax``."""
    _, data, v = erp_tp_renderer
    kw = dict(RENDER_KW, **tpreset("serving", compute_dtype="float32"))
    jm = JR(**kw)
    ref = data["ref_imgs_info"]
    jref = jfr.prepare_ref_data(jm, v, ref)
    tm = from_jax.load_jax_params(TR(**kw, device="cpu"), v)
    tref = tfr.prepare_ref_data(tm, ref, device="cpu")
    assert tref.keys() == jref.keys()
    for k, a in tref.items():
        np.testing.assert_allclose(_np(a), np.asarray(jref[k], np.float32),
                                   **PREP_TOL, err_msg=k)
    tref = {k: torch.tensor(np.array(a)) for k, a in jref.items()}
    c2w, qdr = data["que_imgs_info"]["c2w"], np.asarray([[0.5, 15.0]])
    want = jfr.render_image_device(jm, v, jref, c2w, qdr, ref["depth_range"],
                                   chunk=512, coarse_lowres=2)
    got = tfr.render_image_device(tm, tref, c2w, qdr, ref["depth_range"],
                                  chunk=512, coarse_lowres=2, device="cpu")
    ok = np.ones((RH, RW), bool)
    ok[[0, RH - 1]] = False
    ok[:, [0, RW - 1, RW // 2 - 1, RW // 2, RW // 2 + 1]] = False
    np.testing.assert_allclose(_np(got)[ok], np.asarray(want)[ok],
                               atol=1e-4, rtol=1e-4)
    sd = from_jax.renderer_state_dict(v)
    for k, a in tm.state_dict().items():
        if k in sd and not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(_np(a), _np(sd[k]), err_msg=k)
    assert set(sd) == set(tm.state_dict()) - {"directions"}


def test_erp_tp_renderer_training_step_matches_jax(monkeypatch,
                                                   erp_tp_renderer):
    """One training step (render + depth loss, JAX's sampling draws): the
    forward, the loss terms and every parameter's gradient against
    ``jax.grad``.  The JAX renderer calls its encoders without ``train``,
    so their fusion BatchNorms normalise with the running statistics even
    in training; the port's do too: the outputs agree and the statistics
    have not moved after the step."""
    jm, data, v = erp_tp_renderer
    key = jax.random.PRNGKey(1)
    data64, v64 = f64(data), f64(v)

    def loss_fn(params):
        out = jm.apply({"params": params, "batch_stats": v64["batch_stats"]},
                       data64, rng=key)
        terms = {**jl.render_loss(out, data64),
                 **jl.depth_loss(out, data64)}
        return jl.total_loss(terms), (out, terms)
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        f32_uniform(mp)
        (jloss, (want, jterms)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(v64["params"])
        r_coarse, r_fine = jax.random.split(key)
        draws = [np.asarray(jax.random.uniform(r_coarse, (1, RRN, RDN - 2)),
                            np.float32),
                 np.asarray(jax.random.uniform(r_fine, (1, RRN, RDN)),
                            np.float32)]
    queue = inject_uniform(monkeypatch, draws)
    tm = from_jax.load_jax_params(TR(gather_depth_major=True, **RENDER_KW,
                                     device="cpu"), v).train()
    stats0 = {k: a.clone() for k, a in bn_buffers(tm).items()}
    assert stats0
    tdata = to_torch(data)
    loss, terms = ttr.make_loss_fn(ttr.TrainerConfig(
        losses=("render", "depth")))(out := tm(tdata, torch.Generator()),
                                     tdata)
    loss.backward()
    assert not queue
    assert set(out) == set(want)
    for k in want:
        np.testing.assert_allclose(_np(out[k]), np.asarray(want[k],
                                                           np.float32),
                                   atol=1e-4, rtol=1e-4, err_msg=k)
    for k, a in jterms.items():
        np.testing.assert_allclose(_np(terms[k]), np.asarray(a), atol=1e-4,
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k, a in bn_buffers(tm).items():
        assert torch.equal(a, stats0[k]), k
    want_g = from_jax.renderer_state_dict({"params": grads,
                                           "batch_stats": v["batch_stats"]})
    floor = GRAD_ATOL_REL * max(float(np.abs(_np(want_g[k])).max())
                                for k, _ in tm.named_parameters())
    for k, p in tm.named_parameters():
        w = _np(want_g[k])
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-2 * np.abs(w).max() + floor,
                                   err_msg=k)
