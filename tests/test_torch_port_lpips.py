"""Port parity of LPIPS (``panogrf_tpu_torch/train/lpips.py``) against the
JAX module, on a random initialisation (no released weights are in the
repository) loaded both ways: the ``.npz`` that the JAX package's
``save_lpips_weights`` writes, and torchvision / lpips state dicts, which
the JAX package converts (``convert_torch_lpips``) and the port loads as
they are.  Tolerance 1e-5 of the distance; and the render CLI's
``--lpips-weights``.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from panogrf_tpu.train import lpips as JL
from panogrf_tpu_torch.tools import render as trender
from panogrf_tpu_torch.train import lpips as TL
from torch_port_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5


def _images(seed, n=2, h=48, w=80):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(n, h, w, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    return a, b


@jax.jit
def _jax_lpips(variables, gt, pred):
    """``JL.lpips_fn``'s scorer with the weights as an argument: one
    compilation for every weight set at one image shape."""
    return JL.LPIPS().apply(variables, gt * 2.0 - 1.0, pred * 2.0 - 1.0)


def _jax_scores(variables, a, b):
    return np.asarray(_jax_lpips(variables, jnp.asarray(a), jnp.asarray(b)))


def _port_scores(model, a, b):
    return TL.lpips_fn(model)(torch.tensor(a), torch.tensor(b)).numpy()


@pytest.fixture(scope="module")
def jax_variables():
    """Seeded values in the shapes of ``JL.LPIPS().init`` (an eager init
    of the VGG takes seconds on the CPU): LeCun-normal kernels, small
    biases, lin weights apart from their init of ones and non-negative as
    trained."""
    x = jnp.zeros((1, 32, 32, 3))
    shapes = jax.eval_shape(JL.LPIPS().init, jax.random.PRNGKey(0), x, x)
    rng = np.random.default_rng(1)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "lin" in name:
            v = rng.uniform(0.2, 2.0, size=s.shape)
        elif len(s.shape) >= 2:
            v = rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        else:
            v = 0.05 * rng.normal(size=s.shape)
        return jnp.asarray(v, jnp.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_lpips_from_jax_npz_matches_jax(jax_variables, tmp_path):
    JL.save_lpips_weights(jax_variables, tmp_path / "w.npz")
    model = TL.load_lpips_weights(tmp_path / "w.npz", device="cpu")
    a, b = _images(2)
    want = _jax_scores(jax_variables, a, b)
    got = _port_scores(model, a, b)
    assert got.shape == (2,) and (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # the port's file reads back into the JAX package, and into the port
    TL.save_lpips_weights(model, tmp_path / "port.npz")
    np.testing.assert_allclose(
        _jax_scores(JL.load_lpips_weights(tmp_path / "port.npz"), a, b),
        want, rtol=RTOL)
    again = TL.load_lpips_weights(tmp_path / "port.npz", device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def _torch_state(seed):
    """A torchvision ``vgg16`` state dict (``features.N.*`` and the
    classifier) and lpips' lin weights, seeded."""
    rng = np.random.default_rng(seed)
    vgg, cin = {}, 3
    for idx, cout in zip(TL._conv_indices(),
                         [c for c in TL._VGG16 if c != "M"]):
        vgg[f"features.{idx}.weight"] = torch.tensor(
            rng.normal(size=(cout, cin, 3, 3)) / np.sqrt(9 * cin),
            dtype=torch.float32)
        vgg[f"features.{idx}.bias"] = torch.tensor(
            0.05 * rng.normal(size=cout), dtype=torch.float32)
        cin = cout
    vgg["classifier.0.weight"] = torch.zeros(4, 8)
    lin = {f"lin{i}.model.1.weight": torch.tensor(
        rng.uniform(0.2, 2.0, size=(1, c, 1, 1)), dtype=torch.float32)
        for i, c in enumerate(TL.TAP_CHANNELS)}
    return vgg, lin


def test_lpips_from_torch_layout_matches_jax(tmp_path):
    """torchvision's and lpips' files load into the port without
    conversion (and as a directory of ``vgg16.pth`` + ``lpips_vgg.pth``);
    lpips' full-model ``net.sliceK.N`` keys too."""
    vgg, lin = _torch_state(3)
    variables = JL.convert_torch_lpips(
        {k: v.numpy() for k, v in vgg.items()},
        {k: v.numpy() for k, v in lin.items()})
    a, b = _images(4)
    want = _jax_scores(variables, a, b)
    model = TL.load_torch_state(TL.LPIPS(), vgg, lin)
    np.testing.assert_allclose(_port_scores(model, a, b), want, rtol=RTOL)
    # the released files' own keys, unchanged
    assert {k for k in model.state_dict() if k.startswith("lin")} == set(lin)
    assert {k for k in vgg if k.startswith("features.")} <= \
        set(model.state_dict())
    torch.save(vgg, tmp_path / "vgg16.pth")
    torch.save(lin, tmp_path / "lpips_vgg.pth")
    np.testing.assert_allclose(_port_scores(
        TL.load_lpips_weights(tmp_path, device="cpu"), a, b), want,
        rtol=RTOL)
    sliced = {"net.slice1." + k[len("features."):]: v
              for k, v in vgg.items() if k.startswith("features.")}
    np.testing.assert_allclose(_port_scores(
        TL.load_torch_state(TL.LPIPS(), sliced, lin), a, b), want,
        rtol=RTOL)
    with pytest.raises(ValueError, match="expected an .npz"):
        TL.load_lpips_weights(tmp_path / "vgg16.pth", device="cpu")


def test_lpips_identical_images_score_zero():
    model = TL.LPIPS(torch.Generator().manual_seed(2))
    a, _ = _images(5)
    s = _port_scores(model, a * 0.5 + 0.25, a * 0.5 + 0.25)
    np.testing.assert_allclose(s, 0.0, atol=1e-6)
    assert _port_scores(model, a, 1 - a).min() > 0


def test_lpips_needs_a_card_unless_asked(jax_variables, tmp_path,
                                         monkeypatch):
    JL.save_lpips_weights(jax_variables, tmp_path / "w.npz")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TL.load_lpips_weights(tmp_path / "w.npz")


def test_render_cli_scores_lpips(jax_variables, tmp_path):
    """Each eval frame gets its LPIPS beside PSNR; without the flag none."""
    JL.save_lpips_weights(jax_variables, tmp_path / "w.npz")
    small = ["--height", "16", "--width", "32", "--depth-height", "16",
             "--depth-width", "32", "--num", "1", "--device", "cpu",
             "--no-skip"]
    got = trender.main(small + ["--out", str(tmp_path / "a"),
                                "--lpips-weights", str(tmp_path / "w.npz")])
    frame = got["frames"][0]
    assert np.isfinite(frame["lpips"]) and frame["lpips"] > 0
    mean = json.loads((tmp_path / "a" / "metric.txt").read_text())
    assert mean["lpips"] == pytest.approx(frame["lpips"])
    plain = trender.main(small + ["--out", str(tmp_path / "b")])
    assert "lpips" not in plain["frames"][0]
    assert plain["frames"][0]["psnr_nr"] == pytest.approx(frame["psnr_nr"])
