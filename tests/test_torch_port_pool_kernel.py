"""The cross-view pool kernel (``ops/kernels/cross_view_pool.py``,
``csrc/cross_view_pool.cu``) and its dispatch in
``agg_net.IBRNetWithNeuRay``.

On the CPU: the packed weights' layout against ``_linears``, the padded
layout itself (the kernel's K orders, run as plain products) against
``pool_reference``, the packing cache, the dispatch's plain cases and the
wrapper's checks.  Tests marked ``card`` hold the kernel against
``pool_reference`` on a CUDA card and skip without one; this file imports
no JAX, so on a machine with a card (and no JAX) they run with
``python -m pytest tests/test_torch_port_pool_kernel.py --noconftest``.
"""

import pytest
import torch
import torch.nn.functional as F

from panogrf_tpu_torch.ops.kernels import _build
from panogrf_tpu_torch.ops.kernels import cross_view_pool as cvp
from panogrf_tpu_torch.ops.kernels import fused_mlp
from panogrf_tpu_torch.renderer.agg_net import (_POOL_DIMS, IBRNetWithNeuRay,
                                                _linears, pool_reference)
from torch_port_threads import one_torch_thread  # noqa: F401

BF16 = torch.bfloat16
DIMS = {name: d(35, 32) for name, d in _POOL_DIMS.items()}


def _net(seed=0, **kw):
    torch.manual_seed(seed)
    return IBRNetWithNeuRay(**kw)


def _params(net, dtype=BF16):
    return {name: _linears(getattr(net, name), dtype) for name in _POOL_DIMS}


def _inputs(n, v, dtype=BF16, seed=0, device="cpu", f=35, nd=32):
    """Seeded pool inputs with some masked views: point 0 has every view
    masked, point 1 its first."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=device) * scale) \
            .to(dtype)
    mask = (torch.rand(n, v, 1, generator=g, device=device) > 0.2).to(dtype)
    mask[0] = 0
    if n > 1:
        mask[1, 0] = 0
    return (randn(n, v, f, scale=0.5), randn(n, v, nd), randn(n, v, 4,
                                                               scale=0.3),
            mask)


# ---------------------------------------------------------------------------
# the packed layout (CPU)
# ---------------------------------------------------------------------------


def _padded_layers(packed):
    """[(name, index, W padded (K, N), b padded (N,)), ...] read back from
    the buffer: the fragment order undone (k step s, n tile nt, lane g * 4
    + t, then W[16s + 2t + {0, 1, 8, 9}, 8 nt + g])."""
    out, at = [], 0
    for name, i, kp, np_, _ in cvp.LAYERS:
        frags = packed[at:at + kp * np_].reshape(kp // 16, np_ // 8, 8, 4,
                                                 2, 2)
        wp = frags.permute(0, 4, 3, 5, 1, 2).reshape(kp, np_)
        at += kp * np_
        out.append((name, i, wp, packed[at:at + np_]))
        at += np_
    assert at == packed.numel()
    return out


def _unpack(packed):
    """Stack name -> [(W (in, out), b (out,)), ...] read back from the
    buffer through each layer's K rows."""
    params = {name: [None] * (len(d) - 1) for name, d in DIMS.items()}
    for (name, i, wp, bp), (_, _, kp, _, k_rows) in zip(
            _padded_layers(packed), cvp.LAYERS):
        k_in, n_out = DIMS[name][i], DIMS[name][i + 1]
        w = torch.empty(k_in, n_out, dtype=wp.dtype)
        for p, r in enumerate(cvp._rows(k_rows, k_in, kp)):
            if r >= 0:
                w[r] = wp[p, :n_out]
        params[name][i] = (w, bp[:n_out])
    return params


@pytest.mark.parametrize("stack", list(_POOL_DIMS))
def test_packing_round_trips_to_linears(stack):
    """Every layer of ``stack`` comes back from the buffer as ``_linears``'
    bfloat16 (W, b), bit for bit, and every padded row, column and bias of
    the buffer is zero."""
    net = _net(3)
    packed = cvp.pack_pool_weights(_params(net, torch.float32))
    assert packed.shape == (cvp.PACKED_SIZE,) and packed.dtype == BF16
    back = _unpack(packed)
    for (w, b), (w2, b2) in zip(_params(net)[stack], back[stack]):
        assert torch.equal(w, w2) and torch.equal(b, b2)
    for (name, i, wp, bp), (_, _, kp, _, rows) in zip(
            _padded_layers(packed), cvp.LAYERS):
        if name != stack:
            continue
        n_in, n_out = DIMS[name][i], DIMS[name][i + 1]
        rows = cvp._rows(rows, n_in, kp)
        assert sorted(r for r in rows if r >= 0) == list(range(n_in))
        dead = torch.tensor([r < 0 for r in rows])
        assert not wp[dead].any() and not wp[:, n_out:].any()
        assert not bp[n_out:].any()


def _emulate(rgb, nr, rd, mask, packed, geometry_only=False):
    """The pool as the kernel lays it out: each layer one product of its
    padded (K, N) weight with its input in the kernel's K order, in
    float64."""
    lay = {(name, i): (wp.double(), bp.double())
           for name, i, wp, bp in _padded_layers(packed)}
    rgb, nr, rd, mask = (t.double() for t in (rgb, nr, rd, mask))
    n, v, _ = rgb.shape

    def lin(x, name, i):
        w, b = lay[(name, i)]
        return F.pad(x, (0, w.shape[0] - x.shape[-1])) @ w + b

    def mean_var(x, wt):
        m = (x * wt).sum(1, keepdim=True)
        return m, (wt * (x - m) ** 2).sum(1, keepdim=True)
    elu = F.elu
    weight = mask / (mask.sum(1, keepdim=True) + 1e-8)
    rgbf = elu(lin(elu(lin(rd, "ray_dir_fc", 0)), "ray_dir_fc", 1)) \
        + F.pad(rgb, (0, 5))
    w0 = torch.sigmoid(lin(elu(lin(nr, "neuray_fc", 0)), "neuray_fc", 1)
                       [..., :1]) * weight
    gf = torch.cat([*mean_var(rgbf, w0), *mean_var(rgbf, weight)], -1)
    a = torch.cat([nr, rgbf, torch.zeros(n, v, 8, dtype=rgb.dtype),
                   gf.expand(n, v, 160)], -1)
    x = elu(lin(elu(lin(a, "base_fc", 0)), "base_fc", 1))
    hv = elu(lin(elu(lin(x * weight, "vis_fc", 0)), "vis_fc", 1))
    x = x + hv[..., :32]
    vis = torch.sigmoid(hv[..., 32:33]) * mask
    vis = torch.sigmoid(lin(elu(lin(x * vis, "vis_fc2", 0)), "vis_fc2", 1)
                        [..., :1]) * mask
    wgt = vis / (vis.sum(1, keepdim=True) + 1e-8)
    m, var = mean_var(x, wgt)
    geo = elu(lin(elu(lin(torch.cat([m[:, 0], var[:, 0], wgt.mean(1)], -1),
                          "geometry_fc", 0)), "geometry_fc", 1))
    nvalid = mask.sum(1)
    if geometry_only:
        return geo, torch.zeros(n, 3, dtype=geo.dtype), nvalid
    r_in = torch.cat([x, F.pad(rd, (0, 4)), vis], -1)
    logit = lin(elu(lin(elu(lin(r_in, "rgb_fc", 0)), "rgb_fc", 1)),
                "rgb_fc", 2)[..., :1]
    logit = torch.where(mask == 0, torch.full_like(logit, -1e9), logit)
    return geo, (rgb[..., :3] * torch.softmax(logit, 1)).sum(1), nvalid


@pytest.mark.parametrize("v", [2, 3, 4])
@pytest.mark.parametrize("geometry_only", [False, True])
def test_padded_layout_computes_pool_reference(v, geometry_only):
    """The kernel's K orders (``LAYERS``: base_fc's neuray-first rows and
    padded pooled segments, rgb_fc's ray_diff and vis tiles), run as plain
    float64 products over the padded weights, give ``pool_reference`` on
    the same bfloat16 weights in float64."""
    packed = cvp.pack_pool_weights(_params(_net(5), torch.float32))
    params = {k: [(w.double(), b.double()) for w, b in ls]
              for k, ls in _unpack(packed).items()}
    ins = _inputs(97, v, torch.float64, seed=v)
    got = _emulate(*ins, packed, geometry_only)
    want = pool_reference(*ins, params, geometry_only)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12)


# ---------------------------------------------------------------------------
# the cache of packed weights (CPU)
# ---------------------------------------------------------------------------


def test_packed_weights_are_kept_while_the_parameters_stand():
    net, like = _net(1), torch.zeros(1, dtype=BF16)
    a = net.packed_pool_weights(like)
    assert net.packed_pool_weights(like) is a
    assert torch.equal(a, cvp.pack_pool_weights(_params(net, torch.float32)))


def test_packed_weights_repack_after_load_state_dict():
    net, like = _net(1), torch.zeros(1, dtype=BF16)
    a = net.packed_pool_weights(like)
    other = _net(2)
    net.load_state_dict(other.state_dict())
    b = net.packed_pool_weights(like)
    assert b is not a and not torch.equal(a, b)
    assert torch.equal(b, cvp.pack_pool_weights(_params(other,
                                                        torch.float32)))


def test_packed_weights_repack_after_an_in_place_update():
    net, like = _net(1), torch.zeros(1, dtype=BF16)
    a = net.packed_pool_weights(like)
    with torch.no_grad():
        net.rgb_fc[-1].bias.add_(0.5)
    b = net.packed_pool_weights(like)
    assert b is not a and not torch.equal(a, b)
    assert torch.equal(b, cvp.pack_pool_weights(_params(net, torch.float32)))


def test_packed_weights_of_a_net_made_in_inference_mode():
    """Parameters made under ``torch.inference_mode`` keep no version
    counter: the weights still pack and stay cached, and
    ``load_state_dict`` there packs them again."""
    like = torch.zeros(1, dtype=BF16)
    with torch.inference_mode():
        net = _net(1)
        a = net.packed_pool_weights(like)
        assert net.packed_pool_weights(like) is a
        other = _net(2)
        net.load_state_dict(other.state_dict())
        b = net.packed_pool_weights(like)
    assert b is not a
    assert torch.equal(b, cvp.pack_pool_weights(_params(other,
                                                        torch.float32)))


# ---------------------------------------------------------------------------
# the dispatch (CPU)
# ---------------------------------------------------------------------------


class _LooksCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to drive the dispatch's
    CUDA branch on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


# case -> (module keywords, views, dtype, grad enabled)
PLAIN_CASES = {"float32": ({}, 2, torch.float32, False),
               "grad_enabled": ({}, 2, BF16, True),
               "one_view": ({}, 1, BF16, False),
               "five_views": ({}, 5, BF16, False),
               "other_widths": ({"in_feat_ch": 16, "neuray_in_dim": 16}, 2,
                                BF16, False)}


def _forward_inputs(kw, v, dtype, nr=3, dn=5):
    ins = _inputs(nr * dn, v, dtype, f=kw.get("in_feat_ch", 32) + 3,
                  nd=kw.get("neuray_in_dim", 32))
    return [t.reshape(nr, dn, v, t.shape[-1]) for t in ins]


@pytest.mark.parametrize("case", ["cpu", *PLAIN_CASES])
def test_dispatch_takes_the_plain_path(case):
    """CPU tensors, float32, gradient-carrying calls, 1 or 5 views and
    other widths run ``pool_reference`` and count ``pool_plain``; on a
    CUDA tensor each of the latter cases is refused by the dispatch for
    its own reason (the bfloat16 2-view call beside them is taken)."""
    kw, v, dtype, grad = PLAIN_CASES.get(case, ({}, 2, BF16, False))
    net = _net(4, **kw)
    ins = _forward_inputs(kw, v, dtype)
    fused_mlp.reset_launches()
    with torch.set_grad_enabled(grad):
        out = net(*ins)
    assert fused_mlp.VARIANT_LAUNCHES["pool_plain"] == 1
    assert fused_mlp.VARIANT_LAUNCHES["pool_fused"] == 0
    assert out.shape == (3, 5, 4) and bool(torch.isfinite(out).all())
    fused_mlp.reset_launches()
    assert fused_mlp.VARIANT_LAUNCHES["pool_plain"] == 0

    def flat_cuda(ts):
        return [torch.Tensor._make_subclass(
            _LooksCuda, t.reshape(-1, t.shape[-2], t.shape[-1]))
            for t in ts]
    if case != "cpu":
        with torch.set_grad_enabled(grad):
            assert net._kernel_inputs(flat_cuda(ins)) is None
    with torch.no_grad():
        control = _forward_inputs({}, 2, BF16)
        assert _net(4)._kernel_inputs(flat_cuda(control)) is not None
        assert _net(4)._kernel_inputs(
            [t.reshape(-1, 2, t.shape[-1]) for t in control]) is None


def _misaligned(t):
    """``t``'s values in a contiguous view 2 bytes past a 64-byte aligned
    start."""
    buf = torch.empty(t.numel() + 64, dtype=t.dtype)
    skip = (-buf.data_ptr() % 64) // buf.element_size()
    out = buf[skip + 1:skip + 1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == 2
    return out


def _strided(t):
    """``t``'s values in a non-contiguous view (its channels a slice of
    wider rows), which stays non-contiguous through the forward's
    flattening of (rays, samples)."""
    wide = torch.zeros(*t.shape[:-1], t.shape[-1] + 5, dtype=t.dtype)
    out = wide[..., :t.shape[-1]]
    out.copy_(t)
    assert not out.reshape(-1, *t.shape[-2:]).is_contiguous()
    return out


LAYOUTS = {"as_made": lambda t: t, "misaligned": _misaligned,
           "non_contiguous": _strided}


def _reaches_the_kernel(layout, monkeypatch):
    from panogrf_tpu_torch.renderer import agg_net

    class _Loaded(Exception):
        pass

    def loader():
        raise _Loaded

    def plain(*a, **k):
        raise AssertionError("pool_reference ran for a CUDA bf16 call")
    monkeypatch.setattr(_build, "load_library", loader)
    monkeypatch.setattr(agg_net, "pool_reference", plain)
    net = _net(4)
    packed = net.packed_pool_weights(torch.zeros(1, dtype=BF16))
    packed = torch.Tensor._make_subclass(_LooksCuda, packed)
    monkeypatch.setattr(net, "packed_pool_weights", lambda like: packed)
    ins = [torch.Tensor._make_subclass(_LooksCuda, LAYOUTS[layout](t))
           for t in _forward_inputs({}, 2, BF16)]
    if layout == "misaligned":
        assert all(t.data_ptr() % 16 == 2 for t in ins)
    with torch.inference_mode(), pytest.raises(_Loaded):
        net(*ins)


def test_cuda_bf16_call_reaches_the_kernel_not_the_plain_version(
        monkeypatch):
    """A bfloat16 CUDA call at the standard widths goes to the kernel's
    loader and never to ``pool_reference``."""
    _reaches_the_kernel("as_made", monkeypatch)


@pytest.mark.parametrize("layout", ["misaligned", "non_contiguous"])
def test_any_layout_of_a_cuda_bf16_call_reaches_the_kernel(layout,
                                                           monkeypatch):
    """A misaligned or non-contiguous input does not send the call to
    ``pool_reference``: it is copied for the kernel (the wrapper, which
    refuses both, is passed before the loader)."""
    _reaches_the_kernel(layout, monkeypatch)


# ---------------------------------------------------------------------------
# the wrapper's checks (CPU)
# ---------------------------------------------------------------------------


def _bad(case):
    rgb, nr, rd, mask = _inputs(64, 2)
    packed = cvp.pack_pool_weights(_params(_net(0), torch.float32))
    if case == "non_contiguous":
        rgb = torch.empty(35, 64, 2, dtype=BF16).permute(1, 2, 0)
        rgb.copy_(_inputs(64, 2)[0])
    elif case == "channels":
        rgb = rgb[..., :34].contiguous()
    elif case == "views":
        rgb, nr, rd, mask = _inputs(64, 5)
    elif case == "mismatched_points":
        nr = nr[:63].contiguous()
    elif case == "two_dims":
        mask = mask[..., 0]
    elif case == "packed_size":
        packed = packed[:-8].contiguous()
    elif case == "float32":
        rgb = rgb.float()
    elif case == "misaligned":
        rgb = _misaligned(rgb)
    return rgb, nr, rd, mask, packed


WRAPPER_CASES = {"non_contiguous": (ValueError, "contiguous"),
                 "misaligned": (ValueError, "aligned"),
                 "channels": (ValueError, "takes"),
                 "views": (ValueError, "takes"),
                 "mismatched_points": (ValueError, "takes"),
                 "two_dims": (ValueError, "(N, V, C)"),
                 "packed_size": (ValueError, "packed"),
                 "float32": (TypeError, "bfloat16"),
                 "cpu_device": (ValueError, "CUDA")}


@pytest.mark.parametrize("case", list(WRAPPER_CASES))
def test_wrapper_raises_on_what_the_kernel_does_not_take(case, monkeypatch):
    """Handed directly a non-contiguous, misaligned, misshaped, mistyped
    or CPU input, ``cross_view_pool`` raises before it loads the
    library."""
    def loader():
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(_build, "load_library", loader)
    exc, match = WRAPPER_CASES[case]
    with pytest.raises(exc, match=match):
        cvp.cross_view_pool(*_bad(case))


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _errors(got, plain, exact):
    """Per output: (max, mean) abs gap of the kernel and of the plain
    bfloat16 chain to the float64 pool, and the float64 outputs' scale."""
    out = []
    for g, p, e in zip(got, plain, exact):
        dk, dp = (g.double() - e).abs(), (p.double() - e).abs()
        out.append((dk.max().item(), dk.mean().item(), dp.max().item(),
                    dp.mean().item(), max(e.abs().max().item(), 1.0)))
    return out


@pytest.mark.card
@pytest.mark.parametrize("v,n,geometry_only", [
    (2, 4099, False), (2, 4099, True), (3, 4099, False), (3, 4099, True),
    (4, 4099, False), (4, 4099, True), (2, 1, False),
    (2, 1048576, False), (2, 1048576, True)])
def test_kernel_matches_pool_reference_on_the_card(v, n, geometry_only):
    """The kernel against ``pool_reference`` on the same bfloat16 inputs
    and weights, both measured against the pool in float64.  Tolerances:
    the kernel rounds each product's operands to bfloat16 where the plain
    chain materialises them (so both carry bfloat16 rounding of the same
    order: ~2^-8 relative a rounding, over ~10 layers), while its sums over
    views, its normalisations and its softmax stay float32 where the plain
    chain rounds every step.  So its mean gap must not pass the plain
    chain's by more than a quarter, its largest gap not twice the plain
    chain's plus one bfloat16 step of the output scale; nvalid (sums of 0/1
    masks) is exact, and the rgb of a geometry-only call is zero."""
    dev = _card()
    net = _net(7).to(dev)
    ins = _inputs(n, v, BF16, seed=11 + v, device=dev)
    packed = net.packed_pool_weights(ins[0])
    with torch.inference_mode():
        fused_mlp.reset_launches()
        got = cvp.cross_view_pool(*ins, packed, geometry_only)
        assert fused_mlp.VARIANT_LAUNCHES["pool_fused"] == 1
        plain = pool_reference(*ins, _params(net), geometry_only)
        p64 = {k: [(w.double(), b.double()) for w, b in ls]
               for k, ls in _params(net).items()}
        exact = pool_reference(*(t.double() for t in ins), p64,
                               geometry_only)
        torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert torch.equal(got[2].double(), exact[2])
    if geometry_only:
        assert not got[1].any()
    for name, (kmax, kmean, pmax, pmean, scale) in zip(
            ("geo", "rgb"), _errors(got[:2], plain[:2], exact[:2])):
        if geometry_only and name == "rgb":
            continue
        assert kmean <= 1.25 * pmean + 1e-6, (name, kmean, pmean)
        assert kmax <= 2 * pmax + 2 ** -8 * scale, (name, kmax, pmax)


@pytest.mark.card
def test_forward_dispatches_on_the_card():
    """On the card: a bfloat16 call without gradients launches the kernel
    once and agrees with the plain chain; float32 and a gradient-carrying
    call run the plain version."""
    dev = _card()
    net = _net(8).to(dev)
    ins = [t.to(dev) for t in _forward_inputs({}, 2, BF16, nr=64, dn=16)]
    fused_mlp.reset_launches()
    with torch.inference_mode():
        out = net(*ins)
    assert fused_mlp.VARIANT_LAUNCHES["pool_fused"] == 1
    assert fused_mlp.VARIANT_LAUNCHES["pool_plain"] == 0
    fused_mlp.reset_launches()
    with torch.inference_mode():
        ref = net.float()(*[t.float() for t in ins])
    net.to(BF16)
    out_g = net(*ins)
    assert fused_mlp.VARIANT_LAUNCHES["pool_plain"] == 2
    assert fused_mlp.VARIANT_LAUNCHES["pool_fused"] == 0
    assert out_g.requires_grad
    torch.testing.assert_close(out.float(), ref, atol=0.05, rtol=0.05)
