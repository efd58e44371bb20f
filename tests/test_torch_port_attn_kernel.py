"""The ray attention kernel (``ops/kernels/ray_attention.py``,
``csrc/ray_attention.cu``) and its dispatch in
``agg_net.IBRNetWithNeuRay``.

On the CPU: the plain version against ``MultiHeadAttention.forward`` in
both layouts, the packing and its cache, the dispatch's plain cases, the
CUDA calls that reach the kernel, the wrapper's checks and the span's
reader.  Tests marked ``card`` hold the kernel against the plain chain on
a CUDA card and skip without one; this file imports no JAX, so on a
machine with a card (and no JAX) they run with
``python -m pytest tests/test_torch_port_attn_kernel.py --noconftest``.
"""

from types import SimpleNamespace

import pytest
import torch

from panogrf_tpu_torch.ops.kernels import _build, fused_mlp
from panogrf_tpu_torch.ops.kernels import ray_attention as rak
from panogrf_tpu_torch.renderer.agg_net import (IBRNetWithNeuRay,
                                                MultiHeadAttention,
                                                sinusoid_pos_encoding)
from torch_port_threads import one_torch_thread  # noqa: F401

BF16 = torch.bfloat16


def _net(seed=0, **kw):
    """A net whose attention weights are bfloat16 values, so that the
    packed buffer (rounded to bfloat16) holds them exactly."""
    torch.manual_seed(seed)
    net = IBRNetWithNeuRay(**kw)
    with torch.no_grad():
        for p in net.ray_attention.parameters():
            if p.dim() == 1:   # the LayerNorm's ones and zeros, moved
                p.add_(0.05 * torch.randn_like(p))
            p.copy_(p.to(BF16).float())
    return net


def _pos(dn, dtype=torch.float32):
    return torch.from_numpy(sinusoid_pos_encoding(dn, 16)).to(dtype)


def _operands(nr, dn, rn, dtype=torch.float32, seed=0, device="cpu"):
    """geo (nr dn, 16) and nvalid (nr dn, 1) in the row order (nr / rn, dn,
    rn): nvalid from 0 to 3, so about half the query rows are masked, and
    every row of the first ray masked."""
    g = torch.Generator().manual_seed(seed)
    geo = torch.randn(nr * dn, 16, generator=g) * 0.8
    nvalid = torch.randint(0, 4, (nr * dn, 1), generator=g).float()
    first = torch.zeros(nr, dn, dtype=torch.bool)
    first[0] = True
    nvalid[_rows(first, dn, rn)] = 0.0
    return geo.to(device, dtype), nvalid.to(device, dtype)


def _rows(ray_major_mask, dn, rn):
    """A (nr, dn) mask of rays' samples as a mask of the (nr / rn, dn, rn)
    row order."""
    nr = ray_major_mask.shape[0]
    return ray_major_mask.reshape(nr // rn, rn, dn).transpose(1, 2) \
        .reshape(-1)


def _plain(net, geo, nvalid, dn, rn):
    """What ``IBRNetWithNeuRay.forward`` computes on its plain path."""
    x = rak.ray_major(geo, dn, rn) + _pos(dn, geo.dtype).to(geo.device)
    mask = (rak.ray_major(nvalid, dn, rn)[..., 0] > 1).to(geo.dtype)
    return net.ray_attention(x, mask[..., None])


# (rays, samples a ray, rn): ray-major is rn = 1
LAYOUTS = {"ray_major_64": (6, 64, 1), "ray_major_128": (3, 128, 1),
           "ray_major_odd": (5, 37, 1), "depth_major_64": (8, 64, 4),
           "depth_major_128": (6, 128, 3), "depth_major_odd": (10, 37, 5)}


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_plain_version_is_multi_head_attention(case):
    """``ray_attention_reference`` on the pool's outputs in either layout
    equals the position add and ``MultiHeadAttention.forward`` on the
    ray-major rows in float32, masked query rows (nvalid <= 1) and a ray
    with every row masked included."""
    nr, dn, rn = LAYOUTS[case]
    net = _net(1)
    geo, nvalid = _operands(nr, dn, rn, seed=dn + rn)
    got = rak.ray_attention_reference(
        geo, nvalid, _pos(dn), net.packed_attention_weights(geo), dn, rn)
    want = _plain(net, geo, nvalid, dn, rn)
    assert got.shape == (nr, dn, 16)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_a_masked_query_averages_every_key():
    """A query row with nvalid <= 1 gives the same heads' output as
    attending with equal weights to every key of its ray."""
    net, dn = _net(2), 16
    geo, nvalid = _operands(1, dn, 1, seed=5)
    nvalid[:] = 1.0
    x = geo[None] + _pos(dn)
    a = net.ray_attention
    v = (x @ a.w_vs.weight.T).mean(1, keepdim=True).expand(1, dn, 16)
    y = torch.nn.functional.layer_norm(v @ a.fc.weight.T + x, (16,),
                                       a.layer_norm.weight,
                                       a.layer_norm.bias, 1e-6)
    got = rak.ray_attention_reference(geo, nvalid, _pos(dn),
                                      net.packed_attention_weights(geo), dn, 1)
    torch.testing.assert_close(got, y, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the packed weights (CPU)
# ---------------------------------------------------------------------------


def test_packing_round_trips_to_the_parameters():
    torch.manual_seed(3)
    attn = MultiHeadAttention()
    packed = rak.pack_attention_weights(attn)
    assert packed.shape == (rak.PACKED_SIZE,) and packed.dtype == torch.float32
    assert packed.device.type == "cpu" and packed.is_contiguous()
    back = rak.unpack_attention_weights(packed)
    for name, p in (("wq", attn.w_qs.weight), ("wk", attn.w_ks.weight),
                    ("wv", attn.w_vs.weight), ("fc", attn.fc.weight),
                    ("gamma", attn.layer_norm.weight),
                    ("beta", attn.layer_norm.bias)):
        assert torch.equal(back[name], p.detach().to(BF16).float()), name


LIKE = torch.zeros(1, dtype=BF16)


def _mma_warp(packed_mat, x):
    """The kernel's product y = W x of one warp's 32 sample slots, as
    ``mma.sync.m16n8k8`` computes it from the kernel's fragments (PTX's
    TF32 layouts: a0..a3 = A[g][t], A[g + 8][t], A[g][t + 4],
    A[g + 8][t + 4]; b0, b1 = B[t][g], B[t + 4][g]; c0..c3 = C[g][2t],
    C[g][2t + 1], C[g + 8][2t], C[g + 8][2t + 1]), in float64.  Lane
    (g, t) holds channels 4t .. 4t + 3 of slots g + 8i; slot 2 mt + j of a
    lane is row g + 8j of 16-row tile mt; the lane's A operand of k step kk
    is its channels 4t + 2kk (column t) and 4t + 2kk + 1 (column t + 4),
    and it reads channels 4t + 2nt, 4t + 2nt + 1 of its slots from n tile
    nt's c0, c1 (row g) and c2, c3 (row g + 8)."""
    frag = packed_mat.double().reshape(32, 2, 2, 2)   # lane, kk, nt, b0/b1
    y = torch.zeros(32, 16, dtype=torch.float64)
    for mt in range(2):
        for nt in range(2):
            c = torch.zeros(16, 8, dtype=torch.float64)
            for kk in range(2):
                a = torch.zeros(16, 8, dtype=torch.float64)
                b = torch.zeros(8, 8, dtype=torch.float64)
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    lo, hi = 16 * mt + g, 16 * mt + g + 8    # slots
                    a[g, t] = x[lo, 4 * t + 2 * kk]
                    a[g + 8, t] = x[hi, 4 * t + 2 * kk]
                    a[g, t + 4] = x[lo, 4 * t + 2 * kk + 1]
                    a[g + 8, t + 4] = x[hi, 4 * t + 2 * kk + 1]
                    b[t, g] = frag[lane, kk, nt, 0]
                    b[t + 4, g] = frag[lane, kk, nt, 1]
                c += a @ b
            for lane in range(32):
                g, t = divmod(lane, 4)
                ch = 4 * t + 2 * nt
                y[16 * mt + g, ch:ch + 2] = c[g, 2 * t:2 * t + 2]
                y[16 * mt + g + 8, ch:ch + 2] = c[g + 8, 2 * t:2 * t + 2]
    return y


@pytest.mark.parametrize("matrix", list(rak.MATRICES))
def test_fragment_order_computes_the_products(matrix):
    """Each packed matrix, read as the B operand of the kernel's
    ``mma.sync`` with its A and C fragments laid out as the kernel lays
    them, gives the same product as the (16, 16) weight it packs."""
    torch.manual_seed(4)
    attn = MultiHeadAttention()
    packed = rak.pack_attention_weights(attn)
    i = rak.MATRICES.index(matrix)
    mat = packed[256 * i:256 * (i + 1)]
    x = torch.randn(32, 16, dtype=torch.float64)
    w = rak.unpack_attention_weights(packed)[matrix].double()
    torch.testing.assert_close(_mma_warp(mat, x), x @ w.T, rtol=1e-12,
                               atol=1e-12)


def test_packed_weights_are_kept_while_the_parameters_stand():
    net = _net(1)
    a = net.packed_attention_weights(LIKE)
    assert net.packed_attention_weights(LIKE) is a
    assert torch.equal(a, rak.pack_attention_weights(net.ray_attention))


def test_packed_weights_repack_after_load_state_dict():
    net = _net(1)
    a = net.packed_attention_weights(LIKE)
    other = _net(2)
    net.load_state_dict(other.state_dict())
    b = net.packed_attention_weights(LIKE)
    assert b is not a and not torch.equal(a, b)
    assert torch.equal(b, rak.pack_attention_weights(other.ray_attention))


def test_packed_weights_repack_after_an_in_place_update():
    net = _net(1)
    a = net.packed_attention_weights(LIKE)
    with torch.no_grad():
        net.ray_attention.fc.weight.add_(0.5)
    b = net.packed_attention_weights(LIKE)
    assert b is not a and not torch.equal(a, b)
    assert torch.equal(b, rak.pack_attention_weights(net.ray_attention))


def test_packed_weights_of_a_net_made_in_inference_mode():
    """Parameters made under ``torch.inference_mode`` keep no version
    counter: the weights still pack and stay cached, and
    ``load_state_dict`` there packs them again."""
    with torch.inference_mode():
        net = IBRNetWithNeuRay()
        a = net.packed_attention_weights(LIKE)
        assert net.packed_attention_weights(LIKE) is a
        other = _net(2)
        net.load_state_dict(other.state_dict())
        b = net.packed_attention_weights(LIKE)
    assert b is not a
    assert torch.equal(b, rak.pack_attention_weights(other.ray_attention))


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


def _cuda(t):
    return torch.Tensor._make_subclass(_LooksCuda, t)


def _forward_inputs(dtype, nr=4, dn=16, v=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    shapes = ((35, 0.5), (32, 1.0), (4, 0.3))
    ins = [(torch.randn(nr, dn, v, c, generator=g) * sc).to(dtype)
           for c, sc in shapes]
    mask = (torch.rand(nr, dn, v, 1, generator=g) > 0.3).to(dtype)
    return ins + [mask]


# case -> (attention in place of the standard one, dtype, grad enabled,
# samples a ray)
PLAIN_CASES = {
    "float32": (None, torch.float32, False, 16),
    "grad_enabled": (None, BF16, True, 16),
    "two_heads": (lambda: MultiHeadAttention(n_head=2, d_k=8, d_v=8), BF16,
                  False, 16),
    "wider_heads": (lambda: MultiHeadAttention(d_k=8, d_v=8), BF16, False,
                    16),
    "samples_past_256": (None, BF16, False, 257)}


@pytest.mark.parametrize("case", ["cpu", *PLAIN_CASES])
def test_dispatch_takes_the_plain_path(case):
    """CPU tensors, float32, gradient-carrying calls, other head widths and
    more than 256 samples a ray run ``MultiHeadAttention.forward`` and
    count ``attn_plain``; on a CUDA tensor each of the latter cases is
    refused by the dispatch for its own reason (the bfloat16 call of 16
    samples beside them is taken)."""
    attn, dtype, grad, dn = PLAIN_CASES.get(case, (None, BF16, False, 16))
    net = _net(4)
    if attn is not None:
        net.ray_attention = attn()
    net = net.to(dtype)
    fused_mlp.reset_launches()
    with torch.set_grad_enabled(grad):
        out = net(*_forward_inputs(dtype, nr=2, dn=dn))
    assert fused_mlp.VARIANT_LAUNCHES["attn_plain"] == 1
    assert fused_mlp.VARIANT_LAUNCHES["attn_fused"] == 0
    assert out.shape == (2, dn, 4) and bool(torch.isfinite(out).all())
    fused_mlp.reset_launches()
    assert fused_mlp.VARIANT_LAUNCHES["attn_plain"] == 0

    def cuda_operands(dtype, dn):
        geo, nvalid = _operands(2, dn, 1, dtype)
        return _cuda(geo), _cuda(nvalid), _cuda(_pos(dn))
    if case != "cpu":
        with torch.set_grad_enabled(grad):
            assert not net._attention_takes(*cuda_operands(dtype, dn), dn, 1)
    with torch.no_grad():
        control = _net(4).to(BF16)
        assert control._attention_takes(*cuda_operands(BF16, 16), 16, 1)
        assert not control._attention_takes(*_operands(2, 16, 1, BF16),
                                            _pos(16), 16, 1)


def test_ablated_attention_runs_neither_path():
    net = _net(4, ablate_attention=True)
    fused_mlp.reset_launches()
    net(*_forward_inputs(torch.float32))
    assert fused_mlp.VARIANT_LAUNCHES["attn_plain"] == 0
    assert fused_mlp.VARIANT_LAUNCHES["attn_fused"] == 0


def _misaligned(t):
    """``t``'s values in a contiguous view 2 bytes past a 64-byte aligned
    start."""
    buf = torch.empty(t.numel() + 64, dtype=t.dtype)
    skip = (-buf.data_ptr() % 64) // buf.element_size()
    out = buf[skip + 1:skip + 1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == 2
    return out


@pytest.mark.parametrize("layout", ["ray_major", "depth_major",
                                    "misaligned", "non_contiguous"])
def test_cuda_bf16_call_reaches_the_kernel(layout, monkeypatch):
    """A bfloat16 CUDA call without gradients goes to the kernel's loader
    and never to ``MultiHeadAttention.forward``, in either layout; a
    misaligned or non-contiguous geo is copied for the kernel (the
    wrapper, which refuses both, is passed before the loader)."""
    class _Loaded(Exception):
        pass

    def loader():
        raise _Loaded

    def plain(*a, **k):
        raise AssertionError("MultiHeadAttention ran for a CUDA bf16 call")
    monkeypatch.setattr(_build, "load_library", loader)
    monkeypatch.setattr(MultiHeadAttention, "forward", plain)
    net, dn = _net(4).to(BF16), 16
    rn = 4 if layout == "depth_major" else 1
    geo, nvalid = _operands(8, dn, rn, BF16)
    if layout == "misaligned":
        geo = _misaligned(geo)
    elif layout == "non_contiguous":
        wide = torch.zeros(geo.shape[0], 20, dtype=BF16)
        wide[:, :16] = geo
        geo = wide[:, :16]
    pos = _cuda(_pos(dn))
    monkeypatch.setattr(net, "_pos_encoding", lambda dn, device, dtype: pos)
    packed = _cuda(net.packed_attention_weights(LIKE))
    monkeypatch.setattr(net, "packed_attention_weights", lambda like: packed)
    num_valid = rak.ray_major(nvalid, dn, rn).float()
    with torch.inference_mode(), pytest.raises(_Loaded):
        net._attend(_cuda(geo), _cuda(nvalid), num_valid, dn, rn, BF16)


# ---------------------------------------------------------------------------
# the wrapper's checks (CPU)
# ---------------------------------------------------------------------------


def _bad(case):
    dn, rn = 16, 1
    geo, nvalid = _operands(4, dn, rn, BF16)
    pos, packed = _pos(dn), rak.pack_attention_weights(MultiHeadAttention())
    if case == "non_contiguous":
        wide = torch.zeros(geo.shape[0], 20, dtype=BF16)
        wide[:, :16] = geo
        geo = wide[:, :16]
    elif case == "misaligned":
        geo = _misaligned(geo)
    elif case == "channels":
        geo = geo[:, :15].contiguous()
    elif case == "samples_past_256":
        dn = 257
    elif case == "rows_not_whole_rays":
        rn = 3
    elif case == "nvalid_rows":
        nvalid = nvalid[:-1].contiguous()
    elif case == "position_table":
        pos = _pos(dn + 1)
    elif case == "packed_size":
        packed = packed[:-4].contiguous()
    elif case == "packed_dtype":
        packed = packed.double()
    elif case == "packed_misaligned":
        buf = torch.empty(packed.numel() + 16)
        skip = (-buf.data_ptr() % 64) // 4 + 1
        packed = buf[skip:skip + packed.numel()].copy_(packed)
    elif case == "float32":
        geo = geo.float()
    ts = (geo, nvalid, pos, packed)
    if case != "cpu_device":
        ts = tuple(_cuda(t) for t in ts)
    return (*ts, dn, rn)


WRAPPER_CASES = {"non_contiguous": (ValueError, "contiguous"),
                 "misaligned": (ValueError, "aligned"),
                 "channels": (ValueError, r"geo \(N, 16\)"),
                 "samples_past_256": (ValueError, "dn <= 256"),
                 "rows_not_whole_rays": (ValueError, "dn <= 256"),
                 "nvalid_rows": (ValueError, "nvalid"),
                 "position_table": (ValueError, "position table"),
                 "packed_size": (ValueError, "packed"),
                 "packed_dtype": (ValueError, "packed"),
                 "packed_misaligned": (ValueError, "aligned"),
                 "float32": (TypeError, "bfloat16"),
                 "cpu_device": (ValueError, "CUDA")}


@pytest.mark.parametrize("case", list(WRAPPER_CASES))
def test_wrapper_raises_on_what_the_kernel_does_not_take(case, monkeypatch):
    """Handed directly a non-contiguous, misaligned, misshaped, mistyped
    or CPU operand, ``ray_attention`` raises before it loads the
    library."""
    def loader():
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(_build, "load_library", loader)
    exc, match = WRAPPER_CASES[case]
    with pytest.raises(exc, match=match):
        rak.ray_attention(*_bad(case))


# ---------------------------------------------------------------------------
# the span's reader (CPU)
# ---------------------------------------------------------------------------


def test_attn_ms_reader_reads_the_attention_span(monkeypatch):
    """``attn_ms.walkthrough`` gives the ``panogrf.agg.attn`` spans' device
    ms per frame of the profiled sub-window, and None where no such span
    ran (as on a program without it)."""
    from h100bench import manifest
    from panogrf_tpu_torch.utils import spans
    read = manifest.reader("attn_ms.walkthrough")
    ctx = SimpleNamespace(trace_items=4)
    monkeypatch.setattr(spans, "device_ms", lambda: {
        "panogrf.agg.attn": [1.0, 3.0, 4.0], "panogrf.agg.pool": [50.0]})
    assert read(ctx) == pytest.approx(2.0)
    monkeypatch.setattr(spans, "device_ms",
                        lambda: {"panogrf.agg.pool": [1.0]})
    assert read(ctx) is None
    entry = [m for m in manifest.load_manifest()["per_layer"]
             if m["name"] == "attn_ms.walkthrough"]
    assert len(entry) == 1 and entry[0]["moves"] == "frame_ms"


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _gaps(got, plain, exact):
    """(max, mean) abs gap of the kernel and of the plain bfloat16 chain to
    the float64 attention, and the float64 output's scale."""
    dk, dp = (got.double() - exact).abs(), (plain.double() - exact).abs()
    return (dk.max().item(), dk.mean().item(), dp.max().item(),
            dp.mean().item(), max(exact.abs().max().item(), 1.0))


# (rays, samples a ray, rn): the walkthrough's call is 16,384 rays of 64
# samples in 4 depth-major frames of 4096 rays (1,048,576 points)
CARD_CASES = {"walkthrough_depth_major": (16384, 64, 4096),
              "walkthrough_ray_major": (16384, 64, 1),
              "fine_all_128": (4096, 128, 4096),
              "odd_samples": (1000, 37, 1),
              "odd_rays_depth_major": (1001, 24, 7),
              "one_sample": (64, 1, 1),
              "most_samples": (512, 256, 1)}


@pytest.mark.card
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_matches_the_plain_chain_on_the_card(case):
    """The kernel against the plain bfloat16 chain (the position add and
    ``MultiHeadAttention`` as the forward runs them) on the same inputs
    and weights, both measured against the attention in float64.  About
    half the query rows and every row of the first ray are masked.
    Tolerances: the kernel keeps everything between geo and its output in
    float32 where the plain chain rounds q, k, v, the scores, the softmax,
    the heads' output and fc's to bfloat16, so its mean gap must not pass
    the plain chain's by more than a quarter and its largest not twice the
    plain chain's plus one bfloat16 step of the output scale."""
    dev = _card()
    nr, dn, rn = CARD_CASES[case]
    net = _net(7).to(dev)
    geo, nvalid = _operands(nr, dn, rn, BF16, seed=nr + dn, device=dev)
    pos = _pos(dn).to(dev)
    packed = net.packed_attention_weights(geo)
    with torch.inference_mode():
        fused_mlp.reset_launches()
        got = rak.ray_attention(geo, nvalid, pos, packed, dn, rn)
        assert fused_mlp.VARIANT_LAUNCHES["attn_fused"] == 1
        plain = _plain(net.to(BF16), geo, nvalid, dn, rn)
        exact = rak.ray_attention_reference(geo.double(), nvalid, pos,
                                            packed, dn, rn)
        torch.cuda.synchronize()
    assert got.shape == (nr, dn, 16) and got.dtype == BF16
    assert bool(torch.isfinite(got).all())
    kmax, kmean, pmax, pmean, scale = _gaps(got, plain, exact)
    assert kmean <= 1.25 * pmean + 1e-6, (kmean, pmean)
    assert kmax <= 2 * pmax + 2 ** -8 * scale, (kmax, pmax)


@pytest.mark.card
def test_forward_dispatches_on_the_card():
    """On the card: a bfloat16 call without gradients launches the kernel
    once and agrees with the float32 forward; float32 and a
    gradient-carrying call run ``MultiHeadAttention.forward``."""
    dev = _card()
    net = _net(8).to(dev)
    ins = [t.to(dev) for t in _forward_inputs(BF16, nr=64, dn=64)]
    fused_mlp.reset_launches()
    with torch.inference_mode():
        out = net.to(BF16)(*ins)
    assert fused_mlp.VARIANT_LAUNCHES["attn_fused"] == 1
    assert fused_mlp.VARIANT_LAUNCHES["attn_plain"] == 0
    fused_mlp.reset_launches()
    with torch.inference_mode():
        ref = net.float()(*[t.float() for t in ins])
    net.to(BF16)
    out_g = net(*ins)
    assert fused_mlp.VARIANT_LAUNCHES["attn_plain"] == 2
    assert fused_mlp.VARIANT_LAUNCHES["attn_fused"] == 0
    assert out_g.requires_grad
    torch.testing.assert_close(out.float(), ref, atol=0.05, rtol=0.05)
