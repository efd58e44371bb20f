"""The aggregation net's ray attention as one CUDA kernel, its plain
version and the packing of its weights.

``ray_attention`` launches ``csrc/ray_attention.cu``: from the cross-view
pool's outputs (geo (N, 16) and nvalid, bfloat16, their rows depth-major
(nr / rn, dn, rn) or, with rn = 1, ray-major (nr, dn)) to the ray-major
(nr, dn, 16) features that ``out_geometry_fc`` reads: the position add,
``agg_net.MultiHeadAttention`` (4 heads of 4, query rows with nvalid <= 1
masked), fc, the residual and the LayerNorm: float32 sums, softmax and
LayerNorm, TF32 operands of the projections and fc (the plain bfloat16
chain rounds all of these to bfloat16).
``ray_attention_reference`` is its plain version on the same operands.
``agg_net.IBRNetWithNeuRay`` dispatches: bfloat16 CUDA calls without
gradients at these widths and at most ``MAX_SAMPLES`` samples a ray take
the kernel; every other call runs ``MultiHeadAttention.forward``.

The kernel reads its weights from one float32 buffer on the device that
``pack_attention_weights`` builds: the q, k, v and fc weights, each rounded
to bfloat16 as the plain bfloat16 call casts them and laid out in the
B-fragment order of ``mma.sync`` m16n8k8 (``_FRAG_OUT``, ``_FRAG_IN``),
then the LayerNorm's weight and bias.
"""

from __future__ import annotations

import torch

from panogrf_tpu_torch.ops.kernels import fused_mlp

D_MODEL, N_HEAD, D_K = 16, 4, 4
MAX_SAMPLES = 256
EPS = 1e-6
MATRICES = ("wq", "wk", "wv", "fc")
PACKED_SIZE = len(MATRICES) * D_MODEL * D_MODEL + 2 * D_MODEL


def _fragment_order() -> tuple:
    """(out, in) indices of a (16, 16) [out][in] weight in the kernel's
    B-fragment order: lane (g, t) = (lane // 4, lane % 4), k step kk, n
    tile nt, then b0 / b1 (h).  The products' K and N orders are permuted
    so that a lane's A fragment holds its own channels 4t .. 4t + 3 (k row
    t + 4h of step kk is input channel 4t + 2kk + h) and its C fragment
    head t's outputs (column 2t + e of n tile nt is output channel
    4t + 2nt + e): B[k][n] = W[out(n)][in(k)], b0 = B[t][g], b1 =
    B[t + 4][g]."""
    lane = torch.arange(32)[:, None, None, None]
    g, t = lane // 4, lane % 4
    kk = torch.arange(2)[None, :, None, None]
    nt = torch.arange(2)[None, None, :, None]
    h = torch.arange(2)[None, None, None, :]
    out = 4 * (g // 2) + 2 * nt + g % 2
    inp = 4 * t + 2 * kk + h
    shape = (32, 2, 2, 2)
    return out.expand(shape).reshape(-1), inp.expand(shape).reshape(-1)


_FRAG_OUT, _FRAG_IN = _fragment_order()


def pack_attention_weights(attn) -> torch.Tensor:
    """The kernel's float32 buffer (``PACKED_SIZE``,) from a
    ``MultiHeadAttention``'s parameters, each rounded to bfloat16, on their
    device."""
    mats = [attn.w_qs.weight, attn.w_ks.weight, attn.w_vs.weight,
            attn.fc.weight]
    with torch.no_grad():
        def rounded(p):
            return p.detach().to(torch.bfloat16).float()
        return torch.cat(
            [rounded(w)[_FRAG_OUT.to(w.device), _FRAG_IN.to(w.device)]
             for w in mats] +
            [rounded(attn.layer_norm.weight), rounded(attn.layer_norm.bias)]
        ).contiguous()


def unpack_attention_weights(packed: torch.Tensor) -> dict:
    """``pack_attention_weights``' buffer as {"wq", "wk", "wv", "fc": (16,
    16) [out][in], "gamma", "beta": (16,)}."""
    d, n = D_MODEL, D_MODEL * D_MODEL
    got = {}
    for i, name in enumerate(MATRICES):
        w = packed.new_empty(d, d)
        w[_FRAG_OUT.to(packed.device), _FRAG_IN.to(packed.device)] = \
            packed[i * n:(i + 1) * n]
        got[name] = w
    got["gamma"] = packed[4 * n:4 * n + d]
    got["beta"] = packed[4 * n + d:4 * n + 2 * d]
    return got


def ray_major(t: torch.Tensor, dn: int, rn: int) -> torch.Tensor:
    """(N, c) rows ordered (nr / rn, dn, rn) as (nr, dn, c)."""
    n, c = t.shape[0], t.shape[-1]
    nr = n // dn
    return t.reshape(nr // rn, dn, rn, c).transpose(1, 2).reshape(nr, dn, c)


def ray_attention_reference(geo: torch.Tensor, nvalid: torch.Tensor,
                            pos: torch.Tensor, packed: torch.Tensor,
                            dn: int, rn: int = 1) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in float32 (float64 for a
    float64 ``geo``), on any device: (nr, dn, 16) in ``geo``'s dtype.  A
    masked query (nvalid <= 1) attends with q = 0, which averages every
    key, as ``MultiHeadAttention``'s -1e9 fill does."""
    ct = torch.float64 if geo.dtype == torch.float64 else torch.float32
    w = {k: v.to(geo.device, ct)
         for k, v in unpack_attention_weights(packed).items()}
    x = ray_major(geo.to(ct), dn, rn) + pos.to(geo.device, ct)
    valid = ray_major(nvalid.reshape(-1, 1).to(ct), dn, rn) > 1
    nr = x.shape[0]

    def heads(y):
        return y.reshape(nr, dn, N_HEAD, D_K).transpose(1, 2)
    q = heads(torch.where(valid, x @ w["wq"].T, 0.0)) / D_K ** 0.5
    k, v = heads(x @ w["wk"].T), heads(x @ w["wv"].T)
    o = torch.softmax(q @ k.transpose(-1, -2), -1) @ v
    y = o.transpose(1, 2).reshape(nr, dn, D_MODEL) @ w["fc"].T + x
    y = torch.nn.functional.layer_norm(y, (D_MODEL,), w["gamma"],
                                       w["beta"], EPS)
    return y.to(geo.dtype)


def _refusal(geo, nvalid, pos, packed, dn, rn, layout=True):
    """Why the kernel cannot take these operands, as the exception to
    raise, or None: bfloat16 geo (N, 16) and nvalid (N,) or (N, 1) on one
    CUDA device, N > 0 a multiple of dn rn, 1 <= dn <= ``MAX_SAMPLES``,
    a float32 position table (dn, 16) there, contiguous and 16-byte
    aligned (unless ``layout`` is False), and ``packed`` (when given)
    likewise, float32 of ``PACKED_SIZE``."""
    if geo.dim() != 2 or geo.shape[-1] != D_MODEL:
        return ValueError(f"ray_attention takes geo (N, {D_MODEL}), got "
                          f"{tuple(geo.shape)}")
    n = geo.shape[0]
    if not 1 <= dn <= MAX_SAMPLES or rn < 1 or n == 0 or n % (dn * rn):
        return ValueError(f"ray_attention takes N > 0 rows of (nr / rn, dn, "
                          f"rn) with 1 <= dn <= {MAX_SAMPLES}; got N = {n},"
                          f" dn = {dn}, rn = {rn}")
    if nvalid.numel() != n or nvalid.dim() not in (1, 2) or \
            nvalid.shape[0] != n:
        return ValueError(f"ray_attention takes nvalid (N,) or (N, 1) with "
                          f"N = {n}; got {tuple(nvalid.shape)}")
    if tuple(pos.shape) != (dn, D_MODEL) or pos.dtype != torch.float32:
        return ValueError(f"ray_attention takes a float32 position table "
                          f"({dn}, {D_MODEL}); got {tuple(pos.shape)} "
                          f"{pos.dtype}")
    ts = (geo, nvalid, pos)
    if packed is not None:
        if tuple(packed.shape) != (PACKED_SIZE,) or \
                packed.dtype != torch.float32:
            return ValueError(f"packed weights must be float32 "
                              f"({PACKED_SIZE},), got {tuple(packed.shape)} "
                              f"{packed.dtype}")
        ts += (packed,)
    for t in (geo, nvalid):
        if t.dtype != torch.bfloat16:
            return TypeError(f"ray_attention takes bfloat16, got {t.dtype}")
    for t in ts:
        if t.device.type != "cuda" or t.device != geo.device:
            return ValueError(f"ray_attention runs on one CUDA device, got "
                              f"{t.device}")
        if layout and not t.is_contiguous():
            return ValueError("ray_attention takes contiguous tensors only")
    if layout and any(t.data_ptr() % 16 for t in ts if t is not nvalid):
        return ValueError("ray_attention takes 16-byte aligned geo, "
                          "position table and weights")
    return None


def takes(geo: torch.Tensor, nvalid: torch.Tensor, pos: torch.Tensor,
          dn: int, rn: int) -> bool:
    """True when the kernel computes the attention of these operands:
    their device, dtypes, shapes and sample count, whatever their layout
    (``cross_view_pool.laid_out`` gives each the layout the kernel
    reads)."""
    return _refusal(geo, nvalid, pos, None, dn, rn, layout=False) is None


def ray_attention(geo: torch.Tensor, nvalid: torch.Tensor, pos: torch.Tensor,
                  packed: torch.Tensor, dn: int, rn: int = 1) -> torch.Tensor:
    """``ray_attention_reference`` in one launch: (nr, dn, 16) bfloat16,
    contiguous.  ``packed`` is ``pack_attention_weights``' buffer on the
    operands' device."""
    refused = _refusal(geo, nvalid, pos, packed, dn, rn)
    if refused is not None:
        raise refused
    from panogrf_tpu_torch.ops.kernels._build import load_library
    lib = load_library()
    nr = geo.shape[0] // dn
    out = torch.empty(nr, dn, D_MODEL, dtype=torch.bfloat16,
                      device=geo.device)
    rc = lib.panogrf_ray_attention(
        geo.data_ptr(), nvalid.data_ptr(), pos.data_ptr(), packed.data_ptr(),
        out.data_ptr(), nr, dn, rn, PACKED_SIZE,
        torch.cuda.current_stream(geo.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ray_attention kernel launch failed (CUDA error "
                           f"{rc})")
    fused_mlp.VARIANT_LAUNCHES["attn_fused"] += 1
    return out
