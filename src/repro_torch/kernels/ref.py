"""Plain PyTorch versions of the hand-written kernels. Deliberately naive
(full score matrices, f32 softmax): the CPU path of each kernel wrapper and
the reference the kernels are held against on the card."""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B,Hq,Sq,D); k,v (B,Hk,Sk,D); GQA by head grouping. f32 softmax."""
    B, Hq, Sq, D = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    G = Hq // Hk
    qg = q.reshape(B, Hk, G, Sq, D)
    s = torch.einsum("bkgqd,bkld->bkgql", qg.float(), k.float()) * (D ** -0.5)
    row = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)  # q suffix of k
    col = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= col <= row
    if window:
        mask &= col > row - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgql,bkld->bkgqd", p, v.float())
    return o.reshape(B, Hq, Sq, D).to(q.dtype)


ROW_ULPS = 8


def attention_row_ratio(out, ref32, ulps: int = ROW_ULPS) -> float:
    """The per-row rule for a bf16 attention output: for each row,
    max_d |out - ref32| must be at most `ulps` bf16 ulps of max_d |ref32|.
    `ref32` is `attention_ref` on f32 upcasts of the same bf16 inputs, kept
    in f32. Returns the worst ratio of error to limit: the rule holds at
    <= 1. A row's limit scales with its own output, so a key dropped or
    added at an edge shows in the rows it touches even where the error is
    below an absolute tolerance."""
    err = (out.float() - ref32).abs().amax(dim=-1)
    peak = ref32.abs().amax(dim=-1).clamp_min(torch.finfo(torch.bfloat16).tiny)
    _, e = torch.frexp(peak)  # peak = m * 2**e, m in [0.5, 1): ulp 2**(e - 8)
    limit = ulps * torch.ldexp(torch.ones_like(peak), e - 8)
    return (err / limit).max().item()


def _work(*ts):
    """The plain scans' arithmetic dtype: f32, or f64 where an input is f64
    (the gradient checks run the plain versions in f64)."""
    return torch.float64 if any(t.dtype == torch.float64 for t in ts) else torch.float32


def ssm_scan_ref(x, dt, A, Bm, Cm, h0):
    """Mamba selective scan, sequential over t, all in f32
    (`repro/kernels/ref.py::ssm_scan_ref`): h_t = exp(dt_t A) h_{t-1} +
    (dt_t x_t) B_t, y_t = sum_n h_t C_t. x, dt (B,S,Di); A (Di,N); Bm, Cm
    (B,S,N); h0 (B,Di,N). Returns (y (B,S,Di) f32, h_final (B,Di,N) f32);
    f64 throughout where an input is f64."""
    w = _work(x, dt, A, Bm, Cm, h0)
    h = h0.to(w)
    A = A.to(w)
    ys = []
    for t in range(x.shape[1]):
        dt_t = dt[:, t].to(w)
        da = torch.exp(dt_t[..., None] * A)
        db = (dt_t * x[:, t].to(w))[..., None] * Bm[:, t].to(w)[:, None, :]
        h = da * h + db
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t].to(w)))
    return torch.stack(ys, dim=1), h


def ssm_scan_bwd_ref(x, dt, A, Bm, Cm, h0, dy, dh):
    """The backward of `ssm_scan_ref`: an explicit reverse loop over t in
    f32 (f64 where an input is f64), without autograd. dy (B,S,Di) is the
    cotangent of y, dh (B,Di,N) that of h_final (None: zeros). The forward
    states are recomputed from h0. The state adjoint g (B,Di,N) starts at
    dh; for t = S-1 .. 0, with da_t = exp(dt_t A) and h_{-1} = h0:
        g += dy_t C_t;  dC_t = sum_d dy_t h_t;  dB_t = sum_d g dt_t x_t;
        dx_t = dt_t sum_n g B_t;  ddt_t = sum_n g (A da_t h_{t-1} + x_t B_t);
        dA += sum_b g dt_t da_t h_{t-1};  g = da_t g
    and dh0 = g. Returns (dx, ddt, dA, dBm, dCm, dh0), each in its input's
    dtype (dBm and dCm contiguous)."""
    w = _work(x, dt, A, Bm, Cm, h0, dy)
    S = x.shape[1]
    A_w = A.to(w)
    hs = [h0.to(w)]  # hs[t + 1] = h_t
    for t in range(S):
        dt_t = dt[:, t].to(w)
        db = (dt_t * x[:, t].to(w))[..., None] * Bm[:, t].to(w)[:, None, :]
        hs.append(torch.exp(dt_t[..., None] * A_w) * hs[-1] + db)
    g = torch.zeros_like(hs[0]) if dh is None else dh.to(w)
    dx, ddt, dBm, dCm = [None] * S, [None] * S, [None] * S, [None] * S
    dA = torch.zeros_like(A_w)
    for t in range(S - 1, -1, -1):
        dt_t, x_t, dy_t = dt[:, t].to(w), x[:, t].to(w), dy[:, t].to(w)
        B_t, C_t = Bm[:, t].to(w), Cm[:, t].to(w)
        da = torch.exp(dt_t[..., None] * A_w)
        g = g + dy_t[..., None] * C_t[:, None, :]
        dCm[t] = torch.einsum("bd,bdn->bn", dy_t, hs[t + 1])
        dBm[t] = torch.einsum("bdn,bd->bn", g, dt_t * x_t)
        dx[t] = dt_t * torch.einsum("bdn,bn->bd", g, B_t)
        dah = da * hs[t]
        ddt[t] = (g * (A_w * dah + x_t[..., None] * B_t[:, None, :])).sum(-1)
        dA = dA + (g * dt_t[..., None] * dah).sum(0)
        g = da * g
    return (torch.stack(dx, 1).to(x.dtype), torch.stack(ddt, 1).to(dt.dtype),
            dA.to(A.dtype), torch.stack(dBm, 1).to(Bm.dtype),
            torch.stack(dCm, 1).to(Cm.dtype), g.to(h0.dtype))


def rglru_scan_ref(a, gx, h0):
    """Diagonal recurrence h_t = a_t * h_{t-1} + gx_t, sequential over t, in
    f32 (`repro/kernels/ref.py::rglru_scan_ref`): the product and the sum
    are two roundings, as K8 computes them. a, gx (B,S,W); h0 (B,W).
    Returns (hs (B,S,W) f32, h_final (B,W) f32); f64 throughout where an
    input is f64."""
    w = _work(a, gx, h0)
    h = h0.to(w)
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t].to(w) * h + gx[:, t].to(w)
        hs.append(h)
    return torch.stack(hs, dim=1), h


def rglru_scan_bwd_ref(a, gx, h0, hs, dhs, dh):
    """The backward of `rglru_scan_ref`: an explicit reverse loop over t in
    f32 (f64 where an input is f64), without autograd. hs (B,S,W) are the
    forward's states, dhs their cotangent, dh that of h_final (None: no
    term). The adjoint is g_{S-1} = dhs_{S-1} + dh and g_t = dhs_t + a_{t+1}
    g_{t+1}, the product and the sum two roundings, as the backward kernel
    computes them; then dgx_t = g_t, da_t = g_t h_{t-1} (h_{-1} = h0) and
    dh0 = a_0 g_0. Returns (da, dgx, dh0), each in its input's dtype."""
    w = _work(a, gx, h0, hs, dhs)
    S = a.shape[1]
    da, dgx = [None] * S, [None] * S
    g = dhs[:, S - 1].to(w)
    if dh is not None:
        g = g + dh.to(w)
    for t in range(S - 1, -1, -1):
        if t < S - 1:
            g = dhs[:, t].to(w) + a[:, t + 1].to(w) * g
        dgx[t] = g
        da[t] = g * (hs[:, t - 1].to(w) if t else h0.to(w))
    return (torch.stack(da, 1).to(a.dtype), torch.stack(dgx, 1).to(gx.dtype),
            (a[:, 0].to(w) * g).to(h0.dtype))


def eq1_merge_ref(local, stale, *, staleness, global_world, extra_staleness=0):
    """Paper Eq. (1) over an arena (or any tensor), as
    `repro/kernels/ref.py::eq1_merge_ref` computes it: f32 math, result in
    local's dtype, true division by s2 + p rounded to f32. The divisor is a
    tensor on local's device: PyTorch's CUDA `div` by a Python scalar
    multiplies by the reciprocal instead."""
    s2 = 2.0 * (staleness + extra_staleness)
    p = float(global_world)
    denom = torch.tensor(s2 + p, dtype=torch.float32, device=local.device)
    merged = (s2 * local.float() + p * stale.float()) / denom
    return merged.to(local.dtype)


def bf16_pack_ref(x):
    """Arena -> bf16 wire buffer, round to nearest even."""
    return x.to(torch.bfloat16)


def bf16_unpack_ref(x, out_dtype=torch.float32):
    """bf16 wire buffer -> arena in `out_dtype` (exact)."""
    return x.to(out_dtype)


# keeps all-zero blocks finite (q == 0 regardless); the kernel takes it
# from here, so plain version and kernel cannot drift
INT8_SCALE_FLOOR = 1e-12


def _blocked(x, block: int):
    """(..., N) -> ((rows, n_blocks, block) view, zero-padded when block
    does not divide N, and (lead, N, Np))."""
    lead, n = tuple(x.shape[:-1]), x.shape[-1]
    npad = -(-n // block) * block
    xr = x.reshape(-1, n)
    if npad != n:
        xr = torch.nn.functional.pad(xr, (0, npad - n))
    return xr.reshape(xr.shape[0], npad // block, block), (lead, n, npad)


def _unblocked(xb, lead, n, npad):
    """Inverse of `_blocked`: the padding cut, contiguous as the kernels'
    outputs are."""
    return xb.reshape(-1, npad)[:, :n].reshape(lead + (n,)).contiguous()


def quantize_int8_block_ref(x, *, block: int = 256, bits=None):
    """Block-scaled int8 quantization over the trailing axis, as
    `repro/kernels/ref.py::quantize_int8_block_ref` computes it: blocks of
    `block` elements never span leading rows, a ragged last block is
    zero-padded; scale = max(absmax(block), 1e-12) / 127 by true division
    (the divisor is a tensor on x's device: PyTorch's CUDA `div` by a
    Python scalar multiplies by the reciprocal); q = round-half-even(x /
    scale), or floor(x / scale + u) with u = (bits >> 8) * 2^-24 when
    `bits` (uint32, x's shape) is given; clipped to +-127. The sum v + u
    is taken in f64, where it is exact: the reference's f32 sum rounds,
    for one, -127 + (1 - 2^-24) up to -126, and its error then passes
    the scale.

    A block whose absmax is NaN or inf has NaN in place of some x / scale;
    the reference's float -> int8 cast of NaN is undefined, and here such
    a value is stored as 0. Returns (values int8 like x, scales f32
    (*lead, ceil(N / block)))."""
    xb, meta = _blocked(x.float(), block)
    d127 = torch.tensor(127.0, dtype=torch.float32, device=x.device)
    floor = torch.tensor(INT8_SCALE_FLOOR, dtype=torch.float32, device=x.device)
    # torch.maximum and amax propagate NaN, as jnp.maximum and jnp.max do
    scale = torch.maximum(xb.abs().amax(dim=-1, keepdim=True), floor) / d127
    v = xb / scale
    if bits is None:
        v = v.round_()
    else:
        # torch's uint32 cannot shift: the int32 view shifts arithmetically,
        # the mask keeps the logical shift's 24 bits
        bb, _ = _blocked(bits.view(torch.int32), block)
        u = ((bb >> 8) & 0xFFFFFF).double() * 2.0 ** -24  # exact: < 2^24 times 2^-24
        v = (v.double() + u).floor_().float()  # an integer: exact in f32
    v = v.clamp_(-127.0, 127.0).nan_to_num_(nan=0.0)
    values = _unblocked(v.to(torch.int8), *meta)
    lead, _, npad = meta
    return values, scale.reshape(lead + (npad // block,))


def dequantize_int8_block_ref(values, scales, *, block: int = 256):
    """Inverse of `quantize_int8_block_ref`: q * scale of its block, f32."""
    vb, meta = _blocked(values, block)
    return _unblocked(vb.float() * scales.reshape(vb.shape[:-1] + (1,)), *meta)
