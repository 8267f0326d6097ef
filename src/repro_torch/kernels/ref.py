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


def ssm_scan_ref(x, dt, A, Bm, Cm, h0):
    """Mamba selective scan, sequential over t, all in f32
    (`repro/kernels/ref.py::ssm_scan_ref`): h_t = exp(dt_t A) h_{t-1} +
    (dt_t x_t) B_t, y_t = sum_n h_t C_t. x, dt (B,S,Di); A (Di,N); Bm, Cm
    (B,S,N); h0 (B,Di,N). Returns (y (B,S,Di) f32, h_final (B,Di,N) f32)."""
    h = h0.float()
    A = A.float()
    ys = []
    for t in range(x.shape[1]):
        dt_t = dt[:, t].float()
        da = torch.exp(dt_t[..., None] * A)
        db = (dt_t * x[:, t].float())[..., None] * Bm[:, t].float()[:, None, :]
        h = da * h + db
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t].float()))
    return torch.stack(ys, dim=1), h


def rglru_scan_ref(a, gx, h0):
    """Diagonal recurrence h_t = a_t * h_{t-1} + gx_t, sequential over t, in
    f32 (`repro/kernels/ref.py::rglru_scan_ref`): the product and the sum
    are two roundings, as K8 computes them. a, gx (B,S,W); h0 (B,W).
    Returns (hs (B,S,W) f32, h_final (B,W) f32)."""
    h = h0.float()
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + gx[:, t].float()
        hs.append(h)
    return torch.stack(hs, dim=1), h


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
