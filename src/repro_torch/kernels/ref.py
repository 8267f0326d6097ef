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
