"""GQA attention: causal / sliding-window prefill and cached one-token decode.

Prefill runs through the hand-written flash attention kernel
(`impl="kernel"`, `kernels/ops.py`) or through `multihead_attention`, the
plain chunked path (`impl="plain"`), which is the teacher-forced reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import dense_init, head_rms_norm, rms_norm
from repro_torch.models.rope import apply_mrope, apply_rope

NEG_INF = -1e30


def _pick_chunk(seq: int, target: int) -> int:
    c = min(target, seq)
    while seq % c:
        c //= 2
    return max(c, 1)


def multihead_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        q_chunk: int = 1024):
    """q (B,Sq,Hq,D); k,v (B,Sk,K,D); GQA via grouped einsum. Returns (B,Sq,Hq,D).

    q and k cover the same token range starting at position 0 (prefill).
    window > 0 restricts attention to the last `window` positions (inclusive
    of self). Scores and softmax in f32; probabilities cast to v's dtype.
    """
    B, Sq, Hq, D = q.shape
    K = k.shape[2]
    G = Hq // K
    qg = q.reshape(B, Sq, K, G, D)
    scale = D ** -0.5
    C = _pick_chunk(Sq, q_chunk)
    outs = []
    for qc in range(0, Sq, C):
        # K/V slice reachable from rows [qc, qc+C)
        hi = min(qc + C, k.shape[1]) if causal else k.shape[1]
        lo = max(0, qc - window + 1) if window else 0
        ks, vs = k[:, lo:hi], v[:, lo:hi]
        qs = qg[:, qc:qc + C]
        scores = torch.einsum("bckgd,blkd->bkgcl", qs.float(), ks.float()) * scale
        row = qc + torch.arange(C, device=q.device)[:, None]
        col = lo + torch.arange(hi - lo, device=q.device)[None, :]
        mask = torch.ones((C, hi - lo), dtype=torch.bool, device=q.device)
        if causal:
            mask &= col <= row
        if window:
            mask &= col > row - window
        scores = scores.masked_fill(~mask, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bkgcl,blkd->bckgd", probs, vs))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out.reshape(B, Sq, Hq, D)


def decode_attention(q, k_cache, v_cache, pos: int, *, window: int = 0):
    """One-token decode. q (B,1,Hq,D); caches:
      full:  (B,S_max,K,D), valid slots are indices <= pos
      ring:  (B,W,K,D) with W == window; slot i holds absolute position
             pos - ((pos - i) mod W)
    pos: absolute position of the current token (0-based).
    """
    B, _, Hq, D = q.shape
    K = k_cache.shape[2]
    G = Hq // K
    qg = q.reshape(B, 1, K, G, D)
    scores = torch.einsum("bckgd,blkd->bkgcl", qg.float(),
                          k_cache.float()) * (D ** -0.5)
    S = k_cache.shape[1]
    slots = torch.arange(S, device=q.device)
    if window:
        valid = pos - torch.remainder(pos - slots, S) >= 0
    else:
        valid = slots <= pos
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgcl,blkd->bckgd", probs, v_cache)
    return out.reshape(B, 1, Hq, D)


def init_attn(generator, cfg, dtype, device):
    """The projections and the pre-norm scale; under qk_norm also the zero
    q_norm / k_norm scales (head_dim,), which draw nothing from `generator`."""
    D, Hq, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(generator, (D, Hq * hd), dtype, device),
        "wk": dense_init(generator, (D, K * hd), dtype, device),
        "wv": dense_init(generator, (D, K * hd), dtype, device),
        "wo": dense_init(generator, (Hq * hd, D), dtype, device,
                         scale=1.0 / (2 * cfg.n_layers) ** 0.5),
        "norm": torch.zeros((D,), dtype=dtype, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
    return p


def kernel_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """(B,S,H,D)-layout attention through the flash attention kernel."""
    out = ops.flash_attention(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(),
                              causal=causal, window=window)
    return out.transpose(1, 2)


def attn_apply(p, x, positions, cfg, *, window: int = 0,
               cache: Optional[dict] = None, pos: Optional[int] = None,
               impl: str = "kernel"):
    """Pre-norm attention sub-block. Returns (residual_delta, cache).

    Prefill: cache is None, or a cache dict to fill. Decode: x is (B,1,D),
    cache holds K/V, pos is the absolute position. The cache tensors are
    written in place and the same dict is returned. positions: (B,S), or
    (B,S,3) under M-RoPE. q and k are normalised (qk_norm) and rotated
    before either path, so decode caches the key prefill would have.
    """
    B, S, D = x.shape
    Hq, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q = (h @ p["wq"]).reshape(B, S, Hq, hd)
    k = (h @ p["wk"]).reshape(B, S, K, hd)
    v = (h @ p["wv"]).reshape(B, S, K, hd)
    if cfg.qk_norm:
        q = head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = head_rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_type == "standard":  # "none": lm.forward adds sinusoidal positions
        q, k = apply_rope(q, k, positions, cfg.rope_theta)
    elif cfg.rope_type == "mrope":
        q, k = apply_mrope(q, k, positions, cfg.rope_theta)

    if cache is not None and pos is not None and S == 1:  # decode
        S_c = cache["k"].shape[1]
        slot = pos % S_c if window else pos
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        out = decode_attention(q, cache["k"], cache["v"], pos, window=window)
    else:
        if impl == "kernel":
            out = kernel_attention(q, k, v, causal=True, window=window)
        elif impl == "plain":
            out = multihead_attention(q, k, v, causal=True, window=window)
        else:
            raise ValueError(f"attn_apply: impl {impl!r} not in ('kernel', 'plain')")
        if cache is not None:  # prefill: populate the cache
            S_c = cache["k"].shape[1]
            if window and S_c < S:
                # keep the last S_c positions; ring layout slot = pos % S_c
                shift = S % S_c
                cache["k"].copy_(torch.roll(k[:, -S_c:], shift, dims=1))
                cache["v"].copy_(torch.roll(v[:, -S_c:], shift, dims=1))
            else:
                cache["k"][:, :S] = k
                cache["k"][:, S:] = 0
                cache["v"][:, :S] = v
                cache["v"][:, S:] = 0
    delta = out.reshape(B, S, Hq * hd) @ p["wo"]
    return delta, cache
