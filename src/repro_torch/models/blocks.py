"""Residual block assembly: mixer (attention / mamba / RG-LRU) + FFN (dense
SwiGLU or mixture of experts)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import (ATTENTION_KINDS, ATTN, ATTN_LOCAL, ATTN_SWA,
                                      MAMBA, RECURRENT_KINDS, RGLRU)
from repro_torch.models.attention import attn_apply, init_attn
from repro_torch.models.common import dense_init, rms_norm, silu_mlp
from repro_torch.models.mamba import init_mamba, init_mamba_cache, mamba_apply
from repro_torch.models.moe import init_moe, moe_apply
from repro_torch.models.rglru import init_rglru, init_rglru_cache, rglru_apply

ZERO_AUX = {"moe_lb_loss": 0.0, "moe_z_loss": 0.0, "moe_drop_frac": 0.0}


def _init_ffn(generator, cfg, dtype, device):
    D, F = cfg.d_model, cfg.d_ff
    return {
        "norm": torch.zeros((D,), dtype=dtype, device=device),
        "w1": dense_init(generator, (D, F), dtype, device),
        "w3": dense_init(generator, (D, F), dtype, device),
        "w2": dense_init(generator, (F, D), dtype, device,
                         scale=1.0 / (2 * cfg.n_layers) ** 0.5),
    }


def _check_kind(kind):
    if kind not in ATTENTION_KINDS + RECURRENT_KINDS:
        raise ValueError(f"unknown layer kind {kind!r}")


def _has_ffn(cfg, kind) -> bool:
    """A dense FFN or, when the config has one, the MoE (whose configs set
    d_ff = 0)."""
    return kind != MAMBA and (cfg.d_ff > 0 or cfg.moe is not None)


def init_block(generator, cfg, kind, dtype, device):
    _check_kind(kind)
    if kind == MAMBA:
        p = {"mamba": init_mamba(generator, cfg, dtype, device)}
    elif kind == RGLRU:
        p = {"rec": init_rglru(generator, cfg, dtype, device)}
    else:
        p = {"attn": init_attn(generator, cfg, dtype, device)}
    if _has_ffn(cfg, kind):
        if cfg.moe is not None:
            p["moe"] = init_moe(generator, cfg, dtype, device)
            p["moe_norm"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
        else:
            p["ffn"] = _init_ffn(generator, cfg, dtype, device)
    return p


def init_block_cache(cfg, kind, batch, cache_len, dtype, device):
    _check_kind(kind)
    if kind == MAMBA:
        return init_mamba_cache(cfg, batch, dtype, device)
    if kind == RGLRU:
        return init_rglru_cache(cfg, batch, dtype, device)
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def block_window(cfg, kind, window_override: int) -> int:
    """Effective attention window for this block kind (0 = unbounded)."""
    if kind in (ATTN_SWA, ATTN_LOCAL):
        return cfg.sliding_window
    if kind == ATTN and window_override:
        return window_override
    return 0


def apply_block(kind, p, x, positions, cfg, *, cache: Optional[dict] = None,
                pos: Optional[int] = None, window_override: int = 0,
                attn_impl: str = "kernel"):
    """x (B,S,D) -> (x, cache, aux); the cache tensors are written in place.
    aux: the MoE's losses and drop fraction (tensors), `ZERO_AUX` (Python
    zeros, as the reference's) for a block without MoE."""
    _check_kind(kind)
    if kind == MAMBA:
        h = rms_norm(x, p["mamba"]["norm"], cfg.norm_eps)
        delta, cache = mamba_apply(p["mamba"], h, cfg, cache=cache)
    elif kind == RGLRU:
        h = rms_norm(x, p["rec"]["norm"], cfg.norm_eps)
        delta, cache = rglru_apply(p["rec"], h, cfg, cache=cache)
    else:
        delta, cache = attn_apply(p["attn"], x, positions, cfg,
                                  window=block_window(cfg, kind, window_override),
                                  cache=cache, pos=pos, impl=attn_impl)
    x = x + delta
    aux = ZERO_AUX
    if _has_ffn(cfg, kind):
        if cfg.moe is not None:
            h = rms_norm(x, p["moe_norm"], cfg.norm_eps)
            delta, aux = moe_apply(p["moe"], h, cfg)
            x = x + delta
        else:
            h = rms_norm(x, p["ffn"]["norm"], cfg.norm_eps)
            x = x + silu_mlp(h, p["ffn"]["w1"], p["ffn"]["w3"], p["ffn"]["w2"])
    return x, cache, aux
