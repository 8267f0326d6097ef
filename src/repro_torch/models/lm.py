"""Decoder LM of the port: token embedding, a stack of attention + SwiGLU
blocks following cfg.layer_pattern, final RMS norm, tied or separate
unembedding.

Parameters are a plain dict of tensors in the JAX package's (in, out)
weight layout, with one entry per layer in "layers" (the JAX package stacks
repeated layers on a leading axis; `convert.params_from_jax` unstacks it).

Entry points:
  init_params(cfg, generator, device)           -> params dict
  forward(params, tokens, cfg, ...)             -> {"logits", "cache"}
  init_cache(cfg, batch, cache_len, device=...) -> decode cache
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.blocks import (apply_block, block_window, init_block,
                                       init_block_cache)
from repro_torch.models.common import dense_init, embed_init, rms_norm


def layer_kind(cfg: ArchConfig, i: int) -> str:
    return cfg.layer_pattern[i % len(cfg.layer_pattern)]


def init_params(cfg: ArchConfig, generator: torch.Generator, device):
    """Seeded init: truncated normals scaled as in the JAX package, norm
    scales at zero. `generator` must live on `device`."""
    dtype = cfg.param_dtype
    params = {"embed": {"tok": embed_init(generator, (cfg.vocab_size, cfg.d_model),
                                          dtype, device)},
              "layers": [init_block(generator, cfg, layer_kind(cfg, i), dtype, device)
                         for i in range(cfg.n_layers)],
              "final_norm": {"scale": torch.zeros((cfg.d_model,), dtype=dtype,
                                                  device=device)}}
    if not cfg.tie_embeddings:
        params["unembed"] = {"w": dense_init(generator, (cfg.d_model, cfg.vocab_size),
                                             dtype, device)}
    return params


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *, device,
               dtype=None, window_override: int = 0):
    """Decode cache, one {"k", "v"} per layer. cache_len: positions held by
    full-attention layers; windowed layers hold min(window, cache_len)."""
    dtype = dtype or cfg.compute_dtype
    caches = []
    for i in range(cfg.n_layers):
        kind = layer_kind(cfg, i)
        win = block_window(cfg, kind, window_override)
        clen = min(win, cache_len) if win else cache_len
        caches.append(init_block_cache(cfg, kind, batch, clen, dtype, device))
    return caches


def forward(params, tokens, cfg: ArchConfig, *,
            positions: Optional[torch.Tensor] = None,
            cache: Optional[list] = None, pos: Optional[int] = None,
            window_override: int = 0, attn_impl: str = "kernel"):
    """tokens (B, S) int. Returns {"logits" (B,S,V), "cache"}.

    Prefill: cache from `init_cache`, filled in place. Decode: tokens (B,1),
    cache and pos (absolute position of the token) given.
    """
    x = params["embed"]["tok"][tokens]
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    for i, p in enumerate(params["layers"]):
        x, _ = apply_block(layer_kind(cfg, i), p, x, positions, cfg,
                           cache=None if cache is None else cache[i], pos=pos,
                           window_override=window_override, attn_impl=attn_impl)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["tok"].T
    else:
        logits = x @ params["unembed"]["w"]
    return {"logits": logits, "cache": cache}
