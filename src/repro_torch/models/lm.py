"""Decoder LM of the port: token embedding (plus sinusoidal positions when
the config has no rotary ones), a stack of blocks following
cfg.layer_pattern, final RMS norm, tied or separate unembedding.

Parameters and caches have the JAX package's tree (`repro/models/lm.py`):
the n_layers // len(pattern) full repeats of the pattern are stacked per
pattern slot ("blocks" / "groups": one dict per slot, every leaf (n_full,
...)), the n_layers % len(pattern) remainder layers are kept apart
("rem"). Weights keep the (in, out) layout. A layer sees views `leaf[r]` of
the stacked leaves; caches are written in place through them.

Entry points:
  init_params(cfg, generator, device)           -> params dict
  init_cache(cfg, batch, cache_len, device=...) -> {"groups", "rem"}
  layer_views(cfg, params, cache=None)          -> per-layer views, in order
  forward(params, tokens, cfg, ...)             -> {"logits", "aux", "cache"}
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.blocks import (ZERO_AUX, apply_block, block_window,
                                       init_block, init_block_cache)
from repro_torch.models.common import (dense_init, embed_init, rms_norm,
                                       sinusoidal_positions)
from repro_torch.tree import tree_map


def _pattern_counts(cfg: ArchConfig):
    plen = len(cfg.layer_pattern)
    return cfg.n_layers // plen, cfg.n_layers % plen


def _fill_stacked(stacked, block, n_full, r):
    """Copy one repeat's block into slice r of its slot's stacked leaves,
    allocating them at r == 0. Returns the stacked tree."""
    if stacked is None:
        stacked = tree_map(lambda x: x.new_empty((n_full,) + x.shape), block)
    tree_map(lambda buf, x: buf[r].copy_(x), stacked, block)
    return stacked


def init_params(cfg: ArchConfig, generator: torch.Generator, device):
    """Seeded init: truncated normals scaled as in the JAX package, norm
    scales at zero. `generator` must live on `device`. Layers are drawn in
    depth order; each stacked leaf is allocated once and filled repeat by
    repeat, so no more than one layer's weights exist twice."""
    dtype = cfg.param_dtype
    n_full, n_rem = _pattern_counts(cfg)
    pat = cfg.layer_pattern
    params = {"embed": {"tok": embed_init(generator, (cfg.vocab_size, cfg.d_model),
                                          dtype, device)}}
    blocks = [None] * len(pat) if n_full else []
    for r in range(n_full):
        for j, kind in enumerate(pat):
            blocks[j] = _fill_stacked(blocks[j], init_block(generator, cfg, kind, dtype,
                                                            device), n_full, r)
    params["blocks"] = blocks
    params["rem"] = [init_block(generator, cfg, pat[j], dtype, device)
                     for j in range(n_rem)]
    params["final_norm"] = {"scale": torch.zeros((cfg.d_model,), dtype=dtype,
                                                 device=device)}
    if not cfg.tie_embeddings:
        params["unembed"] = {"w": dense_init(generator, (cfg.d_model, cfg.vocab_size),
                                             dtype, device)}
    return params


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *, device,
               dtype=None, window_override: int = 0):
    """Decode cache {"groups": [stacked per pattern slot], "rem": [...]}.
    cache_len: positions held by full-attention layers; windowed layers hold
    min(window, cache_len); mamba and RG-LRU layers hold their conv window
    and state."""
    dtype = dtype or cfg.compute_dtype
    n_full, n_rem = _pattern_counts(cfg)

    def one(kind):
        win = block_window(cfg, kind, window_override)
        clen = min(win, cache_len) if win else cache_len
        return init_block_cache(cfg, kind, batch, clen, dtype, device)

    groups = [tree_map(lambda x: x.new_zeros((n_full,) + x.shape), one(kind))
              for kind in cfg.layer_pattern] if n_full else []
    return {"groups": groups,
            "rem": [one(cfg.layer_pattern[j]) for j in range(n_rem)]}


def _unstack(tree, n):
    """A tree of stacked leaves -> n trees of views, leaf[r] (`unbind`:
    autograd then takes one stacking backward per leaf)."""
    if isinstance(tree, dict):
        subs = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[r] for k, v in subs.items()} for r in range(n)]
    return list(tree.unbind(0))


def layer_views(cfg: ArchConfig, params, cache=None):
    """[(kind, block params, block cache or None)] in the reference's order:
    repeat r, then pattern slot j, then the remainder layers. Build it once
    per params / cache pair and pass it to `forward`."""
    n_full, n_rem = _pattern_counts(cfg)
    pat = cfg.layer_pattern
    p_rows = [_unstack(b, n_full) for b in params["blocks"]]
    c_rows = None if cache is None else [_unstack(g, n_full) for g in cache["groups"]]
    out = [(kind, p_rows[j][r], None if cache is None else c_rows[j][r])
           for r in range(n_full) for j, kind in enumerate(pat)]
    out += [(pat[j], params["rem"][j], None if cache is None else cache["rem"][j])
            for j in range(n_rem)]
    return out


def _acc_aux(acc, aux):
    """The reference's running sum of the layers' aux (`_acc_aux` from f32
    zeros). A block without MoE gives Python zeros, which add nothing and
    launch nothing; the first tensor term starts the f32 sum (0 + a is a,
    exactly), so the sum is the reference's term for term."""
    if aux is ZERO_AUX:
        return acc
    if acc is None:
        return {k: v.float() for k, v in aux.items()}
    return {k: acc[k] + aux[k] for k in acc}


_ZEROS = {}


def _zero_aux(device):
    """The aux of a model without MoE: f32 zeros, one 0-d tensor per device
    made once and shared (read only), so a dense forward, each decode step
    among them, launches nothing for an aux the Engine never reads."""
    zero = _ZEROS.get(device)
    if zero is None:
        with torch.inference_mode(False):
            zero = _ZEROS[device] = torch.zeros((), dtype=torch.float32, device=device)
    return dict.fromkeys(ZERO_AUX, zero)


def forward(params, tokens, cfg: ArchConfig, *,
            prefix_embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            cache: Optional[dict] = None, pos: Optional[int] = None,
            window_override: int = 0, attn_impl: str = "kernel",
            layers: Optional[list] = None):
    """tokens (B, S_tok) int. Returns {"logits" (B,S,V), "aux", "cache"}; aux
    sums each MoE layer's losses and drop fraction over the layers (shared
    f32 zeros for a model without MoE, `_zero_aux`).

    prefix_embeds (B, P, D): the vlm / audio frontends' stub embeddings,
    spliced before the token embeddings, so S = P + S_tok and the logits
    cover the spliced length. positions: (B,S), or (B,S,3) under M-RoPE;
    by default arange(S) for every row, tiled to the three streams under
    M-RoPE. Under rope_type "none" the sinusoidal positions take stream 0
    of 3-D positions.

    Prefill: cache from `init_cache`, filled in place. Decode: tokens (B,1),
    cache and pos (absolute position of the token) given. `layers`:
    `layer_views(cfg, params, cache)`, when the caller keeps it across
    calls (decode).
    """
    x = params["embed"]["tok"][tokens]
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    B, S, D = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
        if cfg.rope_type == "mrope":
            positions = positions[..., None].expand(B, S, 3)
    if cfg.rope_type == "none":
        pos1 = positions if positions.dim() == 2 else positions[..., 0]
        x = x + sinusoidal_positions(pos1, D).to(x.dtype)
    if layers is None:
        layers = layer_views(cfg, params, cache)
    aux = None
    for kind, p, c in layers:
        x, _, a = apply_block(kind, p, x, positions, cfg, cache=c, pos=pos,
                              window_override=window_override, attn_impl=attn_impl)
        aux = _acc_aux(aux, a)
    if aux is None:
        aux = _zero_aux(x.device)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["tok"].T
    else:
        logits = x @ params["unembed"]["w"]
    return {"logits": logits, "aux": aux, "cache": cache}
