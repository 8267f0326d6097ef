"""Serving engine: batched prefill + one-token decode over the decoder LM.

Prefill attention runs through the flash attention kernel, the mamba mixer's
scan through the selective-scan kernel and the RG-LRU mixer's through the
RG-LRU scan kernel; decode attends one new token against the KV cache, or
steps the recurrent state. The cache (`models/lm.py::init_cache`) is written
in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.lm import forward, init_cache, layer_views


def _decode_positions(cfg: ArchConfig, batch: int, pos: int, device):
    """The one new token's positions: (B,1) at `pos`, tiled to (B,1,3) under
    M-RoPE (`repro/serve/engine.py::_decode_positions`)."""
    p = torch.full((batch, 1), pos, dtype=torch.int32, device=device)
    return p[..., None].expand(batch, 1, 3) if cfg.rope_type == "mrope" else p


def make_prefill_fn(cfg: ArchConfig, *, cache_len: int,
                    window_override: int = 0):
    """prefill(params, tokens, prefix_embeds=None, positions=None) ->
    {"logits_last" (B,V), "cache"}. The cache holds `cache_len` positions;
    the prefix and the prompt fill the first P + S slots."""
    def prefill(params, tokens, prefix_embeds=None, positions=None):
        cache = init_cache(cfg, tokens.shape[0], cache_len, device=tokens.device,
                           window_override=window_override)
        out = forward(params, tokens, cfg, prefix_embeds=prefix_embeds,
                      positions=positions, cache=cache,
                      window_override=window_override)
        return {"logits_last": out["logits"][:, -1], "cache": out["cache"]}

    return prefill


def make_decode_fn(cfg: ArchConfig, *, window_override: int = 0):
    """serve_step(params, cache, token (B,1), pos int) -> {"logits" (B,V),
    "cache"}: exactly one new token at absolute position `pos`. The
    per-layer views of params and cache are built once per (params, cache)
    pair, not per token."""
    held = {"pair": (None, None)}  # the last (params, cache) and its views

    def serve_step(params, cache, token, pos: int):
        p, c = held["pair"]
        if p is not params or c is not cache:
            held.update(pair=(params, cache), layers=layer_views(cfg, params, cache))
        positions = _decode_positions(cfg, token.shape[0], pos, token.device)
        out = forward(params, token, cfg, positions=positions, cache=cache,
                      pos=pos, window_override=window_override,
                      layers=held["layers"])
        return {"logits": out["logits"][:, -1], "cache": out["cache"]}

    return serve_step


@dataclass
class Engine:
    """Minimal batched generation engine (greedy / temperature sampling).
    Runs on CUDA unless `device="cpu"`; params must already be there."""
    cfg: ArchConfig
    params: dict
    max_len: int = 256
    window_override: int = 0
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        tok = self.params["embed"]["tok"]
        if tok.device.type != self.device.type:
            raise ValueError(f"Engine on {self.device}, params on {tok.device}")
        self._prefill = make_prefill_fn(self.cfg, cache_len=self.max_len,
                                        window_override=self.window_override)
        self._decode = make_decode_fn(self.cfg,
                                      window_override=self.window_override)

    @torch.inference_mode()
    def generate(self, prompts: torch.Tensor, max_new_tokens: int, *,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 prefix_embeds: Optional[torch.Tensor] = None):
        """prompts (B, S_prompt) int -> (B, max_new_tokens) int32, as the
        reference engine returns. prefix_embeds (B, P, D): stub frontend
        embeddings spliced before the prompt; they take the first P cache
        slots and positions."""
        for name, t in (("prompts", prompts), ("prefix_embeds", prefix_embeds)):
            if t is not None and t.device.type != self.device.type:
                raise ValueError(f"{name} on {t.device}, Engine on {self.device}")
        S = prompts.shape[1]
        prefix = 0 if prefix_embeds is None else prefix_embeds.shape[1]
        if not self.window_override and prefix + S + max_new_tokens - 1 > self.max_len:
            raise ValueError(f"prefix {prefix} + prompt {S} + {max_new_tokens} new tokens "
                             f"exceed max_len {self.max_len}")
        state = self._prefill(self.params, prompts, prefix_embeds=prefix_embeds)
        cache, logits = state["cache"], state["logits_last"]
        pos = S + prefix  # next absolute position
        outs = []
        for t in range(max_new_tokens):
            if temperature > 0.0:
                probs = torch.softmax(logits.float() / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=generator)
            else:
                nxt = torch.argmax(logits, dim=-1, keepdim=True)
            outs.append(nxt)
            if t == max_new_tokens - 1:
                break
            step = self._decode(self.params, cache, nxt, pos)
            logits, cache = step["logits"], step["cache"]
            pos += 1
        return torch.cat(outs, dim=1).to(torch.int32)
