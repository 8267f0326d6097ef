"""Rotary position embeddings (rotate-half layout): standard 1-D RoPE and
Qwen2-VL style M-RoPE."""
from __future__ import annotations

import torch


def _rot(x, sin, cos):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rope_freqs(head_dim, theta, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(q, k, positions, theta):
    """q (B,S,Hq,D), k (B,S,Hk,D), positions (B,S) int. Angles in f32."""
    freqs = rope_freqs(q.shape[-1], theta, device=q.device)
    ang = positions[..., None].float() * freqs  # (B,S,half)
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    return (_rot(q.float(), sin, cos).to(q.dtype),
            _rot(k.float(), sin, cos).to(k.dtype))


def mrope_sections(head_dim):
    """Split of the rotary pairs into (temporal, height, width) sections."""
    half = head_dim // 2
    h = half // 4
    return (half - 2 * h, h, h)


def apply_mrope(q, k, positions, theta):
    """M-RoPE: positions (B,S,3) int, (t, h, w) per token. The rotary pairs
    are split into three sections, each rotated by its own position stream
    [arXiv:2409.12191]. Angles in f32."""
    freqs = rope_freqs(q.shape[-1], theta, device=q.device)
    sec_id = torch.cat([torch.full((n,), i, dtype=torch.long, device=q.device)
                        for i, n in enumerate(mrope_sections(q.shape[-1]))])
    ang = positions[..., sec_id].float() * freqs  # (B,S,half)
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    return (_rot(q.float(), sin, cos).to(q.dtype),
            _rot(k.float(), sin, cos).to(k.dtype))
