"""Shared building blocks: norms, initializers, activations, positions."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x, scale, eps=1e-6):
    """RMS norm in f32, scaled by (1 + scale): norm scales start at zero."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def head_rms_norm(x, scale, eps=1e-6):
    """qk-norm: RMS over the head_dim of (B, S, H, D) tensors, in f32, times
    (1 + scale), cast back (`repro/models/common.py::head_rms_norm`, the
    same function as `rms_norm` over the last axis)."""
    return rms_norm(x, scale, eps)


def _trunc_normal(shape, std, dtype, device, generator):
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * std).to(dtype)


def dense_init(generator, shape, dtype, device, scale=None, axis=0):
    """Standard normal truncated at +-2, times scale / sqrt(fan_in)."""
    std = (1.0 if scale is None else scale) / shape[axis] ** 0.5
    return _trunc_normal(shape, std, dtype, device, generator)


def embed_init(generator, shape, dtype, device):
    return _trunc_normal(shape, 0.02, dtype, device, generator)


def sinusoidal_positions(positions, dim, max_wavelength=10000.0):
    """positions (...,) int -> (..., dim) f32 sinusoidal embedding
    (`repro/models/common.py::sinusoidal_positions`)."""
    half = dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freq = torch.exp(-math.log(max_wavelength) * idx / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def silu_mlp(x, w1, w3, w2):
    """SwiGLU FFN. x (..., D); w1,w3 (D,F); w2 (F,D)."""
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def cross_entropy_loss(logits, labels):
    """Mean token cross-entropy in f32; labels == -1 are ignored
    (`repro/models/common.py::cross_entropy_loss`, whose one-hot
    contraction picks the same logit as this gather)."""
    valid = labels >= 0
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = torch.where(valid, lse - tgt, torch.zeros_like(lse))
    return nll.sum() / valid.sum().clamp(min=1)
