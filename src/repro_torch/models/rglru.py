"""RG-LRU recurrent mixer (RecurrentGemma / Griffin, arXiv:2402.19427),
`repro/models/rglru.py`.

r_t = sigmoid(W_a x_t + b_a), i_t = sigmoid(W_i x_t + b_i),
log a_t = -c * softplus(Lambda) * r_t,
h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t).

Prefill and training scan the recurrence through K8 (`models/mamba.py::
linear_recurrence`; under autograd the backward is K8-bwd); one-token
decode steps the state in plain PyTorch, as the reference does. The decode cache {"conv", "h"} is written in place.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init
from repro_torch.models.mamba import causal_conv1d, linear_recurrence


def init_rglru(generator, cfg, dtype, device):
    g = cfg.rglru
    D, W = cfg.d_model, cfg.lru_width
    # Lambda so that a = exp(-c * softplus(Lambda)) lies in [0.9, 0.999]
    u = 0.9 + 0.099 * torch.rand((W,), dtype=torch.float32, device=device,
                                 generator=generator)
    lam = torch.log(torch.expm1(-torch.log(u) / g.c_exponent))
    return {
        "norm": torch.zeros((D,), dtype=dtype, device=device),
        "wx": dense_init(generator, (D, W), dtype, device),
        "wy": dense_init(generator, (D, W), dtype, device),
        "conv1d_w": dense_init(generator, (W, g.conv_width), dtype, device,
                               scale=1.0, axis=1),
        "conv1d_b": torch.zeros((W,), dtype=dtype, device=device),
        "w_a": dense_init(generator, (W, W), torch.float32, device),
        "b_a": torch.zeros((W,), dtype=torch.float32, device=device),
        "w_i": dense_init(generator, (W, W), torch.float32, device),
        "b_i": torch.zeros((W,), dtype=torch.float32, device=device),
        "a_param": lam,
        "wo_rec": dense_init(generator, (W, D), dtype, device,
                             scale=1.0 / (2 * cfg.n_layers) ** 0.5),
    }


def init_rglru_cache(cfg, batch, dtype, device):
    g = cfg.rglru
    return {"conv": torch.zeros((batch, g.conv_width - 1, cfg.lru_width),
                                dtype=dtype, device=device),
            "h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                             device=device)}


def _gate(xb, w, b):
    """sigmoid(xb @ w + b): the product in xb's (compute) dtype, as the
    reference runs it, the sigmoid in f32."""
    return torch.sigmoid((xb @ w.to(xb.dtype) + b.to(xb.dtype)).float())


def rglru_apply(p, x, cfg, *, cache: Optional[dict] = None):
    """Pre-normed recurrent mixer body (the caller applies the norm). x
    (B,S,D). Returns (delta (B,S,D), cache), the cache tensors written in
    place."""
    g = cfg.rglru
    B, S, D = x.shape
    y_branch = F.gelu(x @ p["wy"], approximate="tanh")  # jax.nn.gelu's default
    xb = x @ p["wx"]
    conv_carry = cache["conv"] if cache is not None else None
    xb, new_conv = causal_conv1d(xb, p["conv1d_w"], p["conv1d_b"], conv_carry)

    r = _gate(xb, p["w_a"], p["b_a"])
    i = _gate(xb, p["w_i"], p["b_i"])
    xf = xb.float()
    log_a = -g.c_exponent * F.softplus(p["a_param"]) * r  # (B,S,W) f32
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * xf)

    h0 = (cache["h"] if cache is not None
          else torch.zeros((B, xb.shape[-1]), dtype=torch.float32, device=x.device))
    if S == 1:  # decode: one step, no scan
        h = a[:, 0] * h0 + gated[:, 0]
        hs = h[:, None]
    else:
        hs, h = linear_recurrence(a, gated, h0)
    out = (hs.to(x.dtype) * y_branch) @ p["wo_rec"]
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(h)
    return out, cache
