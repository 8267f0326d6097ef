"""Mamba-1 selective SSM mixer (Falcon-Mamba style), `repro/models/mamba.py`.

Prefill and training run the selective scan through K7 (`kernels/ops.py::
ssm_scan`), which computes what the reference's chunked `associative_scan`
computes; under autograd its backward is K7-bwd. One-token decode takes
the reference's fast path in plain PyTorch. The decode cache {"conv", "h"}
is written in place. `linear_recurrence`, the diagonal recurrence the
RG-LRU mixer scans, runs through K8 (backward K8-bwd).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import dense_init


def init_mamba(generator, cfg, dtype, device):
    s = cfg.ssm
    D, Di, N, R = cfg.d_model, cfg.d_inner, s.d_state, cfg.dt_rank
    in_proj = dense_init(generator, (D, 2 * Di), dtype, device)
    conv_w = dense_init(generator, (Di, s.d_conv), dtype, device, scale=1.0, axis=1)
    x_proj = dense_init(generator, (Di, R + 2 * N), dtype, device)
    dt_proj = dense_init(generator, (R, Di), torch.float32, device)
    # dt bias so that softplus(dt_bias) spans [1e-3, 1e-1] (mamba paper)
    u = torch.rand((Di,), dtype=torch.float32, device=device, generator=generator)
    lo, hi = math.log(1e-3), math.log(0.1)
    dt_init = torch.exp(u * (hi - lo) + lo)
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))  # inverse softplus
    out_proj = dense_init(generator, (Di, D), dtype, device,
                          scale=1.0 / (2 * cfg.n_layers) ** 0.5)
    A = torch.arange(1, N + 1, dtype=torch.float32, device=device).expand(Di, N)
    return {
        "norm": torch.zeros((D,), dtype=dtype, device=device),
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((Di,), dtype=dtype, device=device),
        "x_proj": x_proj,
        "dt_proj": dt_proj,
        "dt_bias": dt_bias,
        "A_log": torch.log(A),
        "Dskip": torch.ones((Di,), dtype=torch.float32, device=device),
        "out_proj": out_proj,
    }


def init_mamba_cache(cfg, batch, dtype, device):
    s = cfg.ssm
    return {"conv": torch.zeros((batch, s.d_conv - 1, cfg.d_inner), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, cfg.d_inner, s.d_state), dtype=torch.float32,
                             device=device)}


def selective_scan(xh, dt, A, Bm, Cm, h0):
    """y_t = C_t . h_t with h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, through
    K7 on the card; under autograd (training's forward is this prefill path
    with grad enabled) the gradients of every input come from K7-bwd. xh
    (B,S,Di); dt (B,S,Di) f32; A (Di,N) f32; Bm, Cm (B,S,N); h0 (B,Di,N)
    f32. Returns (y (B,S,Di) in xh's dtype, h f32)."""
    y, h = ops.ssm_scan(xh, dt, A, Bm, Cm, h0)
    return y.to(xh.dtype), h


def linear_recurrence(da, db, h0):
    """Diagonal recurrence h_t = da_t * h_{t-1} + db_t along axis 1 of
    (B,S,W) tensors, through K8 on the card, and under autograd its
    gradients through K8-bwd (the reference computes it with a chunked
    associative scan and differentiates that). h0 (B,W) f32. Returns (hs
    (B,S,W) f32, h_final (B,W) f32): the reference's scan multiplies every
    step by the f32 state, so its hs is f32 whatever db's dtype (its
    docstring says db's)."""
    return ops.rglru_scan(da, db, h0)


def causal_conv1d(x, w, b, carry: Optional[torch.Tensor] = None):
    """Depthwise causal conv over seq. x (B,S,Di); w (Di,Kc); carry
    (B,Kc-1,Di) holds the previous Kc-1 inputs (decode). Returns (y,
    new_carry)."""
    B, S, Di = x.shape
    Kc = w.shape[1]
    if carry is None:
        carry = x.new_zeros((B, Kc - 1, Di))
    xp = torch.cat([carry, x], dim=1)                   # (B, S+Kc-1, Di)
    y = sum(xp[:, i:i + S] * w[:, i] for i in range(Kc)) + b
    new_carry = xp[:, -(Kc - 1):] if Kc > 1 else carry
    return y, new_carry


def mamba_apply(p, x, cfg, *, cache: Optional[dict] = None):
    """Pre-normed mamba mixer body (the caller applies the norm). x (B,S,D).
    Returns (delta (B,S,D), cache), the cache tensors written in place."""
    s = cfg.ssm
    B, S, D = x.shape
    Di, N, R = cfg.d_inner, s.d_state, cfg.dt_rank
    xh, z = (x @ p["in_proj"]).split(Di, dim=-1)        # (B,S,Di) each
    conv_carry = cache["conv"] if cache is not None else None
    xh, new_conv = causal_conv1d(xh, p["conv_w"], p["conv_b"], conv_carry)
    xh = F.silu(xh)

    proj = xh @ p["x_proj"]                             # (B,S,R+2N)
    dt, Bm, Cm = proj.split([R, N, N], dim=-1)
    dt = F.softplus(dt.float() @ p["dt_proj"] + p["dt_bias"])  # (B,S,Di) f32
    A = -torch.exp(p["A_log"])                          # (Di,N)

    h0 = (cache["h"] if cache is not None
          else torch.zeros((B, Di, N), dtype=torch.float32, device=x.device))
    if S == 1:  # decode fast path
        da = torch.exp(dt[:, 0, :, None] * A)
        db = ((dt[:, 0] * xh[:, 0].float())[..., None]
              * Bm[:, 0].float()[:, None, :])
        h = da * h0 + db
        y = torch.einsum("bdn,bn->bd", h, Cm[:, 0].float())[:, None]
    else:
        y, h = selective_scan(xh, dt, A, Bm, Cm, h0)
    y = y.float() + p["Dskip"] * xh.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    delta = y @ p["out_proj"]
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(h)
    return delta, cache
