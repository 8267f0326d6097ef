"""Mixture-of-Experts FFN with GShard-style dispatch-mask routing
(`repro/models/moe.py`).

Tokens are routed in groups: capacity is per group, so the one-hot
dispatch / combine tensors stay (B, S, E, C) per group. The four einsums
(dispatch, the experts' SwiGLU, combine) run as batched matmuls; the
reference computes them outside any Pallas kernel, so this module adds no
kernel. Aux losses: the Switch load-balance loss and the router z-loss,
and the fraction of (token, slot) pairs dropped for capacity.

The parameter tree is the reference's: `router` (D, E) always f32, `we1`,
`we3` (E, D, F) and `we2` (E, F, D) in the param dtype, and with shared
experts `shared` {"w1", "w3" (D, Fs), "w2" (Fs, D)}, Fs = d_ff x
n_shared_experts. As in the reference, `dense_init` takes the fan-in from
axis 0, the expert axis, for the expert weights.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, silu_mlp


def init_moe(generator, cfg, dtype, device):
    m = cfg.moe
    D, Fe, E = cfg.d_model, m.d_ff, m.n_experts
    out_scale = 1.0 / (2 * cfg.n_layers) ** 0.5
    p = {
        "router": dense_init(generator, (D, E), torch.float32, device),
        "we1": dense_init(generator, (E, D, Fe), dtype, device),
        "we3": dense_init(generator, (E, D, Fe), dtype, device),
        "we2": dense_init(generator, (E, Fe, D), dtype, device, scale=out_scale),
    }
    if m.n_shared_experts:
        Fs = m.d_ff * m.n_shared_experts
        p["shared"] = {
            "w1": dense_init(generator, (D, Fs), dtype, device),
            "w3": dense_init(generator, (D, Fs), dtype, device),
            "w2": dense_init(generator, (Fs, D), dtype, device, scale=out_scale),
        }
    return p


def moe_apply(p, x, cfg):
    """x (B, S, D) -> (out (B, S, D), aux dict of scalar losses).

    The sequence is cut into groups of `moe.group_size` tokens only when it
    is longer than one group and a whole number of them; otherwise each row
    is one group."""
    B0, S0, D = x.shape
    G = cfg.moe.group_size
    if S0 > G and S0 % G == 0:
        x = x.reshape(B0 * (S0 // G), G, D)
    out, aux = _moe_grouped(p, x, cfg)
    if out.shape[:2] != (B0, S0):
        out = out.reshape(B0, S0, D)
    return out, aux


def top_k_lowest_index_first(probs, k: int):
    """(values, indices) of the k largest along the last axis, equal values
    in increasing index order, as `jax.lax.top_k` orders them
    (`torch.topk` gives no such order for ties, on the CPU or the card)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx, n: int):
    """f32 one-hot of integer indices in [0, n) (`F.one_hot` checks the
    range on the host, which waits for the card at every call)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _moe_grouped(p, x, cfg):
    """One routing group per row of x (B, S, D)."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.n_experts, m.top_k
    C = max(1, int(S * K * m.capacity_factor / E))

    logits = x.float() @ p["router"]                       # (B, S, E) f32
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k_lowest_index_first(probs, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)

    # capacity assignment per group, slot-major: every token's slot 0 is
    # placed before any slot 1, and the counts carry across slots. combine
    # holds disjoint one-hot slots weighted by gates in [0, 1], in the
    # compute dtype as the reference builds it.
    combine = torch.zeros((B, S, E, C), dtype=x.dtype, device=x.device)
    counts = torch.zeros((B, E), dtype=torch.float32, device=x.device)
    slots = torch.arange(C, dtype=torch.float32, device=x.device)
    for slot in range(K):
        oh = _one_hot(gate_idx[:, :, slot], E)               # (B, S, E) f32
        pos = torch.cumsum(oh, dim=1) - 1 + counts[:, None]
        in_cap = ((pos < C) * oh).to(x.dtype)
        # the one-hot of the clipped position (integers in f32, exact)
        pos_oh = (pos.clamp(0, C - 1)[..., None] == slots).to(x.dtype)
        combine = combine + (gate_vals[:, :, slot, None, None].to(x.dtype)
                             * in_cap[..., None] * pos_oh)
        counts = counts + oh.sum(dim=1)

    dispatch = (combine > 0).to(x.dtype)                   # (B, S, E, C)
    expert_in = torch.einsum("bsec,bsd->ebcd", dispatch, x)
    h = F.silu(torch.einsum("ebcd,edf->ebcf", expert_in, p["we1"]))
    h = h * torch.einsum("ebcd,edf->ebcf", expert_in, p["we3"])
    expert_out = torch.einsum("ebcf,efd->ebcd", h, p["we2"])
    out = torch.einsum("bsec,ebcd->bsd", combine, expert_out)

    if "shared" in p:
        sh = p["shared"]
        out = out + silu_mlp(x, sh["w1"], sh["w3"], sh["w2"])

    # aux losses (Switch / GShard)
    me = probs.mean(dim=(0, 1))                            # mean router prob
    top1 = _one_hot(gate_idx[:, :, 0], E).mean(dim=(0, 1))
    lb_loss = E * torch.sum(me * top1) * m.load_balance_loss
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * m.router_z_loss
    dropped = 1.0 - dispatch.sum() / (B * S * K)
    aux = {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss, "moe_drop_frac": dropped}
    return out, aux
