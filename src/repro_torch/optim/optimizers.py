"""Pure-function optimizers in the functional init / update form of
`repro/optim/optimizers.py`: `update(grads, state, params, lr) ->
(new_params, new_state)` on trees of tensors, new tensors out, nothing
given updated in place (an update writes into its own temporaries, so a
leaf's outputs need at most one temporary beside them). The paper's
node-local optimizer is SGD with momentum 0.9 and weight decay 1e-4;
DASO wraps whichever it is given."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.tree import flatten, leaves, tree_map, unflatten


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, opt_state, params, lr) -> (new_params, new_state)


def _zeros_f32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def sgd(momentum: float = 0.9, weight_decay: float = 1e-4,
        nesterov: bool = False) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {}
        return {"mu": tree_map(_zeros_f32, params)}

    def update(grads, state, params, lr):
        gs, treedef = flatten(grads)
        mus = leaves(state["mu"]) if momentum else [None] * len(gs)
        new_p, new_mu = [], []
        for g, p, mu in zip(gs, leaves(params), mus):
            # each line rounds as g + wd * p, momentum * mu + g, g + momentum
            # * mu and p - lr * g do (a product, then a sum), in place in
            # the product: IEEE sums commute, and p + (-lr) * g is p - lr * g
            g = g.float()
            if weight_decay:
                g = torch.mul(p.float(), weight_decay).add_(g)
            if momentum:
                mu = torch.mul(mu, momentum).add_(g)
                g = torch.mul(mu, momentum).add_(g) if nesterov else mu
            new_p.append(torch.mul(g, -lr).add_(p.float()).to(p.dtype))
            new_mu.append(mu)
        if not momentum:
            return unflatten(treedef, new_p), state
        return unflatten(treedef, new_p), {"mu": unflatten(treedef, new_mu)}

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        p0 = leaves(params)[0]
        return {"m": tree_map(_zeros_f32, params), "v": tree_map(_zeros_f32, params),
                "t": torch.zeros((), dtype=torch.int32, device=p0.device)}

    def update(grads, state, params, lr):
        t = state["t"] + 1
        c1 = 1.0 - b1 ** t.float()
        c2 = 1.0 - b2 ** t.float()
        gs, treedef = flatten(grads)
        new_p, new_m, new_v = [], [], []
        for g, p, m, v in zip(gs, leaves(params), leaves(state["m"]),
                              leaves(state["v"])):
            g = g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            upd = (m / c1) / (torch.sqrt(v / c2) + eps)
            p32 = p.float()
            p32 = p32 - lr * (upd + weight_decay * p32)
            new_p.append(p32.to(p.dtype))
            new_m.append(m)
            new_v.append(v)
        return (unflatten(treedef, new_p),
                {"m": unflatten(treedef, new_m), "v": unflatten(treedef, new_v),
                 "t": t})

    return Optimizer(init, update)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    n = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), n
