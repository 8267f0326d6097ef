"""Parameters of the JAX package's decoder LM -> parameters of the port.

The JAX tree is {"embed": {"tok"}, "blocks": [one dict per pattern slot,
leaves stacked over repeats on axis 0], "rem": [unstacked remainder
layers], "final_norm": {"scale"}, optionally "unembed": {"w"}}, with
leaves given as numpy arrays (e.g. `jax.tree.map(np.asarray, params)`).
Weights keep the (in, out) layout. bf16 leaves arrive as numpy arrays of
the ml_dtypes bfloat16 type, which torch cannot read; they go through f32,
which is exact both ways.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device):
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(a).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree, device="cpu", *, batch_dims: int = 0):
    """JAX LM params (numpy leaves) -> the port's params dict on `device`.
    `batch_dims` leading axes stay on every leaf (1 for a DASO replicated
    tree, whose leaves are (R, ...); the stacked layer axis follows
    them)."""
    groups = tree["blocks"]
    plen = len(groups)
    n_full = np.shape(groups[0]["attn"]["wq"])[batch_dims] if plen else 0
    lead = (slice(None),) * batch_dims
    layers = [_map(groups[j], lambda a, r=r: _tensor(np.asarray(a)[lead + (r,)], device))
              for r in range(n_full) for j in range(plen)]
    layers += [_map(block, lambda a: _tensor(a, device)) for block in tree["rem"]]
    out = {"embed": _map(tree["embed"], lambda a: _tensor(a, device)),
           "layers": layers,
           "final_norm": _map(tree["final_norm"], lambda a: _tensor(a, device))}
    if "unembed" in tree:
        out["unembed"] = _map(tree["unembed"], lambda a: _tensor(a, device))
    return out


def state_from_jax(tree, device="cpu", *, batch_dims: int = 0):
    """Any JAX tree that holds LM params (a DASO carry, an optimizer state)
    -> the port's: each LM params subtree (a dict with "blocks") through
    `params_from_jax`, every other leaf as a tensor."""
    if isinstance(tree, dict) and "blocks" in tree:
        return params_from_jax(tree, device, batch_dims=batch_dims)
    if isinstance(tree, dict):
        return {k: state_from_jax(v, device, batch_dims=batch_dims)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(state_from_jax(v, device, batch_dims=batch_dims)
                          for v in tree)
    return _tensor(tree, device)
