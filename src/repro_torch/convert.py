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


def params_from_jax(tree, device="cpu"):
    """JAX LM params (numpy leaves) -> the port's params dict on `device`."""
    groups = tree["blocks"]
    plen = len(groups)
    n_full = len(np.asarray(groups[0]["attn"]["wq"])) if plen else 0
    layers = [_map(groups[j], lambda a, r=r: _tensor(np.asarray(a)[r], device))
              for r in range(n_full) for j in range(plen)]
    layers += [_map(block, lambda a: _tensor(a, device)) for block in tree["rem"]]
    out = {"embed": _map(tree["embed"], lambda a: _tensor(a, device)),
           "layers": layers,
           "final_norm": _map(tree["final_norm"], lambda a: _tensor(a, device))}
    if "unembed" in tree:
        out["unembed"] = _map(tree["unembed"], lambda a: _tensor(a, device))
    return out
