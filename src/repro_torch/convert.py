"""Trees of the JAX package (numpy leaves, e.g. `jax.tree.map(np.asarray,
params)`) -> the port's trees of tensors, leaf to leaf.

The port's LM keeps the JAX package's tree: {"embed": {"tok"}, "blocks":
[one dict per pattern slot, leaves stacked over repeats on axis 0], "rem":
[unstacked remainder layers], "final_norm": {"scale"}, optionally "unembed":
{"w"}}, weights in the (in, out) layout. So every leaf maps to a tensor of
the same shape and dtype at the same path, whatever the tree (a DASO carry
with its leading replica axis, an optimizer state). An MoE block's leaves
("moe": {"router", "we1", "we3", "we2", optionally "shared"}, "moe_norm")
come across the same way: the router stays f32 beside bf16 experts. So do a
qk-norm config's per-layer "q_norm" / "k_norm" scales (head_dim,) in
"attn", which `init_attn` adds as the reference's does. bf16 leaves arrive as
numpy arrays of the ml_dtypes bfloat16 type, which torch cannot read; they go
through f32, which is exact both ways.

The port's ResNet keeps the reference's tree too (`models/cnn.py`: "stem",
"stage{i}" lists of block dicts, "head"; HWIO convolution weights), and so
do its batch-norm statistics.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device):
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(a).to(device)


def state_from_jax(tree, device="cpu"):
    """Any JAX tree of dicts, lists and tuples -> the same tree of tensors
    on `device`."""
    if isinstance(tree, dict):
        return {k: state_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(state_from_jax(v, device) for v in tree)
    return _tensor(tree, device)


def params_from_jax(tree, device="cpu"):
    """JAX LM params -> the port's LM params on `device`, leaf to leaf."""
    missing = {"embed", "blocks", "rem", "final_norm"} - set(tree)
    if missing:
        raise ValueError(f"params_from_jax: not an LM params tree, missing {sorted(missing)}")
    return state_from_jax(tree, device)


def cnn_params_from_jax(tree, device="cpu"):
    """JAX ResNet params -> the port's on `device`, leaf to leaf: the
    network's tree (`init_resnet`'s params) or `{"net": tree}` as
    `make_resnet_loss` reads it, with or without a leading replica axis on
    every leaf (a DASO carry's params)."""
    net = tree["net"] if set(tree) == {"net"} else tree
    missing = {"stem", "head", "stage0"} - set(net)
    extra = {k for k in net if k not in ("stem", "head") and not k.startswith("stage")}
    if missing or extra:
        raise ValueError(f"cnn_params_from_jax: not a ResNet params tree, missing "
                         f"{sorted(missing)}, unexpected {sorted(extra)}")
    return state_from_jax(tree, device)
