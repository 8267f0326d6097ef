"""Minitron-8B: pruned Nemotron-4 [arXiv:2407.14679].

32L d_model=4096 32H (GQA kv=8, head_dim=128) d_ff=16384 vocab=256000.
"""
from repro_torch.configs.base import ATTN, ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    layer_pattern=(ATTN,),
    rope_theta=10_000.0,
    long_context_window=8192,
    source="[arXiv:2407.14679]",
)
