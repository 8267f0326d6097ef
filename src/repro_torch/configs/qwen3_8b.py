"""Qwen3-8B: dense GQA decoder with qk-norm [hf:Qwen/Qwen3-8B].

36L d_model=4096 32H (GQA kv=8, head_dim=128) d_ff=12288 vocab=151936.
"""
from repro_torch.configs.base import ATTN, ArchConfig

CONFIG = ArchConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    layer_pattern=(ATTN,),
    qk_norm=True,
    rope_theta=1_000_000.0,
    long_context_window=8192,
    source="[hf:Qwen/Qwen3-8B]",
)
