"""Granite-3.0 MoE [hf:ibm-granite/granite-3.0-1b-a400m-base family].

32L d_model=1536 24H (GQA kv=8, head_dim=64) vocab=49155,
MoE 40 experts top-8, expert d_ff=512, no dense FFN, tied embeddings.
The JAX package's config follows the structured field (40 experts) where
the assignment's bracket says 32; the port copies its values.
"""
from repro_torch.configs.base import ATTN, ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=0,
    vocab_size=49155,
    layer_pattern=(ATTN,),
    moe=MoEConfig(n_experts=40, top_k=8, d_ff=512, n_shared_experts=0,
                  capacity_factor=1.25, sharding="tensor"),
    rope_theta=10_000.0,
    tie_embeddings=True,
    long_context_window=8192,
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base]",
)
