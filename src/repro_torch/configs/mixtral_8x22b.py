"""Mixtral-8x22B: 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088].

56L d_model=6144 48H (GQA kv=8, head_dim=128) expert d_ff=16384
vocab=32768, a 4096-token window on every layer (per the assignment
bracket), no dense FFN, separate unembedding.
"""
from repro_torch.configs.base import ATTN_SWA, ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=32768,
    layer_pattern=(ATTN_SWA,),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=16384, n_shared_experts=0,
                  capacity_factor=1.25, sharding="tensor"),
    sliding_window=4096,
    rope_theta=1_000_000.0,
    source="[arXiv:2401.04088]",
)
