"""Moonlight-16B-A3B (moonshot): DeepSeek-style fine-grained MoE
[hf:moonshotai/Moonlight-16B-A3B].

48L d_model=2048 16H (kv=16, head_dim=128) vocab=163840,
MoE: 64 experts, top-6, expert d_ff=1408, plus a shared-expert branch (2
shared experts of the same 1408 hidden, modelled as one dense branch of
2816), no dense FFN, separate unembedding.
"""
from repro_torch.configs.base import ATTN, ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="dense",  # the assignment labels it dense; structurally MoE
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,  # all FFN capacity lives in the MoE branch
    vocab_size=163840,
    layer_pattern=(ATTN,),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff=1408, n_shared_experts=2,
                  capacity_factor=1.25, sharding="expert"),
    rope_theta=50_000.0,
    long_context_window=8192,
    source="[hf:moonshotai/Moonlight-16B-A3B]",
)
