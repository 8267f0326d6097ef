"""RecurrentGemma-9B (Griffin): RG-LRU + local attention hybrid, pattern
2 recurrent : 1 local-attention [arXiv:2402.19427].

38L d_model=4096 16H (MQA kv=1, head_dim=256) d_ff=12288 vocab=256000,
local attention window 2048, tied embeddings.
38 = 12 * (rglru, rglru, attn_local) + (rglru, rglru) remainder.
"""
from repro_torch.configs.base import ATTN_LOCAL, RGLRU, ArchConfig, RGLRUConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    layer_pattern=(RGLRU, RGLRU, ATTN_LOCAL),
    rglru=RGLRUConfig(lru_width=4096, conv_width=4, c_exponent=8.0),
    sliding_window=2048,
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="[arXiv:2402.19427]",
)
