"""Qwen2-VL-2B language backbone with M-RoPE [arXiv:2409.12191].

28L d_model=1536 12H (GQA kv=2, head_dim=128) d_ff=8960 vocab=151936.
The ViT vision encoder + projector is stubbed, as in the JAX package: the
caller passes precomputed patch embeddings (B, prefix, d_model) and, where
it wants them, 3D M-RoPE position ids (temporal / height / width) for the
spliced sequence.
"""
from repro_torch.configs.base import ATTN, ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    layer_pattern=(ATTN,),
    rope_type="mrope",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    long_context_window=8192,
    prefix_embed_len=256,  # 16x16 patch grid stub
    source="[arXiv:2409.12191]",
)
