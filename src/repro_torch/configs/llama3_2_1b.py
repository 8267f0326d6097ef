"""Llama-3.2-1B: small dense GQA decoder, tied embeddings [hf:meta-llama/Llama-3.2-1B].

16L d_model=2048 32H (GQA kv=8, head_dim=64) d_ff=8192 vocab=128256.
"""
from repro_torch.configs.base import ATTN, ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    layer_pattern=(ATTN,),
    rope_theta=500_000.0,
    tie_embeddings=True,
    long_context_window=8192,
    source="[hf:meta-llama/Llama-3.2-1B]",
)
