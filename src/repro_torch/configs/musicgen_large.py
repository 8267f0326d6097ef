"""MusicGen-large decoder backbone over EnCodec tokens [arXiv:2306.05284].

48L d_model=2048 32H (kv=32, i.e. MHA) d_ff=8192 vocab=2048. The text/melody
conditioning frontend is stubbed, as in the JAX package: the caller passes a
precomputed conditioning-embedding prefix of shape (B, prefix, d_model),
which the backbone consumes through the embedding splice.
"""
from repro_torch.configs.base import ATTN, ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    layer_pattern=(ATTN,),
    rope_type="none",  # sinusoidal positions in place of musicgen's learned ones
    tie_embeddings=False,
    long_context_window=8192,
    prefix_embed_len=64,
    source="[arXiv:2306.05284]",
)
