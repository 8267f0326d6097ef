"""Falcon-Mamba-7B: attention-free Mamba-1 architecture [arXiv:2410.05355].

64L d_model=4096, d_inner=8192 (expand=2), ssm_state=16, vocab=65024.
Decode carries the recurrent SSM state and the conv window (no KV cache).
"""
from repro_torch.configs.base import MAMBA, ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,  # attention-free, FFN-free: the mamba mixer is the whole block
    vocab_size=65024,
    layer_pattern=(MAMBA,),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    rope_type="none",
    tie_embeddings=False,
    source="[arXiv:2410.05355]",
)
