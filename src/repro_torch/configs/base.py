"""Architecture configuration for the PyTorch port.

Each registered architecture has one module in this package exporting
CONFIG (the exact published shape). `get_reduced` derives a tiny
same-family variant for CPU tests. The fields mirror the JAX package's
`ArchConfig`, field for field: causal, sliding-window and local attention
(with qk-norm, standard RoPE, M-RoPE or sinusoidal positions) with a dense
SwiGLU FFN or a mixture of experts, the Mamba-1 mixer and the RG-LRU mixer,
and the vlm / audio families' stub prefix embeddings; dtypes are
`torch.dtype`s.
`resnet50`, the paper's own CNN, has its own `ResNetConfig` and
`reduced()` (`configs/resnet50.py`), as in the reference's registry.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

# Layer kinds usable in ArchConfig.layer_pattern.
ATTN = "attn"              # global causal attention
ATTN_SWA = "attn_swa"      # sliding-window causal attention
ATTN_LOCAL = "attn_local"  # local attention (recurrentgemma-style window)
MAMBA = "mamba"            # Mamba-1 selective-SSM mixer
RGLRU = "rglru"            # RG-LRU gated linear recurrence mixer

ATTENTION_KINDS = (ATTN, ATTN_SWA, ATTN_LOCAL)
RECURRENT_KINDS = (MAMBA, RGLRU)


@dataclass(frozen=True)
class MoEConfig:
    """The reference's `MoEConfig`, field for field, with its defaults.
    `sharding` ("expert" or "tensor") places the experts on the JAX
    package's device mesh; one card has no expert axis, so the port keeps
    the field for parity and does not read it."""
    n_experts: int
    top_k: int
    d_ff: int                     # per-expert hidden size
    n_shared_experts: int = 0     # dense "shared expert" branch (DeepSeek-style)
    capacity_factor: float = 1.25
    # routing group length (GShard "groups"): capacity is allocated per
    # group of this many tokens
    group_size: int = 2048
    sharding: str = "expert"
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:  # Mamba-1
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0     # 0 -> d_model
    conv_width: int = 4
    c_exponent: float = 8.0


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | ssm | moe | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int                       # dense FFN hidden (0 for attention-free / MoE)
    vocab_size: int
    layer_pattern: Tuple[str, ...] = (ATTN,)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    qk_norm: bool = False           # RMS norm of q and k over head_dim
    rope_type: str = "standard"     # standard | mrope | none (sinusoidal positions)
    rope_theta: float = 10000.0
    sliding_window: int = 0         # window for attn_swa / attn_local layers
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # window of the sliding-window variant dense archs use for long contexts
    long_context_window: int = 0
    # vlm / audio: the frontend's embeddings (batch, prefix_embed_len,
    # d_model) are spliced before the token embeddings; the frontends are
    # stubs in the reference too, so callers pass seeded embeddings
    prefix_embed_len: int = 0
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    source: str = ""

    @property
    def dt_rank(self) -> int:
        if self.ssm is None:
            return 0
        return self.ssm.dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return 0 if self.ssm is None else self.ssm.expand * self.d_model

    @property
    def lru_width(self) -> int:
        if self.rglru is None:
            return 0
        return self.rglru.lru_width or self.d_model

    def has_attention(self) -> bool:
        return any(k in ATTENTION_KINDS for k in self.layer_pattern)

    def validate(self) -> None:
        """The reference's checks (`repro/configs/base.py::validate`):
        attention-free and FFN-free configurations are valid."""
        if self.n_layers < 1 or self.d_model < 1:
            raise ValueError(f"{self.name}: n_layers and d_model must be >= 1")
        if self.has_attention():
            if self.n_heads < 1 or self.head_dim < 1 or self.n_kv_heads < 1:
                raise ValueError(f"{self.name}: heads and head_dim must be >= 1")
            if self.n_heads % self.n_kv_heads:
                raise ValueError(f"{self.name}: n_heads % n_kv_heads != 0")
        for kind in self.layer_pattern:
            if kind not in ATTENTION_KINDS + RECURRENT_KINDS:
                raise ValueError(f"{self.name}: unknown layer kind {kind!r}")
        if MAMBA in self.layer_pattern and self.ssm is None:
            raise ValueError(f"{self.name}: mamba layers need an SSMConfig")
        if RGLRU in self.layer_pattern and self.rglru is None:
            raise ValueError(f"{self.name}: rglru layers need an RGLRUConfig")
        if (any(k in (ATTN_SWA, ATTN_LOCAL) for k in self.layer_pattern)
                and self.sliding_window <= 0):
            raise ValueError(f"{self.name}: windowed layers need sliding_window > 0")
        if self.moe is not None and not 1 <= self.moe.top_k <= self.moe.n_experts:
            raise ValueError(f"{self.name}: MoE top_k must be in [1, n_experts]")
        if self.rope_type not in ("standard", "mrope", "none"):
            raise ValueError(f"{self.name}: unknown rope_type {self.rope_type!r}")

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def reduce_config(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family variant for CPU tests (<= 2 pattern repeats,
    d_model <= 256, prefix <= 8 rows, f32) — the same reduction as the JAX package's."""
    pat = cfg.layer_pattern
    n_layers = len(pat) if len(pat) > 1 else 2
    d_model = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    head_dim = max(8, d_model // max(n_heads, 1))
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe, n_experts=min(4, moe.n_experts), top_k=min(2, moe.top_k),
            d_ff=min(64, moe.d_ff),
            n_shared_experts=min(1, moe.n_shared_experts))
    rglru = cfg.rglru
    if rglru is not None:
        rglru = dataclasses.replace(
            rglru, lru_width=min(rglru.lru_width or cfg.d_model, d_model))
    return cfg.replace(
        n_layers=n_layers, d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
        head_dim=head_dim, d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512), moe=moe, rglru=rglru,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        long_context_window=min(cfg.long_context_window, 64)
        if cfg.long_context_window else 0,
        prefix_embed_len=min(cfg.prefix_embed_len, 8),
        param_dtype=torch.float32, compute_dtype=torch.float32,
    )


ARCH_IDS = ("llama3.2-1b", "falcon-mamba-7b", "recurrentgemma-9b",
            "granite-moe-3b-a800m", "moonshot-v1-16b-a3b", "mixtral-8x22b",
            "qwen3-8b", "minitron-8b", "qwen2-vl-2b", "musicgen-large",
            "resnet50")  # the paper's own benchmark model (CNN family)


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"{arch_id!r} is not ported; ported: {ARCH_IDS}")
    mod_name = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(arch_id: str):
    """The published config: an ArchConfig, or resnet50's ResNetConfig."""
    cfg = _module(arch_id).CONFIG
    if isinstance(cfg, ArchConfig):
        cfg.validate()
    return cfg


def get_reduced(arch_id: str):
    mod = _module(arch_id)
    if hasattr(mod, "reduced"):
        return mod.reduced()
    return reduce_config(get_config(arch_id))


def require_lm(arch_id: str, entry: str) -> None:
    """Refuse a config that is not a decoder LM's `ArchConfig` (the CNN
    family's `ResNetConfig`) at an LM entry point (launch.train,
    launch.serve, profile_serve), naming the CNN's own (SystemExit). The
    config's type decides, as the reference's launcher tests its shape."""
    cfg = _module(arch_id).CONFIG
    if not isinstance(cfg, ArchConfig):
        raise SystemExit(
            f"{entry}: {arch_id} is the {cfg.family.upper()} family, not a decoder LM; "
            "train it with repro_torch.train.loop.run_training and "
            "train.step.make_resnet_loss, or with python -m repro_torch.launch.ablation")
