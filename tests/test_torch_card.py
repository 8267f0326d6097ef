"""Tests of the port that need an NVIDIA GPU (marker `cuda`): the CUDA
kernel against its plain version, and the serving path through it. They
import neither JAX nor the JAX package, so they run on a machine that has
only PyTorch:

  PYTHONPATH=src python -m pytest -m cuda tests/test_torch_card.py

Elsewhere they skip."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.ref import attention_ref
from repro_torch.models.lm import forward, init_params
from repro_torch.serve.engine import Engine, make_prefill_fn

pytestmark = pytest.mark.cuda

# tests/test_kernels.py tolerances: f32 to 2e-5; bf16 to 2e-2 (the kernel
# rounds the probabilities to bf16 before the PV product, the oracle does not)
ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

CASES = [
    (2, 4, 4, 128, 128, 64, 0),
    (1, 8, 2, 128, 128, 32, 0),
    (2, 4, 1, 64, 256, 64, 0),
    (1, 2, 2, 256, 256, 128, 0),
    (1, 2, 2, 256, 256, 32, 32),
    (4, 32, 8, 1024, 1024, 64, 64),
    (1, 4, 2, 100, 100, 64, 0),
    (2, 4, 1, 40, 100, 128, 0),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hk,Sq,Sk,D,window", CASES)
def test_kernel_matches_plain(cuda, B, Hq, Hk, Sq, Sk, D, window, dtype, causal):
    rng = np.random.default_rng(Sq * D + window)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(cuda, dtype)
               for s in ((B, Hq, Sq, D), (B, Hk, Sk, D), (B, Hk, Sk, D)))
    before = flash_attention_fwd.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = attention_ref(q, k, v, causal=causal, window=window)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= ATOL[dtype], err


def test_misaligned_tensor_raises(cuda):
    buf = torch.zeros(1 + 2 * 8 * 64, device=cuda)
    q = buf[1:].view(1, 2, 8, 64)  # contiguous, 4 bytes off 16-byte alignment
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(q, q, q)


def test_serving_goes_through_the_kernel(cuda):
    """Reduced config on the card: one launch per layer per prefill, and the
    kernel-path prefill agrees with a plain teacher-forced forward (f32,
    tests/test_serve.py's 2e-3)."""
    cfg = get_reduced("llama3.2-1b").replace(n_kv_heads=2)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = init_params(cfg, gen, cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 48), generator=gen, device=cuda)
    before = flash_attention_fwd.launches
    st = make_prefill_fn(cfg, cache_len=64)(params, toks)
    assert flash_attention_fwd.launches - before == cfg.n_layers
    want = forward(params, toks, cfg, attn_impl="plain")["logits"][:, -1]
    assert (st["logits_last"] - want).abs().max().item() < 2e-3
    out = Engine(cfg, params, max_len=64).generate(toks, 8)
    assert out.shape == (2, 8) and out.device.type == "cuda"
