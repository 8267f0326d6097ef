"""Port's flash attention (plain version on CPU tensors; the CUDA kernel on
the card) held against the JAX package: the Pallas kernel run in interpret
mode, and the jnp oracle. Inputs are made from a seed with numpy."""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import flash_attention as jax_flash
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import check_inputs, flash_attention_fwd
from repro_torch.kernels.ref import attention_ref, attention_row_ratio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_kernels.py tolerances: f32 to 2e-5; bf16 to 2e-2 (the kernel
# rounds the probabilities to bf16 before the PV product, the oracle does not)
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(seed, B, Hq, Hk, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Sq, D), dtype=np.float32),
            rng.standard_normal((B, Hk, Sk, D), dtype=np.float32),
            rng.standard_normal((B, Hk, Sk, D), dtype=np.float32))


def _both(arrays, dtype):
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


CASES = [
    # tests/test_kernels.py:16-20
    (2, 4, 4, 128, 128, 64, 0),     # MHA square
    (1, 8, 2, 128, 128, 32, 0),     # GQA 4:1
    (2, 4, 1, 64, 256, 64, 0),      # MQA, q suffix of longer kv
    (1, 2, 2, 256, 256, 128, 0),    # head dim 128
    # windows
    (1, 2, 2, 256, 256, 32, 32),
    (1, 2, 2, 256, 256, 32, 64),
    # ragged lengths
    (1, 4, 2, 100, 100, 64, 0),
    (2, 4, 1, 40, 100, 64, 0),
    # head dim 256, MQA (recurrentgemma-9b's local attention)
    (2, 4, 1, 128, 128, 256, 0),
    (1, 4, 1, 64, 192, 256, 64),    # q suffix, window
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hk,Sq,Sk,D,window", CASES)
def test_flash_attention_matches_pallas_interpret(B, Hq, Hk, Sq, Sk, D, window,
                                                  dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(Sq * D + window, B, Hq, Hk, Sq, Sk, D),
                                       dtype)
    pallas = jax_flash(jq, jk, jv, causal=True, window=window, block_q=64,
                       block_k=64, interpret=True)
    out = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    np.testing.assert_allclose(_f32(out), _f32(pallas), atol=ATOL[dtype])


NONCAUSAL = [(2, 4, 4, 128, 128, 64, 0), (1, 8, 2, 100, 100, 32, 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hk,Sq,Sk,D,window", NONCAUSAL)
def test_non_causal_matches_pallas_interpret(B, Hq, Hk, Sq, Sk, D, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(D + window, B, Hq, Hk, Sq, Sk, D), dtype)
    pallas = jax_flash(jq, jk, jv, causal=False, window=window, block_q=64,
                       block_k=64, interpret=True)
    out = ops.flash_attention(tq, tk, tv, causal=False, window=window)
    np.testing.assert_allclose(_f32(out), _f32(pallas), atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hk,Sq,Sk,D,window", CASES)
def test_attention_ref_matches_jax_ref(B, Hq, Hk, Sq, Sk, D, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(Sq + D + window, B, Hq, Hk, Sq, Sk, D),
                                       dtype)
    want = jax_attention_ref(jq, jk, jv, causal=True, window=window)
    got = attention_ref(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ATOL[dtype])


def _masked_attention(q, k, v, mask):
    """attention_ref's arithmetic under an explicit (Sq, Sk) mask, in q's
    dtype: the plain version with a mask a faulty kernel might compute."""
    B, Hq, Sq, D = q.shape
    Hk = k.shape[1]
    qg = q.reshape(B, Hk, Hq // Hk, Sq, D).float()
    s = torch.einsum("bkgqd,bkld->bkgql", qg, k.float()) * D ** -0.5
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    o = torch.einsum("bkgql,bkld->bkgqd", p, v.float())
    return o.reshape(B, Hq, Sq, D).to(q.dtype)


ROW_RULE_SHAPE = (1, 4, 2, 80, 80, 64)  # Sk = 80: a full 64-key tile and a ragged one
ROW_RULE_WINDOW = 16


def _row_rule_mask(Sq, Sk, window, mutation):
    row = torch.arange(Sq)[:, None] + (Sk - Sq)
    col = torch.arange(Sk)[None, :]
    mask = col <= row
    if mutation == "window_edge_off_by_one":
        return mask & (col >= row - window)
    mask &= col > row - window
    if mutation == "drop_last_key":
        mask &= col < Sk - 1
    elif mutation == "drop_last_kv_tile":
        mask &= col < (Sk - 1) // 64 * 64
    return mask


@pytest.mark.parametrize("mutation", [None, "drop_last_key", "drop_last_kv_tile",
                                      "window_edge_off_by_one"])
def test_row_rule_flags_edge_faults(mutation):
    """`attention_row_ratio` passes the plain version's own bf16 output and
    flags plain versions that drop the last key at the Sk edge, drop the
    last kv tile, or move the window edge by one."""
    B, Hq, Hk, Sq, Sk, D = ROW_RULE_SHAPE
    window = 0 if mutation in ("drop_last_key", "drop_last_kv_tile") else ROW_RULE_WINDOW
    _, (q, k, v) = _both(_qkv(21, B, Hq, Hk, Sq, Sk, D), "bfloat16")
    ref32 = attention_ref(q.float(), k.float(), v.float(), causal=True, window=window)
    if mutation is None:
        out = attention_ref(q, k, v, causal=True, window=window)
        assert attention_row_ratio(out, ref32) <= 1.0
    else:
        out = _masked_attention(q, k, v, _row_rule_mask(Sq, Sk, window or Sk, mutation))
        assert attention_row_ratio(out, ref32) > 1.0


def test_row_rule_limit_is_eight_ulps_of_the_row_peak():
    ref32 = torch.tensor([[[[0.75, -0.5], [3.0, 1.0]]]])
    # row 0: peak 0.75, bf16 ulp 2**-8, limit 8 ulps = 2**-5
    out = ref32.clone()
    out[..., 0, 1] += 2 ** -5
    assert attention_row_ratio(out, ref32) == pytest.approx(1.0)
    # row 1: peak 3.0, ulp 2**-6, limit 2**-3
    out = ref32.clone()
    out[..., 1, 0] += 2 ** -4
    assert attention_row_ratio(out, ref32) == pytest.approx(0.5)


def test_cpu_tensors_never_count_a_launch():
    flash_attention_fwd.launches = 0
    _, (tq, tk, tv) = _both(_qkv(0, 1, 4, 2, 64, 64, 64), "float32")
    ops.flash_attention(tq, tk, tv)
    ops.flash_attention(tq, tk, tv, window=16)
    assert flash_attention_fwd.launches == 0


def _bad_inputs():
    def t(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)
    return {
        "float16": (t(1, 2, 8, 64, dtype=torch.float16),) * 3,
        "mixed_dtypes": (t(1, 2, 8, 64), t(1, 2, 8, 64, dtype=torch.bfloat16),
                         t(1, 2, 8, 64)),
        "head_dim_48": (t(1, 2, 8, 48),) * 3,
        "q_longer_than_kv": (t(1, 2, 16, 64), t(1, 2, 8, 64), t(1, 2, 8, 64)),
        "heads_not_grouped": (t(1, 3, 8, 64), t(1, 2, 8, 64), t(1, 2, 8, 64)),
        "k_v_mismatch": (t(1, 2, 8, 64), t(1, 2, 8, 64), t(1, 2, 9, 64)),
        "not_contiguous": (t(1, 8, 2, 64).transpose(1, 2), t(1, 2, 8, 64),
                           t(1, 2, 8, 64)),
        "three_dims": (t(2, 8, 64),) * 3,
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    q, k, v = _bad_inputs()[case]
    with pytest.raises((ValueError, TypeError)):
        ops.flash_attention(q, k, v)


def test_wrapper_rejects_negative_window():
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q, window=-1)


def test_build_without_nvcc_is_an_error(monkeypatch, tmp_path):
    """A missing compiler raises: the card path never falls back."""
    monkeypatch.setattr(ops.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(ops, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ops.build("flash_attention_fwd")


@pytest.fixture
def chip_smoke(monkeypatch):
    """chip_smoke.py as a module (its main() runs only as a script). The
    allocator setting it defaults is set here first, so the test's
    environment is restored after it."""
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_card_checks_are_inputs_the_kernel_takes(chip_smoke):
    """Every K1 case that chip_smoke.py runs on the card passes the
    wrapper's checks (shapes only: tensors on the meta device)."""
    for name, B, Hq, Hk, Sq, Sk, D, dtype, window, causal in chip_smoke.CHECKS:
        q = torch.empty(B, Hq, Sq, D, dtype=dtype, device="meta")
        kv = torch.empty(B, Hk, Sk, D, dtype=dtype, device="meta")
        check_inputs(q, kv, kv, window)
        assert isinstance(causal, bool), name


def _meta_scan_inputs(B, S, Di, N, dtype, dt_rank):
    """K7's inputs as chip_smoke.scan_inputs shapes and strides them, on the
    meta device (shapes only)."""
    x = torch.empty(B, S, Di, dtype=dtype, device="meta")
    dt = torch.empty(B, S, Di, device="meta")
    if dt_rank:
        _, Bm, Cm = torch.empty(B, S, dt_rank + 2 * N, dtype=dtype,
                                device="meta").split([dt_rank, N, N], dim=-1)
    else:
        Bm = Cm = torch.empty(B, S, N, dtype=dtype, device="meta")
    return (x, dt, torch.empty(Di, N, device="meta"), Bm, Cm,
            torch.empty(B, Di, N, device="meta"))


def test_scan_checks_are_inputs_the_kernel_takes(chip_smoke):
    """Every K7 case that chip_smoke.py runs on the card passes the
    wrapper's checks, the view cases are views (off 16 bytes at dt_rank 7),
    and every case is held to the f32 rule."""
    from repro_torch.kernels import ssm_scan as scan
    assert chip_smoke.SCAN_TOL == 1e-4
    names = [case[0] for case in chip_smoke.SCAN_CHECKS]
    assert len(set(names)) == len(names)
    for name, B, S, Di, N, dtype, random_h0, dt_rank in chip_smoke.SCAN_CHECKS:
        x, dt, A, Bm, Cm, h0 = _meta_scan_inputs(B, S, Di, N, dtype, dt_rank)
        scan.check_inputs(x, dt, A, Bm, Cm, h0)
        assert Bm.is_contiguous() == (dt_rank == 0), name
        assert isinstance(random_h0, bool), name
    shapes = {(case[3], case[4]) for case in chip_smoke.SCAN_CHECKS}
    assert {1, 12, 16, 32} <= {n for _, n in shapes} and 1 in {d for d, _ in shapes}
    assert any(case[-1] == 7 and case[5] == torch.bfloat16 for case in chip_smoke.SCAN_CHECKS)


def test_bwd_checks_cover_the_sweep_and_the_train_shapes(chip_smoke):
    """K7-bwd is held on every K7 case plus the train shape with and without
    a cotangent of h_final, and K8-bwd on every K8 case plus its train
    shape; every K7-bwd case passes the wrapper's checks."""
    from repro_torch.kernels import ssm_scan as scan
    bwd = chip_smoke.SCAN_BWD_CHECKS
    assert [c[:-1] for c in bwd[:len(chip_smoke.SCAN_CHECKS)]] == chip_smoke.SCAN_CHECKS
    assert {(c[1:5], c[-1]) for c in bwd[len(chip_smoke.SCAN_CHECKS):]} == {
        (chip_smoke.MAMBA_TRAIN_SHAPE, True), (chip_smoke.MAMBA_TRAIN_SHAPE, False)}
    for name, B, S, Di, N, dtype, random_h0, dt_rank, with_dh in bwd:
        scan.check_inputs(*_meta_scan_inputs(B, S, Di, N, dtype, dt_rank))
    rg = chip_smoke.RGLRU_BWD_CHECKS
    assert rg[:len(chip_smoke.RGLRU_CHECKS)] == chip_smoke.RGLRU_CHECKS
    assert tuple(rg[-1][1:4]) == chip_smoke.RGEMMA_TRAIN_SHAPE
    assert chip_smoke.SCAN_BWD_RTOL == {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN5ssm_scan_kernelI13__nv_bfloat16Li16ELb1EEEvNS_4ArgsENS_4MapsE
        /*0000*/                   MUFU.EX2 R2, R3 ;          /* 0x0000000000007308 */
        /*0010*/               @P0 BRA 0x0 ;                  /* 0x0000000000007947 */
\t\tFunction : _ZN5ssm_scan_kernelI13__nv_bfloat16Li16ELb0EEEvNS_4ArgsENS_4MapsE
        /*0000*/                   LDC R1, c[0x0][0x28] ;     /* 0x0000000000017b82 */
        /*0010*/                   LDS.128 R4, [R13] ;        /* 0x0000000000047984 */
        /*0020*/                   MUFU.EX2 R2, R3 ;          /* 0x0000000000007308 */
        /*0030*/                   MUFU.EX2 R5, R6 ;          /* 0x0000000000007308 */
        /*0040*/                   FFMA R4, R2, R5, R6 ;      /* 0x0000000000007223 */
        /*0050*/               @P1 BRA 0x10 ;                 /* 0x0000000000007947 */
        /*0060*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;  /* 0x0000000000007b1d */
        /*0070*/               @P2 BRA 0x0 ;                  /* 0x0000000000007947 */
        /*0080*/                   EXIT ;                     /* 0x000000000000794d */
"""


def test_sass_hot_loop_reads_the_innermost_loop_of_the_instance(chip_smoke, monkeypatch):
    """fp32_issue_ms's count: the instance's innermost backward-branch loop
    with the most MUFU.EX2, not the enclosing tile loop and not the masked
    instance; instructions per exp = the loop's instructions / its exps."""
    class Done:
        stdout = SASS

    monkeypatch.setattr(chip_smoke.subprocess, "run", lambda *a, **k: Done())
    got = chip_smoke.sass_hot_loop("lib.so", "ssm_scan_kernelI13__nv_bfloat16Li16ELb0E")
    assert got["instructions"] == 5 and got["exps"] == 2 and got["per_exp"] == 2.5
    assert got["opcodes"] == {"MUFU.EX2": 2, "LDS.128": 1, "FFMA": 1, "BRA": 1}
    assert got["instance"].endswith("Li16ELb0EEEvNS_4ArgsENS_4MapsE")
    with pytest.raises(AssertionError, match="no SASS"):
        chip_smoke.sass_hot_loop("lib.so", "rglru_scan_kernel")


def test_ptxas_report_is_read_per_instance(chip_smoke):
    report = """ptxas info    : Compiling entry function '_Z15fwd_kernel_bf16ILi64E' for 'sm_90a'
ptxas info    : Function properties for _Z15fwd_kernel_bf16ILi64E
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '_Z14fwd_kernel_f32ILi64E' for 'sm_90a'
ptxas info    : Function properties for _Z14fwd_kernel_f32ILi64E
    56 bytes stack frame, 88 bytes spill stores, 76 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers, 56 bytes cumulative stack size"""
    assert chip_smoke.ptxas_instances(report) == {
        "_Z15fwd_kernel_bf16ILi64E": {"spill_stores": 0, "spill_loads": 0, "registers": 168},
        "_Z14fwd_kernel_f32ILi64E": {"spill_stores": 88, "spill_loads": 76, "registers": 255}}


def test_stream_extras_read_the_ring_instance(chip_smoke):
    """K2 to K4's row fields: ptxas's report of the ring instance at the
    training arena's dtypes (not the loop kernel's, not the bf16 arena's),
    the ring's choice as given, and TB/s from bytes and ms."""
    ns = "_ZN48_GLOBAL__N__e8e93a3e_15_comm_kernels_cu_4e8035cb"
    report = "\n".join(
        f"ptxas info    : Compiling entry function '{ns}{name}' for 'sm_90a'\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
        f"ptxas info    : Used {regs} registers, used 1 barriers"
        for name, regs, spill in (
            ("18stream_loop_kernelINS_8Eq1MergeIfEEEEvNS_6StreamIT_EES4_", 30, 0),
            ("18stream_ring_kernelINS_8Eq1MergeI13__nv_bfloat16EEEEvNS_6StreamIT_EES5_", 41, 0),
            ("18stream_ring_kernelINS_8Eq1MergeIfEEEEvNS_6StreamIT_EES4_", 40, 8),
            ("18stream_ring_kernelINS_4CastIf13__nv_bfloat16EEEEvNS_6StreamIT_EES5_", 32, 0),
            ("18stream_ring_kernelINS_4CastI13__nv_bfloat16fEEEEvNS_6StreamIT_EES5_", 33, 0)))
    ring = {"chunk_bytes": 16384, "grid": 132}
    got = chip_smoke.stream_extras(report, "eq1_merge", ring, 12 * 10 ** 9, 4.0)
    assert got == {"ptxas": {"instance": ns + "18stream_ring_kernelINS_8Eq1MergeIfEEEEvNS_"
                             "6StreamIT_EES4_", "spill_stores": 8, "spill_loads": 8,
                             "registers": 40},
                   "ring": ring, "tb_per_s": 3.0}
    assert chip_smoke.stream_extras(report, "bf16_pack", ring, 1, 1)["ptxas"]["registers"] == 32
    assert chip_smoke.stream_extras(report, "bf16_unpack", ring, 1, 1)["ptxas"]["registers"] == 33


def test_ring_edge_sizes_and_shared_offsets(chip_smoke):
    ring = {"chunk_elements": 4096, "grid": 132, "stages": 4}
    assert chip_smoke.ring_edge_sizes(ring) == [4095, 4097, 132 * 4 * 4096 + 1]
    # (x offset, in bytes, out bytes) -> out offset: x + head and out + head
    # both 16-byte aligned
    for x_off, i, o in [(1, 4, 4), (3, 4, 2), (1, 2, 4), (5, 2, 2), (0, 4, 2), (2, 4, 2)]:
        head = -x_off % (16 // i)
        out_off = chip_smoke.shared_offset(x_off, i, o)
        assert ((x_off + head) * i) % 16 == 0 and ((out_off + head) * o) % 16 == 0
        assert 0 <= out_off < 16 // o
