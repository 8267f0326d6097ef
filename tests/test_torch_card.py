"""Tests of the port that need an NVIDIA GPU (marker `cuda`): the CUDA
kernels against their plain versions, and the serving and training paths
through them. They import neither JAX nor the JAX package, so they run on
a machine that has only PyTorch:

  PYTHONPATH=src python -m pytest -m cuda tests/test_torch_card.py

Elsewhere they skip."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.core import daso
from repro_torch.core.schedule import split_ov
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.kernels import comm_kernels, ops
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.ref import (attention_ref, attention_row_ratio, bf16_pack_ref,
                                     bf16_unpack_ref, dequantize_int8_block_ref, eq1_merge_ref,
                                     quantize_int8_block_ref, rglru_scan_bwd_ref,
                                     rglru_scan_ref, ssm_scan_bwd_ref, ssm_scan_ref)
from repro_torch.kernels.rglru_scan import rglru_scan_bwd, rglru_scan_fwd
from repro_torch.kernels.ssm_scan import scan_config, ssm_scan_bwd, ssm_scan_fwd
from repro_torch.models.lm import forward, init_params
from repro_torch.serve.engine import Engine, make_decode_fn, make_prefill_fn
from repro_torch.train.loop import TrainLoopConfig, run_training
from repro_torch.train.step import make_lm_loss
from repro_torch.tree import leaves

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
    (4, 16, 1, 1024, 1024, 256, 2048),  # recurrentgemma-9b's local attention
    (1, 16, 1, 3072, 3072, 256, 2048),  # kv past the window
    (2, 16, 1, 333, 777, 256, 300),     # ragged q suffix
    (4, 16, 1, 1024, 1024, 256, 0),     # head_dim 256 without a window
    (4, 32, 8, 500, 500, 32, 0),        # head_dim 32 at the serving GQA ratio, ragged
    (2, 8, 2, 1, 1, 64, 0),             # one key
    (2, 8, 2, 200, 777, 64, 0),         # q-suffix tiles ragged at both ends
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
    if dtype == torch.bfloat16:  # and each row within 8 ulps of its f32 reference
        ref32 = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                              window=window)
        assert attention_row_ratio(out, ref32) <= 1.0


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


# -- exchange kernels K2 / K3 / K4: bit-exact with their plain versions --------

# f32 values where a bf16 cast can go wrong: ties to even, values above the
# largest bf16 (round to inf), infinities, signed zeros, f32 subnormals
EDGES = [1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 3.3961e38, 3.3962e38, 3.4e38,
         -3.4e38, float("inf"), float("-inf"), 0.0, -0.0, 1e-40, -1e-40, 1.4e-45,
         1.17e-38, 9e-39, 1.0, -2.5]


def _arena(cuda, n, seed, dtype, offset=0, edges=False):
    """n values on the card; `offset` > 0 returns a contiguous view that
    starts `offset` elements into its buffer (not 16-byte aligned)."""
    x = np.random.default_rng(seed).standard_normal(n + offset, dtype=np.float32) * 40
    if edges:
        x[offset:offset + len(EDGES)] = EDGES
    return torch.from_numpy(x).to(cuda, dtype)[offset:]


def _same_bits(a, b):
    """Bit-exact equality (so -0.0 differs from 0.0)."""
    as_int = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return a.dtype == b.dtype and torch.equal(a.view(as_int[a.dtype]),
                                              b.view(as_int[b.dtype]))


def _same_or_nan(a, b):
    """Bit-exact equality, NaN equal to NaN whatever its payload."""
    nan = torch.isnan(a)
    return a.shape == b.shape and torch.equal(nan, torch.isnan(b)) and _same_bits(
        torch.where(nan, 0.0, a), torch.where(nan, 0.0, b))


SIZES = [(999, 0), (2 ** 20 + 3, 0), (4099, 1), (4099, 3), (8, 0), (1, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,offset", SIZES)
def test_eq1_merge_kernel_bit_exact(cuda, n, offset, dtype):
    x = _arena(cuda, n, 1, dtype, offset)
    y = _arena(cuda, n, 2, dtype, offset)
    before = comm_kernels.eq1_merge_fwd.launches
    for S, P, E in ((1, 16, 0), (3, 16, 1), (2, 48, 0)):
        got = ops.eq1_merge(x, y, staleness=S, global_world=P, extra_staleness=E)
        want = eq1_merge_ref(x, y, staleness=S, global_world=P, extra_staleness=E)
        torch.cuda.synchronize()
        assert _same_bits(got, want)
    assert comm_kernels.eq1_merge_fwd.launches == before + 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,offset", SIZES)
def test_bf16_pack_kernel_bit_exact(cuda, n, offset, dtype):
    x = _arena(cuda, max(n, len(EDGES)), 3, dtype, offset, edges=True)
    before = comm_kernels.bf16_pack_fwd.launches
    got = ops.bf16_pack(x)
    torch.cuda.synchronize()
    assert comm_kernels.bf16_pack_fwd.launches == before + 1
    assert got.dtype == torch.bfloat16 and _same_bits(got, bf16_pack_ref(x))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,offset", SIZES)
def test_bf16_unpack_kernel_bit_exact(cuda, n, offset, out_dtype):
    x = _arena(cuda, max(n, len(EDGES)), 4, torch.bfloat16, offset, edges=True)
    before = comm_kernels.bf16_unpack_fwd.launches
    got = ops.bf16_unpack(x, out_dtype)
    torch.cuda.synchronize()
    assert comm_kernels.bf16_unpack_fwd.launches == before + 1
    assert got.dtype == out_dtype and _same_bits(got, bf16_unpack_ref(x, out_dtype))


def test_bf16_pack_keeps_nan_nan(cuda):
    x = torch.tensor([float("nan"), 1.0], device=cuda)
    assert torch.isnan(ops.bf16_pack(x)[0]) and ops.bf16_pack(x)[1].item() == 1.0


# Eq. (1) edges, taken pairwise (x from the first list, y from the second):
# subnormal inputs and results, s2 * x or p * y past the largest f32,
# infinities, NaN, signed zeros
EQ1_X = [0.0, -0.0, 1e-40, -1e-40, 1.4e-45, 9e-39, 1.2e-38, 1e-36, 1.17e-38, 3e38, -3e38,
         3.4e38, np.inf, -np.inf, np.nan, 1.0, -2.5, 2e37]
EQ1_Y = [0.0, -0.0, -9e-39, 1e-40, 1.4e-45, 1e-38, 3e38, -3e38, 2.2e37, -2.2e37, np.inf,
         -np.inf, np.nan, 1.0, -1.0, 1e-30]
F32, BF16 = torch.float32, torch.bfloat16
# (entry point, input dtype, output dtype) of K2 to K4
STREAMS = [("eq1_merge", F32, F32), ("eq1_merge", BF16, BF16), ("bf16_pack", F32, BF16),
           ("bf16_pack", BF16, BF16), ("bf16_unpack", BF16, F32), ("bf16_unpack", BF16, BF16)]
EQ1_KW = dict(staleness=1, global_world=16)


def _eq1_edge_pair(cuda, n, dtype, offset=0):
    """x, y of n >= 288 values: every (EQ1_X, EQ1_Y) pair first."""
    edges = (np.repeat(np.float32(EQ1_X), len(EQ1_Y)), np.tile(np.float32(EQ1_Y), len(EQ1_X)))
    out = []
    for seed, e in zip((5, 6), edges):
        v = np.random.default_rng(seed).standard_normal(n + offset, dtype=np.float32) * 40
        v[offset:offset + e.size] = e
        out.append(torch.from_numpy(v).to(cuda, dtype)[offset:])
    return out


def _stream_inputs(cuda, entry, n, din, offset=0):
    if entry == "eq1_merge":
        return (_eq1_edge_pair(cuda, n, din, offset) if n >= len(EQ1_X) * len(EQ1_Y)
                else (_arena(cuda, n, 7, din, offset), _arena(cuda, n, 8, din, offset)))
    return _arena(cuda, n, 9, din, offset, edges=n >= len(EDGES)), None


def _plain(entry, x, y, dout):
    if entry == "eq1_merge":
        return eq1_merge_ref(x, y, **EQ1_KW)
    return bf16_pack_ref(x) if entry == "bf16_pack" else bf16_unpack_ref(x, dout)


def _into(entry, x, y, out):
    """The entry point into `out` (no launch counted)."""
    lib = ops.kernel_library("comm_kernels")
    if entry == "eq1_merge":
        comm_kernels.launch_eq1_merge(lib, x, y, out, **EQ1_KW)
    else:
        comm_kernels.launch_cast(lib, entry, x, out)


def _ring_sizes(entry, din, dout):
    """One chunk - 1 and + 1, one turn of the ring over the persistent grid + 1."""
    ring = comm_kernels.ring_config(ops.kernel_library("comm_kernels"), entry,
                                    dout if entry == "bf16_unpack" else din, 2 ** 40)
    chunk = ring["chunk_elements"]
    return [chunk - 1, chunk + 1, ring["grid"] * ring["stages"] * chunk + 1]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_eq1_merge_kernel_edge_pairs(cuda, dtype, offset):
    x, y = _eq1_edge_pair(cuda, 999, dtype, offset)
    for S, P, E in ((1, 16, 0), (3, 16, 1), (1, 1, 0)):
        kw = dict(staleness=S, global_world=P, extra_staleness=E)
        got = ops.eq1_merge(x, y, **kw)
        torch.cuda.synchronize()
        assert _same_or_nan(got, eq1_merge_ref(x, y, **kw))


@pytest.mark.parametrize("entry,din,dout", STREAMS)
def test_stream_kernels_at_ring_boundaries(cuda, entry, din, dout):
    for n in _ring_sizes(entry, din, dout):
        x, y = _stream_inputs(cuda, entry, n, din)
        x[n // 2] = float("nan")  # NaN in the ring's body
        out = torch.empty(n, dtype=dout, device=cuda)
        _into(entry, x, y, out)
        torch.cuda.synchronize()
        assert _same_or_nan(out, _plain(entry, x, y, dout)), n


def _shared_offset(x_offset, din, dout):
    head = -x_offset % (16 // din.itemsize)
    return -head % (16 // dout.itemsize)


@pytest.mark.parametrize("n", [2, 999, 2 ** 20 + 3])
@pytest.mark.parametrize("offset", [1, 3, 5])
@pytest.mark.parametrize("entry,din,dout", STREAMS)
def test_stream_kernels_on_views_misaligned_alike(cuda, entry, din, dout, offset, n):
    """x, y and out reach 16-byte alignment at one element: the ring's scalar
    head, and nothing written outside the output view."""
    x, y = _stream_inputs(cuda, entry, n, din, offset)
    o = _shared_offset(offset, din, dout)
    buf = torch.full((n + o + 16,), 7.0, dtype=dout, device=cuda)
    _into(entry, x, y, buf[o:o + n])
    torch.cuda.synchronize()
    assert _same_or_nan(buf[o:o + n], _plain(entry, x, y, dout))
    assert (buf[:o] == 7).all() and (buf[o + n:] == 7).all()


@pytest.mark.parametrize("entry,din,dout", STREAMS)
def test_stream_kernels_on_views_misaligned_unlike(cuda, entry, din, dout):
    """x and out (or y) reach alignment at different elements: the scalar loop."""
    x, y = _stream_inputs(cuda, entry, 4099, din)
    if y is not None:
        y = _arena(cuda, 4099, 10, din, 2)
    buf = torch.full((4099 + 17,), 7.0, dtype=dout, device=cuda)
    _into(entry, x, y, buf[1:4100])
    torch.cuda.synchronize()
    assert _same_or_nan(buf[1:4100], _plain(entry, x, y, dout))
    assert buf[0] == 7 and (buf[4100:] == 7).all()


def test_exchange_without_kernels_raises_on_the_card(cuda):
    """exchange_kernels=False is refused; the exchange of a CUDA carry
    launches K2 and K3."""
    with pytest.raises(ValueError, match="exchange_kernels=False"):
        daso.DasoConfig(n_replicas=4, global_world=16, exchange_kernels=False)
    tree = {"w": torch.ones(4, 3, device=cuda)}
    k2, k3 = comm_kernels.eq1_merge_fwd.launches, comm_kernels.bf16_pack_fwd.launches
    daso.global_receive(tree, tree, staleness=1, global_world=16)
    daso.blocking_sync(tree)
    assert comm_kernels.eq1_merge_fwd.launches == k2 + 1
    assert comm_kernels.bf16_pack_fwd.launches == k3 + 1


def test_daso_training_goes_through_the_kernels(cuda):
    """A reduced run on the card: one K2 launch per receive step and one K3
    launch per blocking step (one f32 arena), and the loss falls."""
    cfg = get_reduced("llama3.2-1b").replace(n_layers=2, vocab_size=256)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    src = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, seed=0)

    def data(step):
        b = src.batch(8, step, device=cuda)
        return {k: v.reshape((4, 2) + v.shape[1:]) for k, v in b.items()}

    k2, k3 = comm_kernels.eq1_merge_fwd.launches, comm_kernels.bf16_pack_fwd.launches
    res = run_training(make_lm_loss(cfg), params, data,
                       TrainLoopConfig(n_steps=30, n_replicas=4, device="cuda"), log=None)
    modes = [h[1] for h in res.controller.history]
    assert comm_kernels.eq1_merge_fwd.launches - k2 == \
        sum(m in ("receive", "send_receive") for m in modes) > 0
    assert comm_kernels.bf16_pack_fwd.launches - k3 == modes.count("blocking") > 0
    assert res.losses[-1] < res.losses[0]


# -- int8 codec kernels K5 / K6: bit-exact with their plain versions ------------

INT8_SIZES = [(1, 999, 0), (4, 999, 0), (4, 256 * 37, 0), (2, 256 * 37 + 5, 0),
              (4, 4099, 1), (1, 1, 0), (3, 128 * 5, 1)]


def _bits(cuda, shape, kind, seed):
    if kind == "none":
        return None
    if kind == "random":
        b = np.random.default_rng(seed).integers(0, 2 ** 32, shape, dtype=np.uint64)
    else:
        b = np.full(shape, 0 if kind == "zeros" else 0xFFFFFFFF, np.uint64)
    return torch.from_numpy(b.astype(np.uint32)).to(cuda)


@pytest.mark.parametrize("bits", ["none", "zeros", "ones", "random"])
@pytest.mark.parametrize("block", [64, 128, 256, 100])
@pytest.mark.parametrize("rows,n,offset", INT8_SIZES)
def test_int8_kernels_bit_exact(cuda, rows, n, offset, block, bits):
    x = _arena(cuda, rows * n, rows + n + block, torch.float32, offset).view(rows, n)
    if n >= 4 * block:  # a zero block, a NaN block and an inf block
        x[0, :block] = 0.0
        x[0, block] = float("nan")
        x[-1, 2 * block] = float("inf")
    b = _bits(cuda, (rows, n), bits, block)
    k5 = comm_kernels.quantize_int8_fwd.launches
    k6 = comm_kernels.dequantize_int8_fwd.launches
    v, s = ops.quantize_int8(x, b, block=block)
    vr, sr = quantize_int8_block_ref(x, block=block, bits=b)
    d = ops.dequantize_int8(v, s, block=block)
    torch.cuda.synchronize()
    assert comm_kernels.quantize_int8_fwd.launches == k5 + 1
    assert comm_kernels.dequantize_int8_fwd.launches == k6 + 1
    assert torch.equal(v, vr) and _same_or_nan(s, sr)
    assert _same_or_nan(d, dequantize_int8_block_ref(v, s, block=block))


def test_int8_kernels_take_bf16_arenas(cuda):
    x = _arena(cuda, 3 * 1000, 5, torch.bfloat16).view(3, 1000)
    v, s = ops.quantize_int8(x, block=128)
    vr, sr = quantize_int8_block_ref(x, block=128)
    assert torch.equal(v, vr) and _same_bits(s, sr)


def test_int8_overlap_training_goes_through_the_kernels(cuda):
    """A reduced int8 + overlap run on the card: K5 and K6 once per ov_sync
    and blocking step, K2 once per ov_sync step (one f32 arena)."""
    cfg = get_reduced("llama3.2-1b").replace(n_layers=2, vocab_size=256)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    src = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, seed=0)

    def data(step):
        b = src.batch(8, step, device=cuda)
        return {k: v.reshape((4, 2) + v.shape[1:]) for k, v in b.items()}

    before = {f: f.launches for f in (comm_kernels.quantize_int8_fwd,
                                      comm_kernels.dequantize_int8_fwd,
                                      comm_kernels.eq1_merge_fwd)}
    res = run_training(make_lm_loss(cfg), params, data,
                       TrainLoopConfig(n_steps=30, n_replicas=4, wire_format="int8",
                                       overlap="one_cycle", device="cuda"), log=None)
    modes = [split_ov(h[1])[0] for h in res.controller.history]
    n_sync, n_blocking = modes.count("ov_sync"), modes.count("blocking")
    got = {f: f.launches - n for f, n in before.items()}
    assert got[comm_kernels.quantize_int8_fwd] == n_sync + n_blocking
    assert got[comm_kernels.dequantize_int8_fwd] == n_sync + n_blocking
    assert got[comm_kernels.eq1_merge_fwd] == n_sync > 0
    assert res.losses[-1] < res.losses[0]


def test_overlap_macro_runs_the_exchange_on_its_own_stream(cuda, monkeypatch):
    """A reduced int8 + one_cycle run through both executors: the macro run
    gives the per-step run's losses and carry bit for bit, and K5 runs on a
    stream other than the main one exactly once per overlap cycle (the
    exchange), on the main one for every blocking step."""
    cfg = get_reduced("llama3.2-1b").replace(n_layers=2, vocab_size=256)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    src = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, seed=0)

    def data(step):
        b = src.batch(8, step, device=cuda)
        return {k: v.reshape((4, 2) + v.shape[1:]) for k, v in b.items()}

    main, streams, quantize = torch.cuda.current_stream(), [], ops.quantize_int8

    def spy(*args, **kw):
        streams.append(torch.cuda.current_stream())
        return quantize(*args, **kw)

    monkeypatch.setattr(ops, "quantize_int8", spy)

    def run(executor):
        streams.clear()
        res = run_training(make_lm_loss(cfg), params, data, TrainLoopConfig(
            n_steps=30, n_replicas=4, wire_format="int8", overlap="one_cycle",
            executor=executor, device="cuda"), log=None)
        torch.cuda.synchronize()
        return res, [s != main for s in streams]

    ref, ref_side = run("per_step")
    macro, side = run("macro")
    assert not any(ref_side)
    n_blocking = sum(h[1] == "blocking" for h in macro.controller.history)
    assert sum(side) == macro.executor_stats.overlap_cycles > 0
    assert len(side) - sum(side) == n_blocking
    assert macro.losses == ref.losses
    for a, b in zip(leaves(macro.carry), leaves(ref.carry), strict=True):
        assert torch.equal(a, b)


# -- K7 ssm_scan: within the reference's tolerance of its plain version ----------

# One rule for both dtypes: the kernel and its plain version upcast the same
# bf16 inputs exactly and compute in f32 (tests/test_kernels.py's 5e-2 for
# bf16 is the tolerance between two frameworks)
SCAN_ATOL = 1e-4
# (B, S, Di, N, random h0, dt_rank: Bm / Cm as column views of one
# (B, S, dt_rank + 2N) tensor, or 0 for contiguous Bm / Cm)
SCAN_CASES = [
    (2, 64, 128, 16, False, 0),
    (1, 128, 64, 8, True, 0),
    (3, 37, 100, 4, True, 0),       # bf16: 200-byte rows of x, plain loads
    (2, 1, 8200, 16, True, 0),      # S = 1; Di past a multiple of the block
    (2, 300, 8200, 16, False, 8),   # ragged edge and strided Bm / Cm
    (1, 70, 256, 32, True, 8),
    (2, 300, 512, 12, True, 8),     # N = 12: states that do not fill the lanes
    (2, 65, 200, 1, True, 0),       # N = 1
    (2, 1000, 256, 16, True, 8),    # ring wraps and a ragged last tile
    (3, 77, 1, 16, True, 0),        # Di = 1
    (2, 129, 1024, 16, True, 7),    # odd dt_rank: Bm / Cm off 16-byte boundaries
    (4, 1024, 8192, 16, False, 8),  # the serving prefill's shape
]


def _scan_inputs(cuda, B, S, Di, N, random_h0, dt_rank, dtype, seed):
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(cuda)

    x = f32(B, S, Di).to(dtype)
    dt = torch.nn.functional.softplus(f32(B, S, Di))
    A = -torch.exp(0.5 * f32(Di, N))
    if dt_rank:
        _, Bm, Cm = f32(B, S, dt_rank + 2 * N).to(dtype).split([dt_rank, N, N], dim=-1)
    else:
        Bm, Cm = f32(B, S, N).to(dtype), f32(B, S, N).to(dtype)
    h0 = f32(B, Di, N) if random_h0 else torch.zeros((B, Di, N), device=cuda)
    return x, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Di,N,random_h0,dt_rank", SCAN_CASES)
def test_ssm_scan_kernel_matches_plain(cuda, B, S, Di, N, random_h0, dt_rank, dtype):
    args = _scan_inputs(cuda, B, S, Di, N, random_h0, dt_rank, dtype, seed=S + Di + N)
    before = ssm_scan_fwd.launches
    y, h = ops.ssm_scan(*args)
    torch.cuda.synchronize()
    assert ssm_scan_fwd.launches == before + 1
    assert y.dtype == h.dtype == torch.float32
    yr, hr = ssm_scan_ref(*args)
    assert (y - yr).abs().max().item() <= SCAN_ATOL
    assert (h - hr).abs().max().item() <= SCAN_ATOL


def test_ssm_scan_fills_the_card_in_one_wave(cuda):
    """At falcon-mamba-7b's prefill shape (bf16, B 4, Di 8192, N 16) every
    CTA of K7's grid is resident at once (the occupancy query's CTAs per
    SM), at four lanes per channel and at least 24 warps per SM."""
    cfg = scan_config(ops.kernel_library("ssm_scan"), torch.bfloat16, 16)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    ctas = -(-8192 // cfg["channels_per_cta"]) * 4
    assert cfg["lanes"] == 4 and cfg["threads"] == 4 * cfg["channels_per_cta"]
    assert cfg["ctas_per_sm"] * sms >= ctas
    assert ctas * cfg["threads"] / 32 / sms >= 24


# K7-bwd against the plain backward run in f64, each output's largest error
# scaled to its largest magnitude: 1e-4 for f32 outputs (the f32 plain
# backward sits near 1e-6 there; the kernel sums dBm / dCm over the channels
# and dA over the batch in other orders), one bf16 ulp at the top (2^-7) for
# the bf16 gradients of bf16 x / Bm / Cm
SCAN_BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


def scaled_err(got, want64):
    return ((got.double() - want64).abs().max() / want64.abs().max().clamp_min(1e-300)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Di,N,random_h0,dt_rank", SCAN_CASES)
def test_ssm_scan_bwd_kernel_matches_plain(cuda, B, S, Di, N, random_h0, dt_rank, dtype):
    """K7-bwd (through ops.ssm_scan under autograd and through its binding)
    against `ssm_scan_bwd_ref` in f64 on the same inputs, with a random
    cotangent of y and of h_final; two launches give the same bits."""
    args = _scan_inputs(cuda, B, S, Di, N, random_h0, dt_rank, dtype, seed=S + Di + N + 1)
    g = torch.Generator(device=cuda).manual_seed(S + N)
    dy = torch.randn((B, S, Di), generator=g, device=cuda)
    dh = torch.randn((B, Di, N), generator=g, device=cuda)
    lib = ops.kernel_library("ssm_scan_bwd")
    before = ssm_scan_bwd.launches
    got = ssm_scan_bwd(lib, *args, dy, dh)
    again = ssm_scan_bwd(lib, *args, dy, dh)
    torch.cuda.synchronize()
    assert ssm_scan_bwd.launches == before + 2
    want = ssm_scan_bwd_ref(*(t.double() for t in args), dy.double(), dh.double())
    for name, a, b, w in zip(("dx", "ddt", "dA", "dBm", "dCm", "dh0"), got, again, want):
        assert a.dtype == (dtype if name in ("dx", "dBm", "dCm") else torch.float32)
        assert torch.equal(a, b), f"{name}: two launches differ"
        assert scaled_err(a, w) <= SCAN_BWD_RTOL[a.dtype], (name, scaled_err(a, w))
    # the same through autograd (contiguous copies of the inputs: the views
    # are held above): the kernels launch, and the gradients agree
    leaves = [t.detach().clone().requires_grad_() for t in args]
    before = ssm_scan_fwd.launches, ssm_scan_bwd.launches
    y, h = ops.ssm_scan(*leaves)
    grads = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), leaves)
    torch.cuda.synchronize()
    assert (ssm_scan_fwd.launches, ssm_scan_bwd.launches) == (before[0] + 1, before[1] + 1)
    for name, a, w in zip(("dx", "ddt", "dA", "dBm", "dCm", "dh0"), grads, want):
        assert scaled_err(a, w) <= SCAN_BWD_RTOL[a.dtype], (name, scaled_err(a, w))


def test_mamba_serving_goes_through_the_kernel(cuda):
    """falcon-mamba-7b's widths at 2 layers, f32: one K7 launch per layer per
    prefill and none in decode; prefill + decode agree with a teacher-forced
    forward (tests/test_serve.py's 2e-3); generate returns int32."""
    cfg = get_reduced("falcon-mamba-7b").replace(d_model=4096, vocab_size=65024)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = init_params(cfg, gen, cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen, device=cuda)
    with torch.inference_mode():
        full = forward(params, toks, cfg)["logits"]
        before = ssm_scan_fwd.launches
        st = make_prefill_fn(cfg, cache_len=40)(params, toks[:, :32])
        assert ssm_scan_fwd.launches - before == cfg.n_layers
        decode = make_decode_fn(cfg)
        cache, errs = st["cache"], [(st["logits_last"] - full[:, 31]).abs().max().item()]
        for i in range(32, 40):
            out = decode(params, cache, toks[:, i:i + 1], i)
            errs.append((out["logits"] - full[:, i]).abs().max().item())
        assert ssm_scan_fwd.launches - before == cfg.n_layers  # decode: no K7
    assert max(errs) < 2e-3, errs
    out = Engine(cfg, params, max_len=48).generate(toks[:, :8], 4)
    assert out.shape == (2, 4) and out.dtype == torch.int32


# -- K8 rglru_scan: bit-exact with its plain version ----------------------------

# (B, S, W, random h0): S = 1, a ragged W, the serving prefill's shape
RGLRU_CASES = [
    (2, 64, 128, False),
    (4, 1, 4096, True),
    (2, 300, 4100, True),
    (3, 37, 4100, False),
    (4, 1024, 4096, True),
]


def _rglru_inputs(cuda, B, S, W, random_h0, dtype, seed):
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(cuda)

    a = torch.sigmoid(f32(B, S, W)).to(dtype)
    gx = f32(B, S, W).to(dtype)
    h0 = f32(B, W) if random_h0 else torch.zeros((B, W), device=cuda)
    return a, gx, h0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,W,random_h0", RGLRU_CASES)
def test_rglru_scan_kernel_bit_exact(cuda, B, S, W, random_h0, dtype):
    args = _rglru_inputs(cuda, B, S, W, random_h0, dtype, seed=S + W)
    before = rglru_scan_fwd.launches
    hs, h = ops.rglru_scan(*args)
    torch.cuda.synchronize()
    assert rglru_scan_fwd.launches == before + 1
    hsr, hr = rglru_scan_ref(*args)
    assert torch.equal(hs.view(torch.int32), hsr.view(torch.int32))
    assert torch.equal(h.view(torch.int32), hr.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,W,random_h0", RGLRU_CASES)
def test_rglru_scan_bwd_kernel_bit_exact(cuda, B, S, W, random_h0, dtype):
    """K8-bwd against `rglru_scan_bwd_ref` bit for bit, with and without a
    cotangent of h_final, and through ops.rglru_scan under autograd."""
    a, gx, h0 = _rglru_inputs(cuda, B, S, W, random_h0, dtype, seed=S + W + 1)
    hs, _ = ops.rglru_scan(a, gx, h0)
    g = torch.Generator(device=cuda).manual_seed(S + W)
    dhs = torch.randn((B, S, W), generator=g, device=cuda)
    dh = torch.randn((B, W), generator=g, device=cuda)
    lib = ops.kernel_library("rglru_scan_bwd")
    for cot in (dh, None):
        before = rglru_scan_bwd.launches
        got = rglru_scan_bwd(lib, a, h0, hs, dhs, cot)
        torch.cuda.synchronize()
        assert rglru_scan_bwd.launches == before + 1
        for x, w in zip(got, rglru_scan_bwd_ref(a, gx, h0, hs, dhs, cot), strict=True):
            assert x.dtype == w.dtype and torch.equal(x, w)
    leaves = [t.detach().clone().requires_grad_() for t in (a, gx, h0)]
    hs2, h2 = ops.rglru_scan(*leaves)
    grads = torch.autograd.grad((hs2 * dhs).sum() + (h2 * dh).sum(), leaves)
    for x, w in zip(grads, rglru_scan_bwd_ref(a, gx, h0, hs, dhs, dh), strict=True):
        assert torch.equal(x, w)


def test_rgemma_serving_goes_through_the_kernels(cuda):
    """recurrentgemma-9b's widths at 5 layers (one repeat and the two-layer
    remainder), f32: K8 once per RG-LRU layer and K1 (head_dim 256) once per
    local-attention layer per prefill, neither in decode; prefill + decode
    agree with a teacher-forced forward through the plain paths
    (tests/test_serve.py's 2e-3)."""
    cfg = get_config("recurrentgemma-9b").replace(
        n_layers=5, param_dtype=torch.float32, compute_dtype=torch.float32)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = init_params(cfg, gen, cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen, device=cuda)
    with torch.inference_mode():
        full = forward(params, toks, cfg, attn_impl="plain")["logits"]
        before = rglru_scan_fwd.launches, flash_attention_fwd.launches
        st = make_prefill_fn(cfg, cache_len=40)(params, toks[:, :32])
        launched = (rglru_scan_fwd.launches - before[0],
                    flash_attention_fwd.launches - before[1])
        assert launched == (4, 1)
        decode = make_decode_fn(cfg)
        cache, errs = st["cache"], [(st["logits_last"] - full[:, 31]).abs().max().item()]
        for i in range(32, 40):
            out = decode(params, cache, toks[:, i:i + 1], i)
            errs.append((out["logits"] - full[:, i]).abs().max().item())
        assert (rglru_scan_fwd.launches - before[0],
                flash_attention_fwd.launches - before[1]) == launched
    assert max(errs) < 2e-3, errs
    out = Engine(cfg, params, max_len=48).generate(toks[:, :8], 4)
    assert out.shape == (2, 4) and out.dtype == torch.int32
