"""The port's exchange kernels K2 (Eq. (1) merge), K3 (bf16 pack) and K4
(bf16 unpack) on the CPU, where each wrapper takes its plain version, held
against the JAX package: bit-exact with `repro.kernels.ref.eq1_merge_ref`
and the JAX bf16 casts, and within 1e-6 of the Pallas kernels in interpret
mode (the tolerance of tests/test_flatbuf.py:147-168; the Pallas Eq. (1)
body multiplies by the reciprocal where the reference divides). Inputs are
made from a seed with numpy. The kernels themselves run on the card:
tests/test_torch_card.py."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import daso as jdaso
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.core import daso
from repro_torch.kernels import comm_kernels, ops, ref

# (staleness, global_world, extra_staleness)
WEIGHTS = [(1, 16, 0), (3, 16, 0), (2, 8, 1), (7, 48, 0), (1, 1, 0)]

# f32 values where a bf16 cast can go wrong: ties to even (1 + 2^-8 rounds
# down, 1 + 3 * 2^-8 up), values above the largest bf16 (round to inf),
# infinities, signed zeros and f32 subnormals (XLA's CPU convert keeps
# them, it does not flush them to zero)
EDGES = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 2 ** -8 + 2 ** -16,
                  3.3961e38, 3.3962e38, 3.4e38, -3.4e38, np.inf, -np.inf, 0.0, -0.0,
                  1e-40, -1e-40, 1.4e-45, 1.17e-38, 9e-39, 2.0 ** -133, 1.0, -2.5],
                 np.float32)


def _f32(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _bits(x):
    """The raw bits of a torch or JAX array, for bit-exact comparison."""
    a = x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32).numpy() \
        if isinstance(x, torch.Tensor) else np.asarray(x)
    if a.dtype == ml_dtypes.bfloat16:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,P,E", WEIGHTS)
def test_eq1_merge_bit_exact_with_jax_ref(S, P, E, dtype):
    x, y = _f32(S * 100 + P, (3, 999)), 3 * _f32(E + 7, (3, 999))
    want = jax_ref.eq1_merge_ref(jnp.asarray(x).astype(dtype), jnp.asarray(y).astype(dtype),
                                 staleness=S, global_world=P, extra_staleness=E)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ty = torch.from_numpy(y).to(getattr(torch, dtype))
    for got in (ref.eq1_merge_ref(tx, ty, staleness=S, global_world=P, extra_staleness=E),
                ops.eq1_merge(tx, ty, staleness=S, global_world=P, extra_staleness=E)):
        assert got.dtype == tx.dtype and got.shape == tx.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("S,P,E", WEIGHTS)
def test_eq1_merge_within_1e6_of_pallas(S, P, E):
    x, y = _f32(S, (2, 999)), _f32(P, (2, 999))
    pallas = jax_ops.eq1_merge(jnp.asarray(x), jnp.asarray(y), staleness=S,
                               global_world=P, extra_staleness=E, block=256,
                               interpret=True)
    got = ops.eq1_merge(torch.from_numpy(x), torch.from_numpy(y), staleness=S,
                        global_world=P, extra_staleness=E)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=1e-6, rtol=0)


def test_eq1_weights_round_the_divisor_once_to_f32():
    assert comm_kernels.eq1_weights(3, 16, 1) == (8.0, 16.0, 24.0)
    s2, p, denom = comm_kernels.eq1_weights(1, 10 ** 9 + 1)
    assert denom == float(np.float32(s2 + p)) != s2 + p


@pytest.mark.parametrize("values", ["edges", "normal", "large"])
def test_bf16_pack_bit_exact_with_jax_cast(values):
    x = {"edges": EDGES, "normal": _f32(1, 4099),
         "large": _f32(2, 4099) * np.float32(3e37)}[values]
    want = jnp.asarray(x).astype(jnp.bfloat16)
    pallas = jax_ops.bf16_pack(jnp.asarray(x)[None], block=128, interpret=True)[0]
    for got in (ref.bf16_pack_ref(torch.from_numpy(x)), ops.bf16_pack(torch.from_numpy(x))):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(_bits(got), _bits(pallas))


def test_bf16_pack_keeps_nan_nan():
    x = np.array([np.nan, -np.nan, 1.0], np.float32)
    got = ops.bf16_pack(torch.from_numpy(x))
    assert torch.isnan(got[:2]).all() and got[2].item() == 1.0


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_bf16_unpack_bit_exact_with_jax_cast(out):
    x = np.concatenate([EDGES, _f32(3, 1001)])
    wire_j = jnp.asarray(x).astype(jnp.bfloat16)
    wire_t = torch.from_numpy(x).to(torch.bfloat16)
    want = wire_j.astype(out)
    pallas = jax_ops.bf16_unpack(wire_j[None], out_dtype=getattr(jnp, out), block=128,
                                 interpret=True)[0]
    for got in (ref.bf16_unpack_ref(wire_t, getattr(torch, out)),
                ops.bf16_unpack(wire_t, getattr(torch, out))):
        assert got.dtype == getattr(torch, out)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(_bits(got), _bits(pallas))


def test_bf16_pack_of_a_bf16_arena_is_the_identity():
    x = torch.from_numpy(_f32(4, 77)).to(torch.bfloat16)
    assert torch.equal(ops.bf16_pack(x), x)


def test_bf16_unpack_defaults_to_float32():
    x = torch.from_numpy(_f32(5, 9)).to(torch.bfloat16)
    assert ops.bf16_unpack(x).dtype == torch.float32


def test_wrappers_check_their_inputs_on_every_device():
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="differ"):
        ops.eq1_merge(x, torch.zeros(9), staleness=1, global_world=4)
    with pytest.raises(ValueError, match="differ"):
        ops.eq1_merge(x, x.to(torch.bfloat16), staleness=1, global_world=4)
    with pytest.raises(TypeError):
        ops.eq1_merge(x.long(), x.long(), staleness=1, global_world=4)
    with pytest.raises(ValueError, match="contiguous"):
        ops.bf16_pack(torch.zeros(4, 4).T)
    with pytest.raises(TypeError):
        ops.bf16_pack(x.double())
    with pytest.raises(TypeError):
        ops.bf16_unpack(x)  # the wire is bf16
    with pytest.raises(TypeError):
        ops.bf16_unpack(x.to(torch.bfloat16), torch.float16)


def test_wrappers_raise_on_a_device_without_a_kernel():
    """Only CPU tensors take the plain version; any other device reaches the
    kernel (CUDA) or raises."""
    m = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.eq1_merge(m, m, staleness=1, global_world=4)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.bf16_pack(m)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.bf16_unpack(m.to(torch.bfloat16))


def test_launchers_refuse_cpu_tensors():
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        comm_kernels.eq1_merge_fwd(None, x, x, staleness=1, global_world=4)
    with pytest.raises(ValueError, match="CUDA"):
        comm_kernels.bf16_pack_fwd(None, x)


# -- subnormals: the port keeps IEEE subnormals, XLA on the CPU flushes them --
#
# XLA's CPU backend (as the TPU) treats subnormal f32 / bf16 inputs as zero and
# flushes subnormal results to a signed zero; the port's plain versions and
# kernels keep them (IEEE, nvcc's -ftz=false). These tests hold the port to
# numpy's IEEE f32 arithmetic and the JAX reference to the same arithmetic
# with every input and result flushed, so the split stays visible (ROADMAP §3).

TINY = np.finfo(np.float32).tiny
# x, y pairs: subnormal y beside a normal x, a subnormal result of normal
# inputs, subnormal inputs, and normal control pairs (last two)
SUB_X = np.float32([1e-36, 1.2e-38, 1e-40, 3e-39, -1e-39, -1.2e-38, 1.0, -2.5e-38])
SUB_Y = np.float32([-9e-39, 0.0, 1e-40, 0.0, 5e-39, 0.0, 1.0, 1e-30])
SUBNORMAL_AT = [True] * 6 + [False] * 2


def _ftz(v):
    """v (f32) with subnormals flushed to a zero of their sign."""
    v = np.asarray(v, np.float32)
    return np.where(np.abs(v) < TINY, np.copysign(np.float32(0), v), v).astype(np.float32)


def _as_f32(a, dtype):
    """f32 values of `a` after a cast to `dtype` (float32 or bfloat16)."""
    return a if dtype == "float32" else a.astype(ml_dtypes.bfloat16).astype(np.float32)


def _to(a, dtype):
    return a if dtype == "float32" else a.astype(ml_dtypes.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eq1_merge_keeps_subnormals_where_jax_cpu_flushes(dtype):
    x, y = _as_f32(SUB_X, dtype), _as_f32(SUB_Y, dtype)
    s2, p, d = np.float32(2), np.float32(16), np.float32(18)
    ieee = _to((s2 * x + p * y) / d, dtype)
    flushed = _to(_ftz(_ftz(_ftz(s2 * _ftz(x)) + _ftz(p * _ftz(y))) / d), dtype)
    tx, ty = (torch.from_numpy(x).to(getattr(torch, dtype)),
              torch.from_numpy(y).to(getattr(torch, dtype)))
    for got in (ref.eq1_merge_ref(tx, ty, staleness=1, global_world=16),
                ops.eq1_merge(tx, ty, staleness=1, global_world=16)):
        np.testing.assert_array_equal(_bits(got), _bits(ieee))
    jax_out = jax_ref.eq1_merge_ref(jnp.asarray(_to(x, dtype)), jnp.asarray(_to(y, dtype)),
                                    staleness=1, global_world=16)
    np.testing.assert_array_equal(_bits(jax_out), _bits(flushed))
    split = _bits(jax_out) != _bits(ieee)
    np.testing.assert_array_equal(split, SUBNORMAL_AT)


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_replica_mean_keeps_subnormals_where_jax_cpu_flushes(wire):
    """(R, N) = (4, 5) rows: column 0 all subnormal, column 2 subnormal
    values, column 4 a subnormal sum of normal values; columns 1 and 3
    normal. The port's mean is the chain of adds in the wire dtype times
    1/R; the reference's `lax.reduce` starts from 0."""
    rows = np.float32([[1e-39, 1.0, 3e-39, 1.2e-38, 2e-38],
                       [1e-39, 1.0, 1e-39, 1.2e-38, -1.5e-38],
                       [1e-39, 1.0, -1e-39, 1.2e-38, 0.0],
                       [1e-39, 1.0, 2e-39, 1.2e-38, 0.0]])
    dtype = "float32" if wire == "f32" else "bfloat16"

    def mean(flush):
        f = _ftz if flush else (lambda v: v)
        w = f(_as_f32(rows, dtype))
        acc = f(np.zeros_like(w[0]) + w[0]) if flush else w[0]
        for row in w[1:]:
            acc = f(_as_f32(acc + row, dtype))
        return _as_f32(f(acc * _as_f32(np.float32(0.25), dtype)), dtype)

    got = daso.replica_mean({"w": torch.from_numpy(rows)}, wire_format=wire)["w"]
    want = jdaso.replica_mean({"w": jnp.asarray(rows)}, wire_format=wire)["w"]
    np.testing.assert_array_equal(_bits(got), np.broadcast_to(_bits(mean(False)), (4, 5)))
    np.testing.assert_array_equal(_bits(want), np.broadcast_to(_bits(mean(True)), (4, 5)))
    split = _bits(got[0]) != _bits(want[0])
    np.testing.assert_array_equal(split, [True, False, True, False, True])


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_fused_mean_splits_from_the_reference_per_leaf_mean_on_subnormals(wire):
    """The reference's per-leaf mean (impl="per_leaf") flushes subnormals as
    its fused mean does; the port's fused mean keeps them, so it splits
    from the per-leaf one where it splits from the fused one."""
    rows = np.float32([[1e-39, 1.0, 3e-39, 1.2e-38, 2e-38],
                       [1e-39, 1.0, 1e-39, 1.2e-38, -1.5e-38],
                       [1e-39, 1.0, -1e-39, 1.2e-38, 0.0],
                       [1e-39, 1.0, 2e-39, 1.2e-38, 0.0]])
    jw = {"w": jnp.asarray(rows)}
    got = daso.replica_mean({"w": torch.from_numpy(rows)}, wire_format=wire)["w"]
    want = jdaso.replica_mean(jw, wire_format=wire, impl="per_leaf")["w"]
    np.testing.assert_array_equal(_bits(want),
                                  _bits(jdaso.replica_mean(jw, wire_format=wire)["w"]))
    split = _bits(got[0]) != _bits(want[0])
    np.testing.assert_array_equal(split, [True, False, True, False, True])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_merge_keeps_subnormals_where_the_reference_per_leaf_merge_flushes(dtype):
    x, y = _as_f32(SUB_X, dtype), _as_f32(SUB_Y, dtype)
    s2, p, d = np.float32(2), np.float32(16), np.float32(18)
    ieee = _to((s2 * x + p * y) / d, dtype)
    flushed = _to(_ftz(_ftz(_ftz(s2 * _ftz(x)) + _ftz(p * _ftz(y))) / d), dtype)
    tx, ty = (torch.from_numpy(x).to(getattr(torch, dtype)),
              torch.from_numpy(y).to(getattr(torch, dtype)))
    got = daso.global_receive({"w": tx}, {"w": ty}, staleness=1, global_world=16)["w"]
    np.testing.assert_array_equal(_bits(got), _bits(ieee))
    want = jdaso.global_receive_per_leaf(
        {"w": jnp.asarray(_to(x, dtype))}, {"w": jnp.asarray(_to(y, dtype))}, staleness=1,
        global_world=16)["w"]
    np.testing.assert_array_equal(_bits(want), _bits(flushed))
    np.testing.assert_array_equal(_bits(want) != _bits(ieee), SUBNORMAL_AT)
