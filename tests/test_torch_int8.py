"""The port's int8 wire tier held against the JAX package on the CPU, where
the K5 / K6 wrappers take their plain versions (`repro_torch.kernels.ref`):

  * the codec (`quantize_int8_block_ref`, `dequantize_int8_block_ref`,
    `ops.quantize_int8`, `ops.dequantize_int8`) bit-exact with
    `repro.kernels.ref` in values and scales, with and without the same
    stochastic-rounding bits, at ragged N, leading rows, blocks 64 / 128 /
    256 and edge blocks;
  * against the Pallas K5 in interpret mode: scales within 1 ULP and values
    within +-1 (tests/test_flatbuf.py:171), and at least one block whose
    scale differs, the split PERF.md documents (XLA multiplies by 1/127
    where the reference and the port divide);
  * twins of tests/test_flatbuf.py's int8 tests (error bound, unbiased
    stochastic rounding, transfer bytes, int8 halves bf16);
  * the flat-buffer wire functions and `replica_mean(..., wire_format=
    "int8")` bit-exact with the reference's plain path
    (`exchange_kernels=False`), at R = 2, 3, 4 and on a tree mixing f32,
    bf16 and int leaves.
Inputs are made from a seed with numpy. The kernels themselves run on the
card: tests/test_torch_card.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from repro.core import compression as jcomp
from repro.core import daso as jdaso
from repro.core import flatbuf as jfb
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.core import compression, daso, flatbuf
from repro_torch.kernels import comm_kernels, ops, ref
from repro_torch.tree import leaves

EDGE_BITS = np.array([0, 0xFF, 0x100, 0xFFFFFFFF], np.uint32)


def _x(seed, shape, scale=4.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _bits(seed, shape):
    b = np.random.default_rng(seed).integers(0, 2 ** 32, shape, dtype=np.uint64)
    b = b.astype(np.uint32)
    b.reshape(-1)[:len(EDGE_BITS)] = EDGE_BITS[:b.size]
    return b


def _f32_bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32)


def _jax_codec(x, bits, block):
    v, s = jax_ref.quantize_int8_block_ref(jnp.asarray(x), block=block,
                                           bits=None if bits is None else jnp.asarray(bits))
    return np.asarray(v), np.asarray(s), np.asarray(
        jax_ref.dequantize_int8_block_ref(v, s, block=block))


SHAPES = [(999,), (2, 777), (4, 4099), (3, 2, 130), (1, 256), (2, 1), (4, 1024)]


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("block", [64, 128, 256])
@pytest.mark.parametrize("shape", SHAPES)
def test_codec_bit_exact_with_jax_ref(shape, block, stochastic):
    x = _x(sum(shape) + block, shape)
    bits = _bits(block, shape) if stochastic else None
    wv, ws, wd = _jax_codec(x, bits, block)
    tb = None if bits is None else torch.from_numpy(bits)
    for quantize, dequantize in ((ref.quantize_int8_block_ref, ref.dequantize_int8_block_ref),
                                 (ops.quantize_int8, ops.dequantize_int8)):
        if quantize is ops.quantize_int8:
            v, s = quantize(torch.from_numpy(x), tb, block=block)
        else:
            v, s = quantize(torch.from_numpy(x), block=block, bits=tb)
        assert v.dtype == torch.int8 and v.shape == x.shape and v.is_contiguous()
        assert s.dtype == torch.float32 and s.shape == ws.shape
        np.testing.assert_array_equal(v.numpy(), wv)
        np.testing.assert_array_equal(_f32_bits(s), _f32_bits(ws))
        np.testing.assert_array_equal(_f32_bits(dequantize(v, s, block=block)),
                                      _f32_bits(wd))


def test_bf16_input_quantizes_as_f32():
    x = _x(5, (3, 500))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wv, ws, _ = _jax_codec(np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                                      .astype(jnp.float32)), None, 128)
    v, s = ops.quantize_int8(xb, block=128)
    np.testing.assert_array_equal(v.numpy(), wv)
    np.testing.assert_array_equal(_f32_bits(s), _f32_bits(ws))


def _edge_arena(block):
    """Eight edge blocks of one row, zero but for the values listed: all
    zeros, exact ties after scaling (absmax 127: scale 1.0), +-absmax,
    subnormals only, 3e38, +inf, -inf, NaN; then random blocks."""
    x = _x(7, (2, 9 * block + 37))
    groups = [[0.0], [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5, -127.0, 3.5],
              [-5.0, 5.0, 2.0, -1.0], [1e-40, -1e-40, 1.4e-45, -9e-39, 1.17e-38],
              [3e38, -3e38, 1.0, -2.5e37], [np.inf, 1.0, -2.0], [-np.inf, 3.0],
              [np.nan, 1.0, -4.0]]
    for i, g in enumerate(groups):
        x[0, i * block:(i + 1) * block] = 0.0
        x[0, i * block:i * block + len(g)] = g
    return x


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("block", [64, 128, 256])
def test_edge_blocks_bit_exact_and_stated_values(block, stochastic):
    x = _edge_arena(block)
    bits = _bits(3, x.shape) if stochastic else None
    wv, ws, _ = _jax_codec(x, bits, block)
    v, s = ops.quantize_int8(torch.from_numpy(x),
                             None if bits is None else torch.from_numpy(bits), block=block)
    # scales bit-exact, NaN where the block holds NaN (payloads may differ)
    nan = np.isnan(ws)
    np.testing.assert_array_equal(np.isnan(s.numpy()), nan)
    np.testing.assert_array_equal(_f32_bits(s)[~nan], _f32_bits(ws)[~nan])
    # The values of a block with an inf or a NaN are x / scale = NaN cast
    # to int8, which the reference leaves undefined (XLA's CPU convert
    # happens to give 0): compared with the reference only elsewhere. The
    # port's stated rule is 0.
    finite = np.repeat(np.isfinite(ws) & np.isfinite(
        np.pad(x, ((0, 0), (0, -x.shape[1] % block))).reshape(
            x.shape[0], -1, block)).all(-1), block, axis=-1)[:, :x.shape[1]]
    np.testing.assert_array_equal(v.numpy()[finite], wv[finite])
    for b in (5, 6, 7):
        assert not v[0, b * block:(b + 1) * block].any()
    assert s[0, 0].item() == np.float32(np.float32(1e-12) / np.float32(127.0))
    assert s[0, 1].item() == 1.0 and np.isinf(s[0, 5].item())
    if not stochastic:  # round half to even; +-absmax -> +-127
        assert v[0, block:block + 10].tolist() == [127, 0, 2, 2, 0, -2, 126, -126, -127, 4]
        assert v[0, 2 * block:2 * block + 2].tolist() == [-127, 127]
        assert v[0, 4 * block:4 * block + 2].tolist() == [127, -127]


def test_stochastic_bits_edges_give_floor_and_ceil():
    """u = (bits >> 8) * 2^-24: bits 0xFF give u = 0 (floor), 0xFFFFFFFF
    the largest u below 1 (a ceiling for non-integers)."""
    x = np.zeros((1, 256), np.float32)
    x[0, :3] = [127.0, 2.25, -2.25]   # scale 1.0
    for word, want in ((0xFF, [127, 2, -3]), (0x100, [127, 2, -3]),
                       (0xFFFFFFFF, [127, 3, -2])):
        bits = np.full(x.shape, word, np.uint32)
        v, _ = ops.quantize_int8(torch.from_numpy(x), torch.from_numpy(bits))
        assert v[0, :3].tolist() == want, hex(word)
        np.testing.assert_array_equal(v.numpy(), _jax_codec(x, bits, 256)[0])


@pytest.mark.parametrize("source", ["planning_input", "numpy"])
def test_within_one_ulp_of_pallas_and_the_split_shows(source):
    """The Pallas K5 in interpret mode computes absmax / 127 as a
    reciprocal multiply: its scales are within 1 ULP of the port's (which
    divides, as the reference does), its values within +-1, and on these
    inputs at least one block's scale differs."""
    if source == "planning_input":  # tests/test_flatbuf.py:171's input
        x = np.array(jax.random.normal(jax.random.PRNGKey(5), (2, 777)) * 4)
        blocks = (128,)
    else:
        x = _x(0, (4, 4099))
        blocks = (64, 128, 256)
    for block in blocks:
        pv, ps = jax_ops.quantize_int8(jnp.asarray(x), block=block)
        v, s = ops.quantize_int8(torch.from_numpy(x), block=block)
        ulps = np.abs(_f32_bits(s).astype(np.int64) - _f32_bits(ps).astype(np.int64))
        print(f"K5 scales off the Pallas kernel's, {source}, block {block}: "
              f"{int((ulps > 0).sum())} of {ulps.size}")  # PERF.md cites them (pytest -s)
        assert ulps.max() <= 1
        assert ulps.sum() >= 1, "no scale differs: the documented split is gone"
        assert np.abs(v.numpy().astype(np.int32) - np.asarray(pv, np.int32)).max() <= 1


# -- twins of tests/test_flatbuf.py's int8 tests ---------------------------------

@given(st.sampled_from([64, 128, 256]), st.integers(1, 2000), st.booleans())
@example(256, 1404, True)  # x[3] / scale = -127 in f32, bits 0xFFFFFFFF
@settings(max_examples=20, deadline=None)
def test_int8_quantize_error_bounds_property(block, n, stochastic):
    """|x - deq(q(x))| <= scale / 2 rounding to nearest, < scale
    stochastically (tests/test_flatbuf.py:105). The example is a block
    absmax whose f32 sum v + u rounds up to the next integer."""
    x = _x(block + n, (n,), scale=1.0 + n % 7)
    bits = torch.from_numpy(_bits(n, (n,))) if stochastic else None
    v, s = ops.quantize_int8(torch.from_numpy(x), bits, block=block)
    d = ops.dequantize_int8(v, s, block=block).numpy()
    bound = np.repeat(s.numpy(), block)[:n]
    err = np.abs(d - x)
    assert np.all(err <= (bound if stochastic else bound / 2) + 1e-6)
    assert s.shape[-1] == -(-n // block)


def test_int8_stochastic_rounding_is_unbiased():
    """tests/test_flatbuf.py:126: the mean of many stochastic draws
    converges to x; rounding to nearest keeps a bias."""
    x = np.full(256, 0.325, np.float32)
    x[0] = 12.7  # the block scale 12.7 / 127 = 0.1
    tx = torch.from_numpy(x)
    det = ops.dequantize_int8(*ops.quantize_int8(tx)).numpy()[1:]
    assert abs(det.mean() - 0.325) > 0.02
    rng = np.random.default_rng(0)
    acc = 0.0
    for _ in range(200):
        bits = torch.from_numpy(rng.integers(0, 2 ** 32, 256, dtype=np.uint64)
                                .astype(np.uint32))
        acc += ops.dequantize_int8(*ops.quantize_int8(tx, bits)).numpy()[1:].mean()
    assert abs(acc / 200 - 0.325) < 0.005


def _byte_trees():
    np_tree = {"w": np.zeros(100, np.float32), "b": np.zeros(10, np.float32),
               "step": np.zeros(3, np.int32)}
    jtree = {k: jnp.asarray(v) for k, v in np_tree.items()}
    jtree["b"] = jtree["b"].astype(jnp.bfloat16)
    ttree = {k: torch.from_numpy(v) for k, v in np_tree.items()}
    ttree["b"] = ttree["b"].to(torch.bfloat16)
    return jtree, ttree


@pytest.mark.parametrize("wire,block", [("f32", 256), ("bf16", 256), ("int8", 64),
                                        ("int8", 256), ("f16", 256)])
def test_transfer_bytes_matches_jax(wire, block):
    """tests/test_flatbuf.py:190, and the reference's own number for every
    tier."""
    jtree, ttree = _byte_trees()
    got = compression.transfer_bytes(ttree, wire_format=wire, int8_block=block)
    assert got == jcomp.transfer_bytes(jtree, wire_format=wire, int8_block=block)
    want = {"f32": 100 * 4 + 10 * 2 + 12, "bf16": 110 * 2 + 12, "f16": 110 * 2 + 12}
    if wire in want:
        assert got == want[wire]
    if (wire, block) == ("int8", 64):
        assert got == (100 + 4 * 2) + (10 + 4 * 1) + 12
    pair = {"a": torch.zeros(10), "b": torch.zeros(10)}  # blocks span leaves
    assert compression.transfer_bytes(pair, wire_format="int8", int8_block=64) == 24
    with pytest.raises(ValueError):
        compression.transfer_bytes(ttree, wire_format="f8")


def test_int8_wire_halves_bf16_bytes():
    """tests/test_flatbuf.py:212."""
    tree = {f"w{i}": torch.zeros(4096) for i in range(8)}
    b16 = compression.transfer_bytes(tree, wire_format="bf16")
    i8 = compression.transfer_bytes(tree, wire_format="int8", int8_block=256)
    assert i8 <= b16 * 0.51
    assert compression.wire_itemsize("int8", int8_block=256) == pytest.approx(1 + 4 / 256)
    assert compression.wire_itemsize("int8") == jcomp.wire_itemsize("int8")


# -- validation ------------------------------------------------------------------

@pytest.mark.parametrize("rows,n_blocks", [(4, 37), (1, 1), (3, 8)])
def test_dequantize_library_call_bit_exact_on_full_blocks(rows, n_blocks):
    """K6's yardstick on the card, one broadcast product through views
    (`torch.mul(values.view(rows, -1, 256), scales.unsqueeze(-1))`), is
    bit-exact with the plain version and the JAX reference where every
    block is full, as on the training arena: int8 -> f32 is exact and the
    product rounds once."""
    x = _x(rows * n_blocks, (rows, 256 * n_blocks), scale=3e3)
    x[0, :256] = 0.0  # a block at the scale floor
    v, s = ref.quantize_int8_block_ref(torch.from_numpy(x))
    library = torch.mul(v.view(rows, -1, 256), s.unsqueeze(-1)).view(rows, -1)
    np.testing.assert_array_equal(_f32_bits(library),
                                  _f32_bits(ref.dequantize_int8_block_ref(v, s)))
    jax_out = jax_ref.dequantize_int8_block_ref(jnp.asarray(v.numpy()), jnp.asarray(s.numpy()),
                                                block=256)
    np.testing.assert_array_equal(_f32_bits(library), _f32_bits(jax_out))


def test_codec_validation_on_every_device():
    x = torch.zeros(2, 300)
    with pytest.raises(TypeError, match="uint32"):
        ops.quantize_int8(x, torch.zeros(2, 300, dtype=torch.int32))
    with pytest.raises(TypeError, match="uint32"):
        ops.quantize_int8(x, torch.zeros(300, dtype=torch.int32).view(torch.uint32))
    with pytest.raises(TypeError, match="dtype"):
        ops.quantize_int8(x.double())
    with pytest.raises(ValueError, match="block"):
        ops.quantize_int8(x, block=0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.quantize_int8(x.t())
    v, s = ops.quantize_int8(x, block=128)
    assert s.shape == (2, 3)
    with pytest.raises(ValueError, match="scales"):
        ops.dequantize_int8(v, s, block=256)
    with pytest.raises(TypeError, match="int8"):
        ops.dequantize_int8(v.int(), s, block=128)
    m = torch.zeros(2, 300, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.quantize_int8(m)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.dequantize_int8(v.to("meta"), s.to("meta"), block=128)
    with pytest.raises(ValueError, match="needs CUDA"):
        comm_kernels.quantize_int8_fwd(None, x)
    with pytest.raises(ValueError, match="unknown wire_format"):
        flatbuf.encode_wire(x, "fp8")


def test_random_bits_from_a_generator():
    a = flatbuf.random_bits((3, 5), torch.Generator().manual_seed(1))
    b = flatbuf.random_bits((3, 5), torch.Generator().manual_seed(1))
    assert a.dtype == torch.uint32 and a.shape == (3, 5) and torch.equal(a, b)
    x = torch.from_numpy(_x(1, (3, 5)))
    got = flatbuf.encode_wire(x, "int8", generator=torch.Generator().manual_seed(1))
    want = ops.quantize_int8(x, a)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="not both"):
        flatbuf.encode_wire(x, "int8", bits=a, generator=torch.Generator())


# -- the wire functions and the int8 exchange --------------------------------------

def _jax_bits(key_seed, shape):
    return np.asarray(jax.random.bits(jax.random.PRNGKey(key_seed), shape, jnp.uint32))


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("block", [64, 256])
def test_wire_functions_bit_exact(block, stochastic):
    """encode / decode / roundtrip against the reference's plain path; with
    stochastic rounding the port is given the bits the reference draws from
    its rng_key."""
    x = _x(11, (3, 1000), scale=30.0)
    key = jax.random.PRNGKey(4) if stochastic else None
    bits = torch.from_numpy(_jax_bits(4, x.shape)) if stochastic else None
    jv, js = jfb.encode_wire(jnp.asarray(x), "int8", int8_block=block, rng_key=key)
    tv, ts = flatbuf.encode_wire(torch.from_numpy(x), "int8", int8_block=block, bits=bits)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(_f32_bits(ts), _f32_bits(js))
    for dtype in ("float32", "bfloat16"):
        want = jfb.decode_wire((jv, js), "int8", getattr(jnp, dtype), int8_block=block)
        got = flatbuf.decode_wire((tv, ts), "int8", getattr(torch, dtype), int8_block=block)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    np.testing.assert_array_equal(
        _f32_bits(flatbuf.wire_roundtrip(torch.from_numpy(x), "int8", int8_block=block,
                                         bits=bits)),
        _f32_bits(jfb.wire_roundtrip(jnp.asarray(x), "int8", int8_block=block,
                                     rng_key=key)))


def _mixed_tree(R, seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((R, 7, 90)) * 3).astype(np.float32),
            "b": [(rng.standard_normal((R, 300))).astype(np.float32),
                  (rng.standard_normal((R, 40)) * 2).astype(np.float32)],
            "h": (rng.standard_normal((R, 5, 60))).astype(np.float32),
            "step": rng.integers(0, 50, (R, 3)).astype(np.int32)}


def _as_jax(tree):
    out = jax.tree.map(jnp.asarray, tree)
    out["h"] = out["h"].astype(jnp.bfloat16)
    return out


def _as_torch(tree):
    out = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
    out["h"] = out["h"].to(torch.bfloat16)
    return out


def _assert_leaves_equal(got, want):
    g, w = leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == tuple(b.shape) and str(a.dtype) == f"torch.{b.dtype}"
        np.testing.assert_array_equal(a.float().numpy() if a.is_floating_point()
                                      else a.numpy(), np.asarray(b, np.float32)
                                      if jnp.issubdtype(b.dtype, jnp.floating)
                                      else np.asarray(b))


def test_tree_wire_roundtrip_bit_exact():
    tree = _mixed_tree(2, 5)
    want = jfb.tree_wire_roundtrip(_as_jax(tree), "int8", batch_dims=1, int8_block=128)
    got = flatbuf.tree_wire_roundtrip(_as_torch(tree), "int8", batch_dims=1,
                                      int8_block=128)
    _assert_leaves_equal(got, want)
    # the same bits per arena give the reference's stochastic roundtrip
    key = jax.random.PRNGKey(9)
    jt = _as_jax(tree)
    layout = jfb.build_layout(jt, batch_dims=1)
    bits = {k: torch.from_numpy(_jax_bits(9, (2, n))) for k, n in layout.arena_sizes.items()
            if k != "int32"}
    want = jfb.tree_wire_roundtrip(jt, "int8", batch_dims=1, rng_key=key)
    got = flatbuf.tree_wire_roundtrip(_as_torch(tree), "int8", batch_dims=1, bits=bits)
    _assert_leaves_equal(got, want)


@pytest.mark.parametrize("R", [2, 3, 4])
def test_replica_mean_int8_bit_exact(R):
    """Each replica's row through K5 -> K6, then the chain mean in the
    arena's dtype, against the reference's plain (exchange_kernels=False)
    path, on a tree of f32, bf16 and int32 leaves."""
    tree = _mixed_tree(R, R)
    for block in (64, 256):
        want = jdaso.replica_mean(_as_jax(tree), wire_format="int8", int8_block=block)
        got = daso.replica_mean(_as_torch(tree), wire_format="int8", int8_block=block)
        _assert_leaves_equal(got, want)
        for fn in ("global_send", "blocking_sync"):
            want = getattr(jdaso, fn)(_as_jax(tree), wire_format="int8", int8_block=block)
            got = getattr(daso, fn)(_as_torch(tree), wire_format="int8", int8_block=block)
            _assert_leaves_equal(got, want)


def test_int8_config_refusals_match_the_reference():
    with pytest.raises(ValueError, match="fused"):
        jdaso.DasoConfig(n_replicas=4, global_world=16, wire_format="int8",
                         exchange_impl="per_leaf")
    with pytest.raises(ValueError, match="fused"):
        daso.DasoConfig(n_replicas=4, global_world=16, wire_format="int8",
                        exchange_impl="per_leaf")
    cfg = daso.DasoConfig(n_replicas=4, global_world=16, wire_format="int8")
    assert cfg.wire_format_for(blocking=True) == cfg.wire_format_for(blocking=False) == "int8"
