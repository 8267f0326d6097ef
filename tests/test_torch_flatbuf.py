"""The port's flat-buffer arenas (`repro_torch.core.flatbuf`) held against
the JAX package's `repro.core.flatbuf` on the CPU, bit-exact throughout:
layout and pack / unpack on the quickstart parameter tree, the arena means
(the chain order of the replica reduction, f32 and bf16, R = 2, 3, 4) and
the f32 / bf16 wire codecs (the int8 tier: tests/test_torch_int8.py).
Inputs are made from a seed with numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core import flatbuf as jfb
from repro.models.lm import init_params as jax_init_params
from repro_torch.core import flatbuf
from repro_torch.tree import flatten, leaves


def _quickstart_tree():
    """The JAX package's quickstart parameters (examples/quickstart.py)."""
    cfg = jax_get_reduced("llama3.2-1b").replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
        vocab_size=256)
    return jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(0)))


def _to_torch(tree):
    """Same structure, torch leaves (bf16 through f32, exact)."""
    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree.map(leaf, tree)


def _bits(x):
    """The raw bits of a torch or JAX array, so -0.0 differs from 0.0."""
    if isinstance(x, torch.Tensor):
        return x.view({2: torch.int16, 4: torch.int32}[x.element_size()]).numpy()
    a = np.asarray(x)
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _replicated(tree, R, seed):
    """(R, ...) leaves: the tree plus a different perturbation per replica."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a[None] + 0.01 * rng.standard_normal(
        (R,) + a.shape)).astype(a.dtype), tree)


@pytest.mark.parametrize("batch_dims", [0, 1])
def test_layout_and_pack_bit_exact_on_quickstart_tree(batch_dims):
    tree = _quickstart_tree()
    if batch_dims:
        tree = _replicated(tree, 4, seed=0)
    jl = jfb.build_layout(jax.tree.map(jnp.asarray, tree), batch_dims=batch_dims)
    tl = flatbuf.build_layout(_to_torch(tree), batch_dims=batch_dims)
    assert tl.arena_sizes == jl.arena_sizes and tl.batch_shape == jl.batch_shape
    assert [(s.arena, s.offset, s.size, s.shape) for s in tl.slots] == \
        [(s.arena, s.offset, s.size, s.shape) for s in jl.slots]
    want = jfb.pack(jax.tree.map(jnp.asarray, tree), jl)
    got = flatbuf.pack(_to_torch(tree), tl)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]))


def test_unpack_inverts_pack_with_views():
    ttree = _to_torch(_replicated(_quickstart_tree(), 3, seed=1))
    layout = flatbuf.build_layout(ttree, batch_dims=1)
    arenas = flatbuf.pack(ttree, layout)
    back = flatbuf.unpack(arenas, layout)
    for a, b in zip(leaves(ttree), leaves(back)):
        assert torch.equal(a, b)
        assert b.untyped_storage().data_ptr() == \
            arenas[flatbuf.dtype_name(b.dtype)].untyped_storage().data_ptr()
    assert flatten(back)[1] == flatten(ttree)[1]


def test_arenas_group_leaves_by_dtype():
    tree = {"a": torch.ones(2, 3), "b": torch.ones(2, 5, dtype=torch.bfloat16),
            "c": torch.arange(4).reshape(2, 2).int()}
    layout = flatbuf.build_layout(tree, batch_dims=1)
    assert layout.arena_sizes == {"float32": 3, "bfloat16": 5, "int32": 2}
    with pytest.raises(ValueError, match="batch shape"):
        flatbuf.build_layout({"a": torch.ones(2, 3), "b": torch.ones(3, 3)},
                             batch_dims=1)
    with pytest.raises(ValueError, match="empty"):
        flatbuf.build_layout({})


@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R", [2, 3, 4])
def test_masked_axis0_mean_bit_exact_pins_the_chain_order(R, dtype, deterministic):
    """Both JAX tiers (lax.reduce and the explicit chain) reduce in replica
    order on the CPU; a torch.sum of bf16 would accumulate in f32."""
    x = np.random.default_rng(R).standard_normal((R, 20000), dtype=np.float32)
    x[:, :7] *= np.float32(1e4)  # wide exponents, where a chain order shows
    ja = jnp.asarray(x).astype(dtype)
    ta = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jfb.masked_axis0_mean(ja, None, deterministic)
    got = flatbuf.masked_axis0_mean(ta)
    assert got.shape == (1, 20000) and got.dtype == ta.dtype
    np.testing.assert_array_equal(_np(got), _np(want))


def test_chain_axis0_sum_bit_exact():
    x = np.random.default_rng(3).standard_normal((5, 1000), dtype=np.float32)
    np.testing.assert_array_equal(
        flatbuf.chain_axis0_sum(torch.from_numpy(x)).numpy(),
        np.asarray(jfb.chain_axis0_sum(jnp.asarray(x))))


# bf16 ties (1 + 2^-8 rounds down, 1 + 3 * 2^-8 up), values above the
# largest bf16, infinities, signed zeros and f32 subnormals
EDGES = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 3.3962e38, 3.4e38,
                  -3.4e38, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1.4e-45, 9e-39],
                 np.float32)


@pytest.mark.parametrize("values", ["normal", "edges"])
@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_wire_codecs_bit_exact(wire, values):
    x = 50 * np.random.default_rng(4).standard_normal((3, 777), dtype=np.float32)
    if values == "edges":
        x[1, 100:100 + len(EDGES)] = EDGES
    ja, ta = jnp.asarray(x), torch.from_numpy(x)
    enc_j = jfb.encode_wire(ja, wire)
    enc_t = flatbuf.encode_wire(ta, wire)
    assert str(enc_t.dtype) == f"torch.{enc_j.dtype}"
    np.testing.assert_array_equal(_bits(enc_t), _bits(enc_j))
    np.testing.assert_array_equal(
        _bits(flatbuf.decode_wire(enc_t, wire, torch.float32)),
        _bits(jfb.decode_wire(enc_j, wire, jnp.float32)))
    np.testing.assert_array_equal(_bits(flatbuf.wire_roundtrip(ta, wire)),
                                  _bits(jfb.wire_roundtrip(ja, wire)))


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_tree_wire_roundtrip_bit_exact(wire):
    tree = _replicated(_quickstart_tree(), 2, seed=5)
    tree["step"] = np.arange(6, dtype=np.int32).reshape(2, 3)  # crosses as is
    want = jfb.tree_wire_roundtrip(jax.tree.map(jnp.asarray, tree), wire, batch_dims=1)
    got = flatbuf.tree_wire_roundtrip(_to_torch(tree), wire, batch_dims=1)
    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_plain_codecs_take_cpu_tensors_only():
    """The bf16 codecs run K3 / K4 through their wrappers: the plain
    versions for CPU tensors, and no other path on any device."""
    m = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        flatbuf.encode_wire(m, "bf16")
    with pytest.raises(ValueError, match="no kernel for device"):
        flatbuf.decode_wire(m.to(torch.bfloat16), "bf16", torch.float32)
