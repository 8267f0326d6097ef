"""Port's decoder LM held against the JAX package on the reduced
llama3.2-1b config: building blocks, attention sub-block, full forward on
converted parameters, parameter conversion and the port's own init."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.models import attention as jax_attention
from repro.models import common as jax_common
from repro.models import rope as jax_rope
from repro.models.lm import forward as jax_forward
from repro.models.lm import init_params as jax_init_params
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import attention, common, rope
from repro_torch.models.lm import forward, init_params

ARCH = "llama3.2-1b"
ATOL_F32 = 1e-4  # f32 through a 2-layer LM: summation order differs per framework

# the default reduced config (4 query heads, 4 kv heads) and a GQA variant
VARIANTS = {"mha": {}, "gqa": {"n_kv_heads": 2}}


def _cfgs(variant):
    kw = VARIANTS[variant]
    return jax_get_reduced(ARCH).replace(**kw), get_reduced(ARCH).replace(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("full", [True, False])
def test_config_fields_match_jax(full):
    jcfg = jax_get_config(ARCH) if full else jax_get_reduced(ARCH)
    cfg = get_config(ARCH) if full else get_reduced(ARCH)
    for f in ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab_size", "layer_pattern", "rope_theta",
              "sliding_window", "tie_embeddings", "norm_eps",
              "long_context_window", "source"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert str(cfg.param_dtype) == f"torch.{jcfg.param_dtype}"
    assert str(cfg.compute_dtype) == f"torch.{jcfg.compute_dtype}"


def test_rms_norm_matches_jax():
    x = _rng(0).standard_normal((2, 5, 64), dtype=np.float32)
    s = 0.1 * _rng(1).standard_normal(64, dtype=np.float32)
    want = jax_common.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6)
    got = common.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("head_dim", [16, 64])
def test_apply_rope_matches_jax(head_dim):
    rng = _rng(head_dim)
    q = rng.standard_normal((2, 7, 4, head_dim), dtype=np.float32)
    k = rng.standard_normal((2, 7, 2, head_dim), dtype=np.float32)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    jq, jk = jax_rope.apply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
                                 500_000.0)
    tq, tk = rope.apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(pos), 500_000.0)
    # angles up to ~4096 rad: sin/cos of one f32 angle differ by an ulp or so
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)


def test_silu_mlp_matches_jax():
    rng = _rng(3)
    x = rng.standard_normal((3, 32), dtype=np.float32)
    w1, w3 = (0.2 * rng.standard_normal((32, 48), dtype=np.float32) for _ in range(2))
    w2 = 0.2 * rng.standard_normal((48, 32), dtype=np.float32)
    want = jax_common.silu_mlp(*map(jnp.asarray, (x, w1, w3, w2)))
    got = common.silu_mlp(*map(torch.from_numpy, (x, w1, w3, w2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _layer_params(jcfg, seed):
    jp = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_jax(_np(jp))


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_attn_apply_matches_jax(variant, impl):
    jcfg, cfg = _cfgs(variant)
    jp, tp = _layer_params(jcfg, 1)
    B, S = 2, 24
    x = 0.5 * _rng(2).standard_normal((B, S, cfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jattn = jax.tree.map(lambda a: a[0], jp["blocks"][0]["attn"])
    want, _ = jax_attention.attn_apply(
        jattn, jnp.asarray(x), jnp.asarray(pos), jcfg,
        impl="pallas" if impl == "kernel" else "jnp")
    tattn = {k: v[0] for k, v in tp["blocks"][0]["attn"].items()}
    got, _ = attention.attn_apply(tattn, torch.from_numpy(x),
                                  torch.from_numpy(pos.copy()), cfg, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_F32)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_logits_match_jax(variant, impl):
    jcfg, cfg = _cfgs(variant)
    jp, tp = _layer_params(jcfg, 0)
    toks = _rng(4).integers(0, cfg.vocab_size, (2, 40))
    want = jax_forward(jp, jnp.asarray(toks, jnp.int32), jcfg,
                       attn_impl="pallas" if impl == "kernel" else "jnp")["logits"]
    got = forward(tp, torch.from_numpy(toks), cfg, attn_impl=impl)["logits"]
    assert got.shape == (2, 40, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_F32)


ATOL_ROPE_NONE = 1e-5  # f32, 2 layers: the re-anchor's gap under "standard" was 1.3e-6


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_rope_none_attn_apply_matches_jax(impl):
    """rope_type "none": q and k are not rotated (the reference rotates only
    under "standard", `repro/models/attention.py:147`)."""
    jcfg, cfg = (c.replace(rope_type="none") for c in _cfgs("gqa"))
    jp, tp = _layer_params(jcfg, 0)
    B, S = 2, 16
    x = 0.5 * _rng(0).standard_normal((B, S, cfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jattn = jax.tree.map(lambda a: a[0], jp["blocks"][0]["attn"])
    want, _ = jax_attention.attn_apply(
        jattn, jnp.asarray(x), jnp.asarray(pos), jcfg,
        impl="pallas" if impl == "kernel" else "jnp")
    tattn = {k: v[0] for k, v in tp["blocks"][0]["attn"].items()}
    got, _ = attention.attn_apply(tattn, torch.from_numpy(x),
                                  torch.from_numpy(pos.copy()), cfg, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_ROPE_NONE)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_rope_none_forward_logits_match_jax(impl):
    """The whole LM under rope_type "none": sinusoidal positions added to the
    embeddings and no rotation in any attention layer."""
    jcfg, cfg = (c.replace(rope_type="none") for c in _cfgs("gqa"))
    jp, tp = _layer_params(jcfg, 0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    want = jax_forward(jp, jnp.asarray(toks, jnp.int32), jcfg,
                       attn_impl="pallas" if impl == "kernel" else "jnp")["logits"]
    got = forward(tp, torch.from_numpy(toks), cfg, attn_impl=impl)["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_ROPE_NONE)


def test_forward_window_override_matches_jax():
    jcfg, cfg = _cfgs("gqa")
    jp, tp = _layer_params(jcfg, 6)
    toks = _rng(6).integers(0, cfg.vocab_size, (1, 40))
    want = jax_forward(jp, jnp.asarray(toks, jnp.int32), jcfg,
                       window_override=16)["logits"]
    got = forward(tp, torch.from_numpy(toks), cfg, window_override=16)["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_F32)


def _jax_leaves(jp):
    """(key path, numpy leaf) for every leaf of a JAX LM tree; the port's
    tree has the same paths."""
    return [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path),
             np.asarray(leaf))
            for path, leaf in jax.tree_util.tree_leaves_with_path(jp)]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trips_every_leaf(dtype):
    jcfg = jax_get_reduced(ARCH).replace(param_dtype=dtype)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(3))
    tp = params_from_jax(_np(jp))
    leaves = _jax_leaves(jp)
    # embed, final norm, 9 per pattern slot (stacked over the layers)
    assert len(leaves) == 2 + len(jcfg.layer_pattern) * 9
    for path, want in leaves:
        got = _get(tp, path)
        assert got.dtype == getattr(torch, dtype), path
        assert tuple(got.shape) == want.shape, path
        back = got.float().numpy().astype(want.dtype)  # bf16 -> f32 -> bf16 exact
        np.testing.assert_array_equal(back, want, err_msg=str(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_matches_jax_shapes_dtypes_and_scale(dtype):
    jcfg = jax_get_reduced(ARCH).replace(param_dtype=dtype)
    cfg = get_reduced(ARCH).replace(param_dtype=getattr(torch, dtype))
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tp = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = _jax_leaves(jp)
    n_port = len(jax.tree_util.tree_leaves(
        jax.tree.map(lambda t: 0, tp)))
    assert n_port == len(leaves)
    for path, want in leaves:
        got = _get(tp, path)
        assert got.dtype == getattr(torch, dtype), path
        assert tuple(got.shape) == want.shape, path
        ws, gs = float(np.std(want.astype(np.float32))), float(got.float().std())
        if ws == 0.0:
            assert gs == 0.0, path
        else:
            assert abs(gs - ws) <= 0.1 * ws, (path, gs, ws)
