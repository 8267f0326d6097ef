"""Port's Mamba-1 path held against the JAX package: the selective scan (the
port's plain version of K7 against the Pallas kernel run as the reference's
tests run it on the CPU), the mixer's parts, the mixer, the reduced
falcon-mamba-7b LM, and the LM tree both packages share (stacked "blocks" /
"rem", caches {"groups", "rem"})."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.configs.base import ATTN as JAX_ATTN
from repro.configs.base import ATTN_SWA as JAX_ATTN_SWA
from repro.kernels import ops as jax_ops
from repro.models import common as jax_common
from repro.models import mamba as jax_mamba
from repro.models.lm import forward as jax_forward
from repro.models.lm import init_cache as jax_init_cache
from repro.models.lm import init_params as jax_init_params
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import ATTN, ATTN_SWA, RGLRU
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssm_scan_ref
from repro_torch.models import common, mamba
from repro_torch.models.blocks import init_block
from repro_torch.models.lm import forward, init_cache, init_params

ARCH = "falcon-mamba-7b"
ATOL_F32 = 1e-4  # f32 through a 2-layer LM: summation order differs per framework
SCAN_ATOL = {"float32": 1e-4, "bfloat16": 5e-2}  # tests/test_kernels.py:83


def _rng(seed):
    return np.random.default_rng(seed)


def _softplus(x):
    return np.log1p(np.exp(x)).astype(np.float32)


def _scan_inputs(seed, B, S, Di, N, random_h0=False):
    """x, dt, A, Bm, Cm, h0 as f32 numpy arrays, shaped as the reference's
    kernel tests shape them."""
    rng = _rng(seed)
    x = rng.standard_normal((B, S, Di), dtype=np.float32)
    dt = _softplus(rng.standard_normal((B, S, Di), dtype=np.float32))
    A = -np.exp(0.5 * rng.standard_normal((Di, N), dtype=np.float32))
    Bm = rng.standard_normal((B, S, N), dtype=np.float32)
    Cm = rng.standard_normal((B, S, N), dtype=np.float32)
    h0 = (rng.standard_normal((B, Di, N), dtype=np.float32) if random_h0
          else np.zeros((B, Di, N), np.float32))
    return x, dt, A, Bm, Cm, h0


def _both(arrays, dtype):
    """The same inputs for both packages: x, Bm, Cm in `dtype` (f32 -> bf16
    rounds to nearest even in both), dt, A, h0 in f32."""
    x, dt, A, Bm, Cm, h0 = arrays
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx = (jnp.asarray(x).astype(jd), jnp.asarray(dt), jnp.asarray(A),
          jnp.asarray(Bm).astype(jd), jnp.asarray(Cm).astype(jd), jnp.asarray(h0))
    tx = (torch.from_numpy(x).to(td), torch.from_numpy(dt), torch.from_numpy(A),
          torch.from_numpy(Bm).to(td), torch.from_numpy(Cm).to(td), torch.from_numpy(h0))
    return jx, tx


# -- K7's plain version against the Pallas kernel -------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Di,N,bd", [
    (2, 64, 128, 16, 64),
    (1, 128, 64, 8, 64),
    (3, 32, 96, 4, 32),   # Di not a multiple of the Pallas block
    (2, 40, 64, 12, 32),  # N = 12: states that do not fill K7's lanes
    (2, 24, 48, 1, 16),   # N = 1
])
def test_ssm_scan_matches_pallas_sweep(B, S, Di, N, bd, dtype):
    jx, tx = _both(_scan_inputs(S + Di, B, S, Di, N), dtype)
    want_y, want_h = jax_ops.ssm_scan(*jx, block_d=bd)
    y, h = ops.ssm_scan(*tx)
    assert y.dtype == h.dtype == torch.float32
    assert tuple(y.shape) == (B, S, Di) and tuple(h.shape) == (B, Di, N)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=SCAN_ATOL[dtype])
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=SCAN_ATOL[dtype])


def test_ssm_scan_nonzero_initial_state_matches_pallas():
    jx, tx = _both(_scan_inputs(5, 1, 16, 32, 4, random_h0=True), "float32")
    want_y, want_h = jax_ops.ssm_scan(*jx, block_d=16)
    y, h = ops.ssm_scan(*tx)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=1e-4)


def test_ssm_scan_takes_strided_b_and_c():
    """Bm and Cm as column slices of one (B, S, R + 2N) tensor, as the mixer
    hands them over, give what contiguous copies give."""
    B, S, Di, N, R = 2, 24, 40, 16, 8
    x, dt, A, _, _, h0 = (torch.from_numpy(a) for a in _scan_inputs(3, B, S, Di, N, True))
    proj = torch.from_numpy(_rng(4).standard_normal((B, S, R + 2 * N), dtype=np.float32))
    _, Bm, Cm = proj.split([R, N, N], dim=-1)
    assert not Bm.is_contiguous()
    y, h = ops.ssm_scan(x, dt, A, Bm, Cm, h0)
    y2, h2 = ssm_scan_ref(x, dt, A, Bm.contiguous(), Cm.contiguous(), h0)
    assert torch.equal(y, y2) and torch.equal(h, h2)


def _bad_inputs():
    x, dt, A, Bm, Cm, h0 = (torch.from_numpy(a) for a in _scan_inputs(0, 1, 4, 8, 4))
    yield "shape", ValueError, (x, dt, A, Bm[:, :2], Cm, h0)
    yield "dt dtype", TypeError, (x, dt.double(), A, Bm, Cm, h0)
    yield "mixed dtypes", TypeError, (x.bfloat16(), dt, A, Bm, Cm, h0)
    yield "x last axis", ValueError, (x.transpose(1, 2).contiguous().transpose(1, 2),
                                      dt, A, Bm, Cm, h0)
    yield "h0 layout", ValueError, (x, dt, A, Bm, Cm, h0.transpose(1, 2).contiguous()
                                    .transpose(1, 2))
    A40 = torch.zeros((8, 40))
    yield "N > 32", ValueError, (x, dt, A40, torch.zeros((1, 4, 40)), torch.zeros((1, 4, 40)),
                                 torch.zeros((1, 8, 40)))


@pytest.mark.parametrize("case", range(6))
def test_ssm_scan_rejects_what_the_kernel_does_not_take(case):
    _, err, args = list(_bad_inputs())[case]
    with pytest.raises(err):
        ops.ssm_scan(*args)


def test_ssm_scan_refuses_a_gradient():
    """The gradient K7 once refused: ops.ssm_scan differentiates every input
    (through the plain backward on the CPU), within 1e-4 of the largest
    magnitude of jax.grad of the reference's chunked `selective_scan`, with
    cotangents of y and h_final; under torch.no_grad nothing is recorded."""
    arrays = _scan_inputs(1, 2, 12, 8, 4, random_h0=True)
    rng = _rng(2)
    dy = rng.standard_normal((2, 12, 8), dtype=np.float32)
    dh = rng.standard_normal((2, 8, 4), dtype=np.float32)
    _, pull = jax.vjp(lambda *a: jax_mamba.selective_scan(*a, chunk=4),
                      *(jnp.asarray(a) for a in arrays))
    want = pull((jnp.asarray(dy), jnp.asarray(dh)))
    xs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y, h = ops.ssm_scan(*xs)
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum()
                              + (h * torch.from_numpy(dh)).sum(), xs)
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()
    with torch.no_grad():
        y, _ = ops.ssm_scan(*xs)
    assert y.grad_fn is None


# -- the mixer's parts ---------------------------------------------------------------

@pytest.mark.parametrize("chunk", [4, 8, 16, 64])
@pytest.mark.parametrize("S", [8, 40, 64])
def test_selective_scan_matches_jax_at_every_chunk(S, chunk):
    jx, tx = _both(_scan_inputs(S, 2, S, 16, 4), "float32")
    want_y, want_h = jax_mamba.selective_scan(*jx, chunk=chunk)
    y, h = mamba.selective_scan(*tx)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=1e-4)


def test_selective_scan_casts_y_to_the_input_dtype():
    _, tx = _both(_scan_inputs(2, 1, 8, 16, 4), "bfloat16")
    y, h = mamba.selective_scan(*tx)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32


def test_selective_scan_state_carry():
    """Scanning two halves with the carried state == scanning the whole."""
    x, dt, A, Bm, Cm, h0 = (torch.from_numpy(a) for a in _scan_inputs(7, 1, 32, 8, 4))
    y_full, h_full = mamba.selective_scan(x, dt, A, Bm, Cm, h0)
    y1, h1 = mamba.selective_scan(x[:, :16], dt[:, :16], A, Bm[:, :16], Cm[:, :16], h0)
    y2, h2 = mamba.selective_scan(x[:, 16:], dt[:, 16:], A, Bm[:, 16:], Cm[:, 16:], h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(), atol=1e-5)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), atol=1e-5)


@pytest.mark.parametrize("with_carry", [False, True])
def test_causal_conv1d_matches_jax(with_carry):
    rng = _rng(11)
    x = rng.standard_normal((2, 9, 12), dtype=np.float32)
    w = rng.standard_normal((12, 4), dtype=np.float32)
    b = rng.standard_normal(12, dtype=np.float32)
    carry = rng.standard_normal((2, 3, 12), dtype=np.float32) if with_carry else None
    want_y, want_c = jax_mamba.causal_conv1d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if carry is None else jnp.asarray(carry))
    y, c = mamba.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                               None if carry is None else torch.from_numpy(carry))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5)
    np.testing.assert_array_equal(c.numpy(), np.asarray(want_c))


def test_sinusoidal_positions_match_jax():
    pos = _rng(12).integers(0, 1100, (2, 7)).astype(np.int32)
    want = jax_common.sinusoidal_positions(jnp.asarray(pos), 64)
    got = common.sinusoidal_positions(torch.from_numpy(pos), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# -- the mixer and the LM at the reduced falcon-mamba-7b -----------------------------

def _setup(seed, **kw):
    jcfg = jax_get_reduced(ARCH).replace(**kw)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, get_reduced(ARCH), jp, params_from_jax(jax.tree.map(np.asarray, jp))


def test_mamba_apply_prefill_then_decode_matches_jax():
    jcfg, cfg, jp, tp = _setup(1)
    jm = jax.tree.map(lambda a: a[0], jp["blocks"][0]["mamba"])
    tm = {k: v[0] for k, v in tp["blocks"][0]["mamba"].items()}
    B, S = 2, 12
    x = 0.5 * _rng(13).standard_normal((B, S + 3, cfg.d_model), dtype=np.float32)
    jcache = jax_mamba.init_mamba_cache(jcfg, B, jnp.float32)
    tcache = mamba.init_mamba_cache(cfg, B, torch.float32, "cpu")
    want, jcache = jax_mamba.mamba_apply(jm, jnp.asarray(x[:, :S]), jcfg, cache=jcache)
    got, tcache = mamba.mamba_apply(tm, torch.from_numpy(x[:, :S]), cfg, cache=tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_F32)
    for t in range(S, S + 3):  # decode: the S == 1 fast path, cache in place
        want, jcache = jax_mamba.mamba_apply(jm, jnp.asarray(x[:, t:t + 1]), jcfg,
                                             cache=jcache)
        got, tcache = mamba.mamba_apply(tm, torch.from_numpy(x[:, t:t + 1]), cfg,
                                        cache=tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_F32)
    for k in ("conv", "h"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), atol=ATOL_F32)


def test_forward_logits_match_jax():
    jcfg, cfg, jp, tp = _setup(0)
    toks = _rng(4).integers(0, cfg.vocab_size, (2, 40))
    want = jax_forward(jp, jnp.asarray(toks, jnp.int32), jcfg)["logits"]
    got = forward(tp, torch.from_numpy(toks), cfg)["logits"]
    assert got.shape == (2, 40, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_F32)


@pytest.mark.parametrize("full", [True, False])
def test_config_fields_match_jax(full):
    jcfg = jax_get_config(ARCH) if full else jax_get_reduced(ARCH)
    cfg = get_config(ARCH) if full else get_reduced(ARCH)
    for f in ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab_size", "layer_pattern", "rope_type",
              "tie_embeddings", "norm_eps", "d_inner", "dt_rank", "source"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    for f in ("d_state", "d_conv", "expand", "dt_rank"):
        assert getattr(cfg.ssm, f) == getattr(jcfg.ssm, f), f
    assert str(cfg.param_dtype) == f"torch.{jcfg.param_dtype}"


def test_rglru_is_not_ported_yet():
    """RG-LRU layers are ported (tests/test_torch_rglru.py): a config with
    them validates once it carries an RGLRUConfig, and a block builds the
    reference's "rec" mixer."""
    cfg = get_reduced("llama3.2-1b").replace(layer_pattern=(RGLRU,))
    with pytest.raises(ValueError, match="RGLRUConfig"):
        cfg.validate()
    cfg = cfg.replace(rglru=get_reduced("recurrentgemma-9b").rglru)
    cfg.validate()
    p = init_block(torch.Generator(), cfg, RGLRU, torch.float32, "cpu")
    assert sorted(p) == ["ffn", "rec"]


# -- the LM tree of both packages (stacked "blocks" / "rem") --------------------------

# (arch, config changes): a pattern of one slot, the mamba model, and a
# pattern of two slots over 3 layers (one stacked repeat plus a remainder)
TREES = {
    "llama": ("llama3.2-1b", {}),
    "mamba": (ARCH, {}),
    "remainder": ("llama3.2-1b", {"layer_pattern": ((JAX_ATTN, ATTN), (JAX_ATTN_SWA, ATTN_SWA)),
                                  "n_layers": 3, "sliding_window": 16}),
}


def _tree_cfgs(name, dtype):
    arch, kw = TREES[name]
    jkw = {k: tuple(a for a, _ in v) if k == "layer_pattern" else v for k, v in kw.items()}
    tkw = {k: tuple(b for _, b in v) if k == "layer_pattern" else v for k, v in kw.items()}
    jcfg = jax_get_reduced(arch).replace(param_dtype=dtype, **jkw)
    cfg = get_reduced(arch).replace(param_dtype=getattr(torch, dtype), **tkw)
    return jcfg, cfg


def _paths(tree):
    """{key path: (shape, dtype name)} of a JAX tree or of the port's."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            tree, is_leaf=lambda x: isinstance(x, torch.Tensor)):
        keys = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        dt = str(leaf.dtype).replace("torch.", "")
        out[keys] = (tuple(leaf.shape), dt)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(TREES))
def test_init_params_tree_is_the_references_leaf_for_leaf(name, dtype):
    jcfg, cfg = _tree_cfgs(name, dtype)
    want = _paths(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tp = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert _paths(tp) == want
    assert len(tp["rem"]) == jcfg.n_layers % len(jcfg.layer_pattern)


@pytest.mark.parametrize("name", sorted(TREES))
def test_init_cache_tree_is_the_references_leaf_for_leaf(name):
    jcfg, cfg = _tree_cfgs(name, "float32")
    want = _paths(jax_init_cache(jcfg, 3, 24))
    got = init_cache(cfg, 3, 24, device="cpu")
    assert sorted(got) == ["groups", "rem"]
    assert _paths(got) == want


@pytest.mark.parametrize("name", sorted(TREES))
def test_forward_on_converted_params_matches_jax(name):
    """Layers run in the reference's order (repeats, slots, remainder) on
    views of the stacked leaves."""
    jcfg, cfg = _tree_cfgs(name, "float32")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(2))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    toks = _rng(2).integers(0, cfg.vocab_size, (2, 24))
    want = jax_forward(jp, jnp.asarray(toks, jnp.int32), jcfg)["logits"]
    got = forward(tp, torch.from_numpy(toks), cfg)["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_F32)


def test_params_from_jax_maps_mamba_leaves_in_their_own_dtype():
    """A bf16 model keeps dt_proj, dt_bias, A_log and Dskip in f32; each
    leaf arrives bit for bit at its own path."""
    jcfg = jax_get_reduced(ARCH).replace(param_dtype="bfloat16")
    jp = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(3)))
    tp = params_from_jax(jp)
    f32 = {"dt_proj", "dt_bias", "A_log", "Dskip"}
    leaves = jax.tree_util.tree_leaves_with_path(jp)
    assert {str(p[-1].key) for p, _ in leaves} >= f32 | {
        "norm", "in_proj", "conv_w", "conv_b", "x_proj", "out_proj"}
    for path, want in leaves:
        got = tp
        for k in path:
            got = got[getattr(k, "key", getattr(k, "idx", None))]
        name = path[-1].key
        assert got.dtype == (torch.float32 if name in f32 else torch.bfloat16), path
        np.testing.assert_array_equal(got.float().numpy().astype(want.dtype), want,
                                      err_msg=str(path))


def test_params_from_jax_refuses_another_tree():
    with pytest.raises(ValueError, match="not an LM params tree"):
        params_from_jax({"layers": []})
