"""Port's RG-LRU path held against the JAX package: the RG-LRU scan (the
port's plain version of K8 against the Pallas kernel run as the reference's
tests run it on the CPU), `linear_recurrence`, the mixer and its parts, the
reduced recurrentgemma-9b LM (one pattern repeat) and a 5-layer variant
(one repeat and a remainder of two RG-LRU layers), serving, and the
launchers. Inputs are made from a seed with numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.kernels import ops as jax_ops
from repro.models import mamba as jax_mamba
from repro.models import rglru as jax_rglru
from repro.models.lm import forward as jax_forward
from repro.models.lm import init_cache as jax_init_cache
from repro.models.lm import init_params as jax_init_params
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import make_decode_fn as jax_make_decode_fn
from repro.serve.engine import make_prefill_fn as jax_make_prefill_fn
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels.rglru_scan import rglru_scan_fwd
from repro_torch.kernels.ref import rglru_scan_ref
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import mamba, rglru
from repro_torch.models.lm import forward, init_cache, init_params
from repro_torch.serve.engine import Engine, make_decode_fn, make_prefill_fn

ARCH = "recurrentgemma-9b"
ATOL = 1e-5        # tests/test_kernels.py:114 and tests/test_models.py:99
ATOL_BF16 = 2e-2   # the bf16 tolerance of tests/test_kernels.py
ATOL_LM = 1e-4     # f32 through an LM: summation order differs per framework


def _rng(seed):
    return np.random.default_rng(seed)


def _sigmoid(x):
    return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)


def _scan_inputs(seed, B, S, W, random_h0=True):
    """a in (0, 1), gx and h0 standard normal, f32 numpy; as
    tests/test_kernels.py:106 draws them."""
    rng = _rng(seed)
    a = _sigmoid(rng.standard_normal((B, S, W), dtype=np.float32))
    gx = rng.standard_normal((B, S, W), dtype=np.float32)
    h0 = (rng.standard_normal((B, W), dtype=np.float32) if random_h0
          else np.zeros((B, W), np.float32))
    return a, gx, h0


def _both(arrays, dtype):
    """The same inputs for both packages: a and gx in `dtype` (f32 -> bf16
    rounds to nearest even in both), h0 f32."""
    a, gx, h0 = arrays
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx = (jnp.asarray(a).astype(jd), jnp.asarray(gx).astype(jd), jnp.asarray(h0))
    tx = (torch.from_numpy(a).to(td), torch.from_numpy(gx).to(td), torch.from_numpy(h0))
    return jx, tx


# -- K8's plain version against the Pallas kernel -------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("random_h0", [True, False])
@pytest.mark.parametrize("B,S,W,bw", [
    (2, 64, 128, 64),   # tests/test_kernels.py:104-105
    (1, 32, 48, 16),
    (3, 40, 100, 64),   # W not a multiple of the Pallas block: it halves to 4
    (2, 1, 96, 32),     # S = 1
])
def test_rglru_scan_matches_pallas_sweep(B, S, W, bw, random_h0, dtype):
    jx, tx = _both(_scan_inputs(S + W, B, S, W, random_h0), dtype)
    want_hs, want_h = jax_ops.rglru_scan(*jx, block_w=bw)
    hs, h = ops.rglru_scan(*tx)
    assert hs.dtype == h.dtype == torch.float32
    assert tuple(hs.shape) == (B, S, W) and tuple(h.shape) == (B, W)
    np.testing.assert_allclose(hs.numpy(), np.asarray(want_hs), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=ATOL)


@given(st.integers(0, 10))
@settings(max_examples=8, deadline=None)
def test_rglru_decay_bound_property(seed):
    """With |a| < 1 and bounded input the state stays bounded
    (tests/test_kernels.py:120, on the port)."""
    rng = _rng(seed)
    B, S, W = 1, 64, 16
    a = 0.99 * _sigmoid(rng.standard_normal((B, S, W), dtype=np.float32))
    gx = np.clip(rng.standard_normal((B, S, W), dtype=np.float32), -1, 1)
    hs, _ = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(gx),
                           torch.zeros((B, W)))
    assert float(hs.abs().max()) < 1.0 / (1.0 - 0.99) + 1.0


def test_rglru_scan_ref_rounds_the_product_then_the_sum():
    """The plain version is two roundings per step (K8 pins the same with
    __fmul_rn / __fadd_rn), not a fused multiply-add."""
    a, gx, h0 = (torch.from_numpy(x) for x in _scan_inputs(2, 2, 16, 32))
    hs, h = rglru_scan_ref(a, gx, h0)
    want, hw = [], h0
    for t in range(16):
        hw = (a[:, t] * hw) + gx[:, t]
        want.append(hw)
    assert torch.equal(hs, torch.stack(want, 1)) and torch.equal(h, hw)


def _bad_inputs():
    a, gx, h0 = (torch.from_numpy(x) for x in _scan_inputs(0, 2, 4, 8))
    yield "shape", ValueError, (a, gx[:, :2], h0)
    yield "h0 shape", ValueError, (a, gx, h0[:, :4])
    yield "mixed dtypes", TypeError, (a.bfloat16(), gx, h0)
    yield "float16", TypeError, (a.half(), gx.half(), h0)
    yield "h0 dtype", TypeError, (a, gx, h0.bfloat16())
    yield "not contiguous", ValueError, (a.transpose(0, 1).contiguous().transpose(0, 1),
                                         gx, h0)
    yield "two dims", ValueError, (a[0], gx[0], h0)
    yield "empty", ValueError, (a[:, :0], gx[:, :0], h0)


@pytest.mark.parametrize("case", range(8))
def test_rglru_scan_rejects_what_the_kernel_does_not_take(case):
    _, err, args = list(_bad_inputs())[case]
    with pytest.raises(err):
        ops.rglru_scan(*args)


def test_cpu_tensors_never_count_a_launch():
    rglru_scan_fwd.launches = 0
    for dtype in ("float32", "bfloat16"):
        _, tx = _both(_scan_inputs(1, 2, 8, 16), dtype)
        ops.rglru_scan(*tx)
        mamba.linear_recurrence(*tx)
    assert rglru_scan_fwd.launches == 0


def test_rglru_scan_refuses_a_gradient():
    """The gradient K8 once refused: ops.rglru_scan differentiates a, gx and
    h0 (through the plain backward on the CPU), within ATOL of jax.grad of
    the reference's chunked `linear_recurrence`, with cotangents of hs and
    h_final; under torch.no_grad nothing is recorded."""
    arrays = _scan_inputs(1, 2, 12, 8)
    rng = _rng(2)
    dhs = rng.standard_normal((2, 12, 8), dtype=np.float32)
    dh = rng.standard_normal((2, 8), dtype=np.float32)
    _, pull = jax.vjp(lambda *a: jax_mamba.linear_recurrence(*a, chunk=4),
                      *(jnp.asarray(a) for a in arrays))
    want = pull((jnp.asarray(dhs), jnp.asarray(dh)))
    xs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    hs, h = ops.rglru_scan(*xs)
    got = torch.autograd.grad((hs * torch.from_numpy(dhs)).sum()
                              + (h * torch.from_numpy(dh)).sum(), xs)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    with torch.no_grad():
        hs, _ = ops.rglru_scan(*xs)
    assert hs.grad_fn is None


def test_rglru_scan_fwd_needs_cuda_tensors():
    """The card path never takes a CPU tensor (and so never the plain
    version): the launcher refuses before it touches the library."""
    a, gx, h0 = (torch.from_numpy(x) for x in _scan_inputs(1, 1, 4, 8))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rglru_scan_fwd(None, a, gx, h0)


# -- linear_recurrence ---------------------------------------------------------------

@pytest.mark.parametrize("chunk", [8, 16, 512])
@pytest.mark.parametrize("S", [8, 48])
def test_linear_recurrence_matches_jax(S, chunk):
    """tests/test_models.py:90 on the port: the reference's chunked
    associative scan against K8's path."""
    jx, tx = _both(_scan_inputs(S, 2, S, 8), "float32")
    want_hs, want_h = jax_mamba.linear_recurrence(*jx, chunk=chunk)
    hs, h = mamba.linear_recurrence(*tx)
    np.testing.assert_allclose(hs.numpy(), np.asarray(want_hs), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=ATOL)


def test_linear_recurrence_returns_f32_as_the_reference_does():
    """bf16 da / db with the f32 h0: the reference's hs comes out f32 (every
    step multiplies the f32 state), and so does the port's. The reference
    forms its chunk products in bf16, the port steps in f32: bf16's
    tolerance."""
    jx, tx = _both(_scan_inputs(3, 2, 12, 8), "bfloat16")
    want_hs, want_h = jax_mamba.linear_recurrence(*jx, chunk=4)
    hs, h = mamba.linear_recurrence(*tx)
    assert want_hs.dtype == want_h.dtype == jnp.float32
    assert hs.dtype == h.dtype == torch.float32
    np.testing.assert_allclose(hs.numpy(), np.asarray(want_hs), atol=ATOL_BF16)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=ATOL_BF16)


# -- the mixer and its parts ---------------------------------------------------------

def _setup(seed, dtype="float32", n_layers=None):
    """JAX and port configs and parameters of the reduced recurrentgemma-9b
    (the port's by `params_from_jax`)."""
    jcfg = jax_get_reduced(ARCH).replace(param_dtype=dtype, compute_dtype=dtype)
    cfg = get_reduced(ARCH).replace(param_dtype=getattr(torch, dtype),
                                    compute_dtype=getattr(torch, dtype))
    if n_layers is not None:
        jcfg, cfg = jcfg.replace(n_layers=n_layers), cfg.replace(n_layers=n_layers)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _mixers(jp, tp):
    """The first layer's RG-LRU parameters in both packages."""
    return (jax.tree.map(lambda a: a[0], jp["blocks"][0]["rec"]),
            {k: v[0] for k, v in tp["blocks"][0]["rec"].items()})


def _run_mixers(dtype, seed, scale):
    """A prefill of 12 tokens into a cache, then three S = 1 decode steps,
    in both packages. Returns [(port out, JAX out)] and both caches."""
    jcfg, cfg, jp, tp = _setup(seed, dtype)
    jm, tm = _mixers(jp, tp)
    B, S = 2, 12
    x = scale * _rng(13).standard_normal((B, S + 3, cfg.d_model), dtype=np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jcache = jax_rglru.init_rglru_cache(jcfg, B, jx.dtype)
    tcache = rglru.init_rglru_cache(cfg, B, tx.dtype, "cpu")
    outs = []
    for lo, hi in ((0, S), (S, S + 1), (S + 1, S + 2), (S + 2, S + 3)):
        want, jcache = jax_rglru.rglru_apply(jm, jx[:, lo:hi], jcfg, cache=jcache)
        got, tcache = rglru.rglru_apply(tm, tx[:, lo:hi], cfg, cache=tcache)
        outs.append((got, want))
    return outs, tcache, jcache


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype,atol", [("float32", ATOL), ("bfloat16", ATOL_BF16)])
def test_rglru_apply_prefill_then_decode_matches_jax(dtype, atol):
    """x at scale 2 puts the y branch's pre-activations across [-7, 7], where
    gelu's tanh and erf forms differ by up to 4.7e-4."""
    outs, tcache, jcache = _run_mixers(dtype, 1, 2.0)
    for step, (got, want) in enumerate(outs):
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=atol, err_msg=f"step {step}")
    assert tcache["conv"].dtype == getattr(torch, dtype)
    assert tcache["h"].dtype == torch.float32
    for k in ("conv", "h"):
        np.testing.assert_allclose(_f32(tcache[k]), _f32(jcache[k]), atol=atol, err_msg=k)


def test_rglru_apply_twin_sees_the_gelu_form(monkeypatch):
    """The f32 twin above would catch torch's default erf gelu: with it the
    mixer misses the reference by more than 1e-5 (jax.nn.gelu's default is
    the tanh approximation)."""
    erf_gelu = F.gelu

    class Erf:
        def __getattr__(self, name):
            return getattr(F, name)

        @staticmethod
        def gelu(x, approximate="none"):
            return erf_gelu(x)

    monkeypatch.setattr(rglru, "F", Erf())
    outs, _, _ = _run_mixers("float32", 1, 2.0)
    assert max(float(np.abs(_f32(g) - _f32(w)).max()) for g, w in outs) > ATOL


def test_rglru_gates_run_in_the_compute_dtype():
    """r and i: the product and bias in the compute dtype, as the reference
    runs `xb @ w.astype(wd) + b.astype(wd)`, then a sigmoid in f32. In bf16
    an f32 product (w left in f32) misses the reference by more than the
    twin's tolerance."""
    rng = _rng(5)
    W = 64
    xb = rng.standard_normal((2, 9, W), dtype=np.float32)
    w = rng.standard_normal((W, W), dtype=np.float32) / 8
    b = 0.1 * rng.standard_normal(W, dtype=np.float32)
    for dtype in ("float32", "bfloat16"):
        jd = getattr(jnp, dtype)
        jx = jnp.asarray(xb).astype(jd)
        want = jax.nn.sigmoid((jx @ jnp.asarray(w).astype(jd)
                               + jnp.asarray(b).astype(jd)).astype(jnp.float32))
        got = rglru._gate(torch.from_numpy(xb).to(getattr(torch, dtype)),
                          torch.from_numpy(w), torch.from_numpy(b))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, err_msg=dtype)
    f32_product = torch.sigmoid(torch.from_numpy(xb).bfloat16().float() @ torch.from_numpy(w)
                                + torch.from_numpy(b))
    assert np.abs(f32_product.numpy() - np.asarray(want)).max() > ATOL


def test_decode_steps_the_state_without_the_scan(monkeypatch):
    """S == 1 takes h = a h0 + gated (rglru.py:70-72 of the reference): no
    scan is called in decode, and prefill calls it."""
    jcfg, cfg, jp, tp = _setup(2)
    _, tm = _mixers(jp, tp)
    cache = rglru.init_rglru_cache(cfg, 2, torch.float32, "cpu")
    x = torch.from_numpy(_rng(3).standard_normal((2, 5, cfg.d_model), dtype=np.float32))
    calls = []
    monkeypatch.setattr(ops, "rglru_scan", lambda *a: calls.append(1) or rglru_scan_ref(*a))
    rglru.rglru_apply(tm, x[:, :4], cfg, cache=cache)
    assert calls == [1]
    rglru.rglru_apply(tm, x[:, 4:], cfg, cache=cache)
    assert calls == [1]


def test_rglru_apply_without_a_cache_matches_jax():
    jcfg, cfg, jp, tp = _setup(4)
    jm, tm = _mixers(jp, tp)
    x = 2.0 * _rng(6).standard_normal((2, 10, cfg.d_model), dtype=np.float32)
    want, jc = jax_rglru.rglru_apply(jm, jnp.asarray(x), jcfg)
    got, tc = rglru.rglru_apply(tm, torch.from_numpy(x), cfg)
    assert jc is None and tc is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_rglru_matches_jax_shapes_dtypes_and_scales(dtype):
    jcfg = jax_get_reduced(ARCH).replace(param_dtype=dtype)
    cfg = get_reduced(ARCH).replace(param_dtype=getattr(torch, dtype))
    jm = jax_rglru.init_rglru(jax.random.PRNGKey(0), jcfg, jcfg.pdtype())
    tm = rglru.init_rglru(torch.Generator().manual_seed(0), cfg, cfg.param_dtype, "cpu")
    assert sorted(tm) == sorted(jm)
    for k, want in jm.items():
        got = tm[k]
        assert tuple(got.shape) == want.shape, k
        assert str(got.dtype).replace("torch.", "") == str(want.dtype), k
        w = np.asarray(want, np.float32)
        if w.std() > 0 and k != "a_param":  # the truncated-normal draws
            assert got.float().std().item() == pytest.approx(float(w.std()), rel=0.1), k
        elif k != "a_param":
            assert not got.any(), k
    c = cfg.rglru.c_exponent
    for lam in (tm["a_param"], torch.from_numpy(np.array(jm["a_param"]))):
        a = torch.exp(-c * F.softplus(lam))
        assert 0.9 - 1e-5 <= a.min().item() and a.max().item() <= 0.999 + 1e-5


@pytest.mark.parametrize("full", [True, False])
def test_config_fields_match_jax(full):
    jcfg = jax_get_config(ARCH) if full else jax_get_reduced(ARCH)
    cfg = get_config(ARCH) if full else get_reduced(ARCH)
    for f in ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab_size", "layer_pattern", "rope_type",
              "rope_theta", "sliding_window", "tie_embeddings", "norm_eps",
              "lru_width", "source"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    for f in ("lru_width", "conv_width", "c_exponent"):
        assert getattr(cfg.rglru, f) == getattr(jcfg.rglru, f), f
    assert str(cfg.param_dtype) == f"torch.{jcfg.param_dtype}"
    # full: 12 repeats of the pattern and a remainder of two RG-LRU layers;
    # reduced: one repeat, no remainder
    assert divmod(cfg.n_layers, len(cfg.layer_pattern)) == ((12, 2) if full else (1, 0))


def test_config_validation_needs_an_rglru_config():
    cfg = get_reduced(ARCH).replace(rglru=None)
    with pytest.raises(ValueError, match="RGLRUConfig"):
        cfg.validate()


def test_full_config_has_the_published_parameter_count():
    """9,396,408,320 parameters: shapes from the meta device, nothing drawn."""
    cfg = get_config(ARCH)
    tp = init_params(cfg, None, "meta")
    assert sum(x.numel() for x in jax.tree_util.tree_leaves(tp)) == 9_396_408_320


# -- the LM: reduced (one repeat) and 5 layers (one repeat and a remainder) ------------

@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("n_layers", [3, 5])
def test_forward_logits_match_jax(n_layers, impl):
    jcfg, cfg, jp, tp = _setup(0, n_layers=n_layers)
    assert len(tp["rem"]) == n_layers % 3
    toks = _rng(4).integers(0, cfg.vocab_size, (2, 40))
    want = jax_forward(jp, jnp.asarray(toks, jnp.int32), jcfg)["logits"]
    got = forward(tp, torch.from_numpy(toks), cfg, attn_impl=impl)["logits"]
    assert got.shape == (2, 40, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_LM)


def _paths(tree):
    """{key path: (shape, dtype name)} of a JAX tree or of the port's."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            tree, is_leaf=lambda x: isinstance(x, torch.Tensor)):
        keys = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        out[keys] = (tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_layers", [3, 5])
def test_init_params_and_cache_trees_are_the_references(n_layers, dtype):
    """Stacked "blocks" / "rem" with the mixer's leaves under "rec", and the
    caches {"groups", "rem"}: attn_local layers hold min(window, cache_len)
    slots, RG-LRU layers their conv window and f32 state."""
    jcfg = jax_get_reduced(ARCH).replace(n_layers=n_layers, param_dtype=dtype)
    cfg = get_reduced(ARCH).replace(n_layers=n_layers, param_dtype=getattr(torch, dtype))
    want = _paths(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    assert _paths(init_params(cfg, torch.Generator().manual_seed(0), "cpu")) == want
    for cache_len in (24, 100):  # below and above the window of 64
        assert _paths(init_cache(cfg, 3, cache_len, device="cpu")) == _paths(
            jax_init_cache(jcfg, 3, cache_len))


def test_params_from_jax_keeps_the_f32_gates_of_a_bf16_model():
    """w_a, b_a, w_i, b_i and a_param stay f32 in a bf16 model; each leaf
    arrives bit for bit at its own path."""
    jcfg = jax_get_reduced(ARCH).replace(param_dtype="bfloat16", n_layers=5)
    jp = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(3)))
    tp = params_from_jax(jp)
    f32 = {"w_a", "b_a", "w_i", "b_i", "a_param"}
    for path, want in jax.tree_util.tree_leaves_with_path(jp):
        got = tp
        for k in path:
            got = got[getattr(k, "key", getattr(k, "idx", None))]
        in_rec = any(getattr(k, "key", None) == "rec" for k in path)
        name = path[-1].key
        assert got.dtype == (torch.float32 if in_rec and name in f32 else torch.bfloat16), path
        np.testing.assert_array_equal(got.float().numpy().astype(want.dtype), want,
                                      err_msg=str(path))


# -- serving ---------------------------------------------------------------------------

def _port_serve(cfg, tp, toks, S0, n_dec, cache_len):
    prefill = make_prefill_fn(cfg, cache_len=cache_len)
    decode = make_decode_fn(cfg)
    t = torch.from_numpy(toks)
    st = prefill(tp, t[:, :S0])
    cache, logits = st["cache"], [st["logits_last"].numpy()]
    for i in range(n_dec):
        out = decode(tp, cache, t[:, S0 + i:S0 + i + 1], S0 + i)
        logits.append(out["logits"].numpy())
        cache = out["cache"]
    return logits


@pytest.mark.parametrize("n_layers", [3, 5])
def test_decode_matches_teacher_forcing(n_layers):
    """tests/test_serve.py:24 for the arch: prefill + cached decode against
    the teacher-forced forward through the plain paths, at its 2e-3."""
    cfg = get_reduced(ARCH).replace(n_layers=n_layers)
    tp = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    B, S, S0 = 2, 32, 26
    toks = _rng(1).integers(0, cfg.vocab_size, (B, S))
    full = forward(tp, torch.from_numpy(toks), cfg, attn_impl="plain")["logits"].numpy()
    got = _port_serve(cfg, tp, toks, S0, S - S0, S)
    errs = [float(np.abs(full[:, S0 - 1 + i] - g).max()) for i, g in enumerate(got)]
    assert max(errs) < 2e-3, errs


def test_ring_window_decode_past_window():
    """tests/test_serve.py:53 for the arch: window 16, 48 tokens (3x the
    window), prefill of 8 then decode across the boundary; the ring caches
    must equal the windowed full forward."""
    cfg = get_reduced(ARCH).replace(sliding_window=16)
    tp = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    B, S, S0 = 1, 48, 8
    toks = _rng(3).integers(0, cfg.vocab_size, (B, S))
    full = forward(tp, torch.from_numpy(toks), cfg, attn_impl="plain")["logits"].numpy()
    got = _port_serve(cfg, tp, toks, S0, S - S0, S)
    errs = [float(np.abs(full[:, S0 - 1 + i] - g).max()) for i, g in enumerate(got)]
    assert max(errs) < 2e-3, errs


def test_prefill_past_the_window_then_decode_matches_jax():
    """A prompt longer than the window: prefill rolls the ring, decode wraps
    it; both packages on the same parameters."""
    jcfg, cfg, jp, tp = _setup(5)
    jcfg, cfg = jcfg.replace(sliding_window=16), cfg.replace(sliding_window=16)
    S, S0 = 40, 24
    toks = _rng(5).integers(0, cfg.vocab_size, (1, S))
    st = jax_make_prefill_fn(jcfg, cache_len=S)(jp, jnp.asarray(toks[:, :S0], jnp.int32))
    decode = jax_make_decode_fn(jcfg)
    cache, want = st["cache"], [np.asarray(st["logits_last"])]
    for i in range(S - S0):
        out = decode(jp, cache, jnp.asarray(toks[:, S0 + i:S0 + i + 1], jnp.int32),
                     jnp.asarray(S0 + i, jnp.int32))
        want.append(np.asarray(out["logits"]))
        cache = out["cache"]
    got = _port_serve(cfg, tp, toks, S0, S - S0, S)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=ATOL_LM, err_msg=f"step {i}")


def test_greedy_tokens_equal_jax_engine():
    jcfg, cfg, jp, tp = _setup(0)
    prompts = _rng(7).integers(0, cfg.vocab_size, (3, 8))
    want = JaxEngine(jcfg, jp, max_len=64).generate(
        jnp.asarray(prompts, jnp.int32), max_new_tokens=8)
    got = Engine(cfg, tp, max_len=64, device="cpu").generate(
        torch.from_numpy(prompts), max_new_tokens=8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- launchers -------------------------------------------------------------------------

def test_cli_serves_the_arch_on_cpu(capsys):
    out = serve_cli.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                          "--prompt-len", "8", "--max-new", "4"])
    assert tuple(out.shape) == (2, 4) and out.dtype == torch.int32
    assert f"[serve] {ARCH} on cpu" in capsys.readouterr().out


def test_profile_serve_runs_the_arch_on_cpu():
    from repro_torch.launch import profile_serve
    rows = profile_serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "1",
                               "--prompt-len", "16", "--decode-steps", "2"])
    assert [r["phase"] for r in rows] == ["prefill", "decode"]
    assert all(r["arch"] == ARCH for r in rows)


@pytest.fixture
def one_torch_thread():
    """One torch thread for the reduced model's run (its ops are too small
    to split; beside the suite's other workers the pool only contends),
    then the worker's setting back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_launcher_refuses_the_arch(one_torch_thread):
    """The launcher that once refused the arch trains the reduced config
    on the CPU (K8's backward in its plain version): finite losses."""
    res = train_cli.main(["--arch", ARCH, "--device", "cpu", "--steps", "4",
                          "--nodes", "2", "--per-node-batch", "2", "--seq-len", "16"])
    assert len(res.losses) == 4 and np.isfinite(res.losses).all()
