"""The port's mixture of experts (`repro_torch.models.moe`, the MoE branch
of the blocks, the aux sum of `forward`, the MoE losses of `make_lm_loss`)
held against the JAX package on the CPU, at reduced sizes in f32, with the
reference's weights carried by `params_from_jax`:

  * the three MoE configs (granite-moe-3b-a800m, moonshot-v1-16b-a3b,
    mixtral-8x22b), published and reduced, field for field;
  * `moe_apply`: output within 1e-5 of its largest magnitude, the three aux
    values within 1e-6 and the dispatch mask identical, for one group per
    row, a reshape into groups and a sequence longer than a group that is
    not a whole number of them (no reshape), with tokens dropped for
    capacity in at least one case;
  * the top-k tie rule: equal probabilities give `jax.lax.top_k`'s order
    (lower index first), which `torch.topk` does not give;
  * gradients of ce + lb + z through `moe_apply` and through a reduced
    granite `make_lm_loss`, every leaf within 1e-4 of its largest value;
  * `forward` logits and summed aux of the three reduced configs;
  * serving: prefill + 6 decode steps and the greedy Engine under the
    reference tests' `_no_drop` capacity, and a prefill at capacity 1.25
    against the reference's forward;
  * DASO: a receive and a blocking step on a tiny granite;
  * the launchers on the CPU.
Inputs are made from a seed with numpy."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.core import daso as jdaso
from repro.models.lm import forward as jax_forward
from repro.models.lm import init_params as jax_init_params
from repro.models.moe import init_moe as jax_init_moe
from repro.models.moe import moe_apply as jax_moe_apply
from repro.optim.optimizers import sgd as jax_sgd
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import make_decode_fn as jax_make_decode_fn
from repro.serve.engine import make_prefill_fn as jax_make_prefill_fn
from repro.train.step import make_lm_loss as jax_make_lm_loss
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core import daso
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import moe
from repro_torch.models.lm import forward, init_params
from repro_torch.optim.optimizers import sgd
from repro_torch.serve.engine import Engine, make_decode_fn, make_prefill_fn
from repro_torch.train.step import make_lm_loss
from repro_torch.tree import leaves

MOE_ARCHS = ("granite-moe-3b-a800m", "moonshot-v1-16b-a3b", "mixtral-8x22b")
OUT_RTOL = 1e-5    # of the output's largest magnitude: f32, other summation orders
AUX_ATOL = 1e-6
GRAD_RTOL = 1e-4   # of each leaf's largest value
LOGIT_RTOL = 1e-4  # of max(1, the largest logit): f32 through a 2-layer LM
# the port's ArchConfig fields besides the dtypes (torch.dtype there, a
# string in the reference)
FIELDS = [f.name for f in dataclasses.fields(get_config("llama3.2-1b"))
          if f.name not in ("param_dtype", "compute_dtype")]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rng(seed):
    return np.random.default_rng(seed)


def _with_moe(cfg, **kw):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **kw))


def _no_drop(cfg):
    """Capacity factor E / K (`tests/test_serve.py::_no_drop`): capacity
    depends on the group's length, so a decode step (S = 1, C = 1) drops
    nothing while a teacher-forced forward over the whole sequence may drop
    the same token."""
    return _with_moe(cfg, capacity_factor=float(cfg.moe.n_experts) / cfg.moe.top_k)


def _scaled_close(got, want, rtol, what=""):
    want = np.asarray(want)
    tol = rtol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol, f"{what}: max err {err} > {tol}"


# -- configs --------------------------------------------------------------------

@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_config_fields_match_jax(arch, full):
    assert arch in ARCH_IDS
    jcfg = jax_get_config(arch) if full else jax_get_reduced(arch)
    cfg = get_config(arch) if full else get_reduced(arch)
    for f in FIELDS:
        if f == "moe":
            assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(jcfg.moe)
        else:
            assert getattr(cfg, f) == getattr(jcfg, f), f
    assert str(cfg.param_dtype) == f"torch.{jcfg.param_dtype}"
    assert str(cfg.compute_dtype) == f"torch.{jcfg.compute_dtype}"
    # the reference's fields the port lacks are at their defaults here
    assert not jcfg.qk_norm and jcfg.prefix_embed_len == 0
    assert cfg.d_ff == 0 or not full


def test_validate_refuses_top_k_above_n_experts():
    cfg = _with_moe(get_reduced("granite-moe-3b-a800m"), top_k=5)
    with pytest.raises(ValueError, match="top_k"):
        cfg.validate()


def test_moe_config_gives_every_attention_layer_an_moe_and_no_dense_ffn():
    """Every MoE config has d_ff = 0: the blocks must still get their FFN,
    the MoE (the reference's `_has_ffn`)."""
    cfg = get_reduced("granite-moe-3b-a800m")
    assert cfg.d_ff == 0
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    block = p["blocks"][0]
    assert sorted(block) == ["attn", "moe", "moe_norm"]
    assert sorted(block["moe"]) == ["router", "we1", "we2", "we3"]
    assert block["moe"]["router"].dtype == torch.float32
    assert p["embed"]["tok"].shape == (cfg.vocab_size, cfg.d_model)


# -- the MoE layer ---------------------------------------------------------------

# (name, group_size, B, S): one group per row (S <= G), a reshape into groups
# (S > G, S % G == 0), and S > G with S % G != 0 (no reshape)
CASES = [("one_group_per_row", 2048, 2, 32), ("reshape_into_groups", 16, 2, 64),
         ("no_reshape_ragged", 16, 3, 40)]


def _spy_dispatch(monkeypatch, module, name):
    """Record the first operand of every dispatch einsum ("bsec,bsd->ebcd")
    that `module.name` makes."""
    seen, real = [], getattr(module, name)

    def spy(eq, *ops, **kw):
        if eq == "bsec,bsd->ebcd":
            seen.append(ops[0])
        return real(eq, *ops, **kw)

    monkeypatch.setattr(module, name, spy)
    return seen


def _jax_moe(monkeypatch, p, x, jcfg):
    """The reference's moe_apply, jitted, with its dispatch mask."""
    def run(p, x):
        seen = _spy_dispatch(monkeypatch, jnp, "einsum")
        out, aux = jax_moe_apply(p, x, jcfg)
        return out, aux, seen
    out, aux, seen = jax.jit(run)(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    monkeypatch.undo()
    return np.asarray(out), _np(aux), [np.asarray(d) for d in seen]


def _port_moe(monkeypatch, p, x, cfg):
    seen = _spy_dispatch(monkeypatch, torch, "einsum")
    out, aux = moe.moe_apply(state_from_jax(p), torch.from_numpy(x), cfg)
    monkeypatch.undo()
    return out, aux, [d.numpy() for d in seen]


def _moe_pair(arch, group_size, seed, router_zero=False):
    jcfg = _with_moe(jax_get_reduced(arch), group_size=group_size)
    cfg = _with_moe(get_reduced(arch), group_size=group_size)
    p = _np(jax_init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32))
    if router_zero:
        p["router"] = np.zeros_like(p["router"])
    return jcfg, cfg, p


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "moonshot-v1-16b-a3b"])
def test_moe_apply_matches_jax(arch, case, monkeypatch):
    _, G, B, S = case
    jcfg, cfg, p = _moe_pair(arch, G, 0)
    assert ("shared" in p) == (arch == "moonshot-v1-16b-a3b")
    x = _rng(1).standard_normal((B, S, cfg.d_model), dtype=np.float32)
    want, jaux, jseen = _jax_moe(monkeypatch, p, x, jcfg)
    got, taux, tseen = _port_moe(monkeypatch, p, x, cfg)
    assert got.shape == (B, S, cfg.d_model)
    _scaled_close(got.numpy(), want, OUT_RTOL, "output")
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]), atol=AUX_ATOL,
                                   rtol=0, err_msg=k)
    assert len(jseen) == len(tseen) == 1
    np.testing.assert_array_equal(tseen[0], jseen[0])
    groups = B * S // G if S > G and S % G == 0 else B
    assert tseen[0].shape[:2] == (groups, B * S // groups)


def test_some_case_drops_tokens_for_capacity(monkeypatch):
    """The reshape into groups of 16 at capacity 1.25 drops tokens: the
    capacity path (pos >= C) is exercised, not just the dispatch."""
    jcfg, cfg, p = _moe_pair("granite-moe-3b-a800m", 16, 0)
    x = _rng(1).standard_normal((2, 64, cfg.d_model), dtype=np.float32)
    _, jaux, _ = _jax_moe(monkeypatch, p, x, jcfg)
    _, taux, _ = _port_moe(monkeypatch, p, x, cfg)
    assert float(taux["moe_drop_frac"]) > 0
    np.testing.assert_allclose(float(taux["moe_drop_frac"]), float(jaux["moe_drop_frac"]),
                               atol=AUX_ATOL)


def test_top_k_ties_take_the_lower_index_first():
    """A row of equal probabilities: `jax.lax.top_k` gives [0, 1, ..., K-1],
    and so does the port's rule; `torch.topk` gives another order here."""
    E, K = 40, 8
    probs = np.full((3, E), 1.0 / E, dtype=np.float32)
    probs[1, [5, 9, 30]] = 0.5  # partial ties: three equal leaders, then a tie
    probs[2] = _rng(2).permutation(np.repeat(np.arange(10, dtype=np.float32), 4))
    jv, ji = jax.lax.top_k(jnp.asarray(probs), K)
    tv, ti = moe.top_k_lowest_index_first(torch.from_numpy(probs), K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert np.asarray(ji)[0].tolist() == list(range(K))
    naive = torch.topk(torch.from_numpy(probs[:1]), K).indices
    assert naive[0].tolist() != list(range(K)), naive


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "moonshot-v1-16b-a3b"])
def test_zero_router_routes_as_the_reference(arch, monkeypatch):
    """A zero router makes every probability equal: the whole layer (every
    token's experts are 0..K-1, then capacity drops the rest) is the
    reference's, dispatch bit for bit."""
    jcfg, cfg, p = _moe_pair(arch, 2048, 3, router_zero=True)
    x = _rng(3).standard_normal((2, 24, cfg.d_model), dtype=np.float32)
    want, jaux, jseen = _jax_moe(monkeypatch, p, x, jcfg)
    got, taux, tseen = _port_moe(monkeypatch, p, x, cfg)
    np.testing.assert_array_equal(tseen[0], jseen[0])
    _scaled_close(got.numpy(), want, OUT_RTOL, "output")
    assert float(taux["moe_drop_frac"]) > 0  # experts 0 and 1 overflow
    for k in jaux:
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]), atol=AUX_ATOL)


def test_pinned_indices_give_the_routed_layer(monkeypatch):
    """Routing pinned from outside, as a check pins it across two paths:
    `moe.top_k_lowest_index_first` patched to return recorded indices, with
    the gates gathered from this call's probabilities, gives the layer as
    routed, bit for bit; another routing replayed the same way gives
    another output."""
    _, cfg, p = _moe_pair("moonshot-v1-16b-a3b", 2048, 4)
    tp = state_from_jax(p)
    x = torch.from_numpy(_rng(4).standard_normal((2, 16, cfg.d_model), dtype=np.float32))
    real, recorded = moe.top_k_lowest_index_first, []

    def record(probs, k):
        vals, idx = real(probs, k)
        recorded.append(idx)
        return vals, idx

    monkeypatch.setattr(moe, "top_k_lowest_index_first", record)
    a, aux_a = moe._moe_grouped(tp, x, cfg)
    (idx,) = recorded

    def replay(pinned):
        monkeypatch.setattr(moe, "top_k_lowest_index_first",
                            lambda probs, k: (probs.gather(-1, pinned), pinned))
        return moe._moe_grouped(tp, x, cfg)

    b, aux_b = replay(idx)
    assert torch.equal(a, b)
    for k in aux_a:
        assert torch.equal(aux_a[k], aux_b[k])
    c, _ = replay(idx.flip(-1).roll(1, dims=1))
    assert not torch.equal(a, c)


def test_moe_gradients_match_jax():
    """d(ce + lb + z) / d(params, x) through `moe_apply` (the reshape into
    groups, with drops): ce of the output projected to 16 classes."""
    jcfg, cfg, p = _moe_pair("moonshot-v1-16b-a3b", 16, 5)
    B, S, V = 2, 64, 16
    x = _rng(5).standard_normal((B, S, cfg.d_model), dtype=np.float32)
    w = (0.05 * _rng(6).standard_normal((cfg.d_model, V))).astype(np.float32)
    labels = _rng(7).integers(0, V, (B, S))

    def jloss(p, x):
        out, aux = jax_moe_apply(p, x, jcfg)
        logp = jax.nn.log_softmax(out @ w, axis=-1)
        ce = -jnp.take_along_axis(logp, jnp.asarray(labels)[..., None], -1).mean()
        return ce + aux["moe_lb_loss"] + aux["moe_z_loss"]

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jax.tree.map(jnp.asarray, p),
                                                   jnp.asarray(x))
    tp = state_from_jax(p)
    for t in leaves(tp):
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_apply(tp, tx, cfg)
    logp = torch.log_softmax(out @ torch.from_numpy(w), dim=-1)
    ce = -torch.take_along_dim(logp, torch.from_numpy(labels)[..., None], -1).mean()
    (ce + aux["moe_lb_loss"] + aux["moe_z_loss"]).backward()
    want = jax.tree.leaves(_np(jg[0])) + [np.asarray(jg[1])]
    got = [t.grad.numpy() for t in leaves(tp)] + [tx.grad.numpy()]
    assert len(got) == len(want) == 8  # router, 3 experts, 3 shared, x
    for i, (g, wt) in enumerate(zip(got, want)):
        assert np.abs(wt).max() > 0, i
        _scaled_close(g, wt, GRAD_RTOL, f"leaf {i}")


def test_lm_loss_gradients_match_jax():
    """jax.grad of the reference's make_lm_loss (ce + lb + z) against torch
    autograd of the port's on a reduced granite, every leaf."""
    jcfg, cfg = jax_get_reduced("granite-moe-3b-a800m"), get_reduced("granite-moe-3b-a800m")
    jp = _np(jax_init_params(jcfg, jax.random.PRNGKey(6)))
    toks = _rng(8).integers(0, cfg.vocab_size, (2, 17))
    batch = {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jax_make_lm_loss(jcfg), has_aux=True))(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, batch))
    tp = params_from_jax(jp)
    for t in leaves(tp):
        t.requires_grad_(True)
    tl, taux = make_lm_loss(cfg)(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), atol=AUX_ATOL, err_msg=k)
    assert float(jaux["moe_lb_loss"]) > 0 and float(jaux["moe_z_loss"]) > 0
    np.testing.assert_allclose(tl.item(), float(jaux["ce"] + jaux["moe_lb_loss"]
                                                + jaux["moe_z_loss"]), rtol=1e-6)
    want = jax.tree.leaves(_np(jg))
    got = [t.grad for t in leaves(tp)]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _scaled_close(g.numpy(), w, GRAD_RTOL, f"leaf {i}")


# -- forward and serving -----------------------------------------------------------

def _lm_pair(arch, seed, no_drop=False):
    jcfg, cfg = jax_get_reduced(arch), get_reduced(arch)
    if no_drop:
        jcfg, cfg = _no_drop(jcfg), _no_drop(cfg)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jp, params_from_jax(_np(jp))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_logits_and_aux_match_jax(arch):
    jcfg, cfg, jp, tp = _lm_pair(arch, 1)
    toks = _rng(9).integers(0, cfg.vocab_size, (2, 32))
    want = jax_forward(jp, jnp.asarray(toks, jnp.int32), jcfg)
    got = forward(tp, torch.from_numpy(toks), cfg, attn_impl="plain")
    _scaled_close(got["logits"].numpy(), want["logits"], LOGIT_RTOL, "logits")
    assert sorted(got["aux"]) == sorted(want["aux"])
    for k, v in want["aux"].items():
        assert got["aux"][k].dtype == torch.float32
        np.testing.assert_allclose(got["aux"][k].item(), float(v), atol=AUX_ATOL, err_msg=k)
    # summed over the layers: each layer contributes a positive lb and z
    assert float(want["aux"]["moe_lb_loss"]) > cfg.n_layers * 0.5 * cfg.moe.load_balance_loss


def test_dense_forward_aux_is_f32_zeros():
    cfg = get_reduced("llama3.2-1b")
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    out = forward(p, torch.zeros((1, 4), dtype=torch.int64), cfg, attn_impl="plain")
    assert sorted(out["aux"]) == ["moe_drop_frac", "moe_lb_loss", "moe_z_loss"]
    for v in out["aux"].values():
        assert v.dtype == torch.float32 and v.item() == 0.0


def test_dense_aux_is_one_shared_zero_that_trains(monkeypatch):
    """A dense forward's aux is one 0-d f32 zero per device, made once:
    made first under inference mode (as a serve step makes it), it is an
    ordinary tensor, so a later training loss adds it and backpropagates;
    the total is the cross-entropy bit for bit."""
    from repro_torch.models import lm
    monkeypatch.setattr(lm, "_ZEROS", {})
    cfg = get_reduced("llama3.2-1b")
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_rng(8).integers(0, cfg.vocab_size, (2, 8)))
    with torch.inference_mode():
        first = forward(p, toks, cfg, attn_impl="plain")["aux"]
    zero = first["moe_lb_loss"]
    assert not zero.is_inference() and all(v is zero for v in first.values())
    params = {k: v for k, v in p.items()}
    for x in leaves(params):
        x.requires_grad_(True)
    batch = {"tokens": toks, "labels": toks}
    total, aux = make_lm_loss(cfg)(params, batch)
    assert aux["moe_z_loss"] is zero
    assert torch.equal(total, aux["ce"])
    total.backward()
    assert all(x.grad is not None for x in leaves(params))
    assert zero.item() == 0.0

def _jax_serve(jcfg, jp, toks, S0, n_dec, cache_len):
    prefill = jax_make_prefill_fn(jcfg, cache_len=cache_len)
    decode = jax_make_decode_fn(jcfg)
    st = prefill(jp, jnp.asarray(toks[:, :S0], jnp.int32))
    cache, logits = st["cache"], [np.asarray(st["logits_last"])]
    for i in range(n_dec):
        out = decode(jp, cache, jnp.asarray(toks[:, S0 + i:S0 + i + 1], jnp.int32),
                     jnp.asarray(S0 + i, jnp.int32))
        logits.append(np.asarray(out["logits"]))
        cache = out["cache"]
    return logits


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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_decode_and_engine_match_jax_without_drops(arch):
    """Prefill + 6 decode steps at `_no_drop` capacity, step by step, and
    the port's decode against its own teacher-forced forward; on granite
    also the greedy Engine's tokens."""
    jcfg, cfg, jp, tp = _lm_pair(arch, 2, no_drop=True)
    B, S, S0 = 2, 32, 26
    toks = _rng(10).integers(0, cfg.vocab_size, (B, S))
    want = _jax_serve(jcfg, jp, toks, S0, S - S0, S)
    got = _port_serve(cfg, tp, toks, S0, S - S0, S)
    for i, (g, w) in enumerate(zip(got, want)):
        _scaled_close(g, w, LOGIT_RTOL, f"step {i}")
    full = forward(tp, torch.from_numpy(toks), cfg, attn_impl="plain")["logits"]
    for i, g in enumerate(got):
        _scaled_close(g, full[:, S0 - 1 + i].numpy(), LOGIT_RTOL, f"teacher step {i}")
    if arch != "granite-moe-3b-a800m":
        return
    prompts = toks[:, :8]
    jtok = JaxEngine(jcfg, jp, max_len=16).generate(jnp.asarray(prompts, jnp.int32), 6)
    ttok = Engine(cfg, tp, max_len=16, device="cpu").generate(torch.from_numpy(prompts), 6)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_at_published_capacity_matches_jax_forward(arch):
    """Capacity 1.25 over the whole prompt (tokens dropped): the prefill's
    last logits equal the reference's forward's."""
    jcfg, cfg, jp, tp = _lm_pair(arch, 3)
    toks = _rng(11).integers(0, cfg.vocab_size, (2, 48))
    want = jax_forward(jp, jnp.asarray(toks, jnp.int32), jcfg)
    assert float(want["aux"]["moe_drop_frac"]) > 0
    st = make_prefill_fn(cfg, cache_len=48)(tp, torch.from_numpy(toks))
    _scaled_close(st["logits_last"].numpy(), np.asarray(want["logits"])[:, -1],
                  LOGIT_RTOL, "last logits")


# -- DASO ----------------------------------------------------------------------------

R, PER, SEQ = 4, 2, 16
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, vocab_size=128)


@pytest.fixture(scope="module")
def daso_problem():
    arch = "granite-moe-3b-a800m"
    jcfg, tcfg = jax_get_reduced(arch).replace(**TINY), get_reduced(arch).replace(**TINY)
    p0 = _np(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    rng = _rng(12)

    def spread(scale):
        return jax.tree.map(lambda a: (a[None] + scale * rng.standard_normal(
            (R,) + a.shape)).astype(np.float32), p0)

    params, inflight = spread(0.01), spread(0.02)
    opt = {"mu": jax.tree.map(lambda a: (0.1 * rng.standard_normal(a.shape))
                              .astype(np.float32), params)}
    flat = SyntheticLM(vocab_size=tcfg.vocab_size, seq_len=SEQ, seed=1).batch(R * PER, step=3)
    batch = {k: v.reshape((R, PER, SEQ)).numpy() for k, v in flat.items()}
    return dict(jcfg=jcfg, tcfg=tcfg, jax=(params, opt, inflight), batch=batch)


@pytest.mark.parametrize("mode", ["receive", "blocking"])
def test_daso_step_matches_jax(daso_problem, mode):
    """One DASO step on a tiny granite (4 replicas, the MoE losses in the
    total), through the local step and the stale f32 merge (receive) or the
    bf16 wire (blocking): params, optimizer state, in-flight buffer within
    1e-5 and the metrics, the MoE aux means among them. The exchange is the
    same for every model; `tests/test_torch_daso.py` holds every mode."""
    jcfg, tcfg = daso_problem["jcfg"], daso_problem["tcfg"]
    params, opt, inflight = daso_problem["jax"]
    kw = dict(n_replicas=R, global_world=R * 4, b_max=4)
    jstep = jax.jit(jdaso.daso_train_step(jax_make_lm_loss(jcfg), jax_sgd(0.9, 1e-4),
                                          jdaso.DasoConfig(**kw), mode=mode, staleness=2))
    jout = jstep(*(jax.tree.map(jnp.asarray, t) for t in (params, opt, inflight)),
                 jax.tree.map(jnp.asarray, daso_problem["batch"]), jnp.float32(0.05))
    tstep = daso.daso_train_step(make_lm_loss(tcfg), sgd(0.9, 1e-4), daso.DasoConfig(**kw),
                                 mode=mode, staleness=2)
    tout = tstep(*(state_from_jax(t) for t in (params, opt, inflight)),
                 {k: torch.from_numpy(v) for k, v in daso_problem["batch"].items()}, 0.05)
    for got, want in zip(tout[:3], jout[:3]):
        g, w = leaves(got), jax.tree.leaves(_np(want))
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=0)
    tm, jm = tout[3], jout[3]
    assert sorted(tm) == sorted(jm)
    assert {"moe_lb_loss", "moe_z_loss", "moe_drop_frac", "ce"} <= set(tm)
    for k in jm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), atol=1e-5, rtol=0,
                                   err_msg=k)
    assert float(tm["moe_lb_loss"]) > 0 and float(tm["moe_z_loss"]) > 0


# -- launchers -------------------------------------------------------------------

def test_launch_train_tiny_granite_on_cpu(tmp_path, capsys):
    """`--tiny` shrinks the LM fields and leaves the reduced MoE as it is
    (the reference's launcher); the run trains."""
    out = tmp_path / "m.json"
    train_cli.main(["--arch", "granite-moe-3b-a800m", "--tiny", "--device", "cpu",
                    "--steps", "8", "--nodes", "2", "--per-node-batch", "2",
                    "--seq-len", "16", "--metrics-out", str(out)])
    assert "[train]" in capsys.readouterr().out
    args = train_cli.parse_args(["--arch", "granite-moe-3b-a800m", "--tiny"])
    cfg = train_cli.build_config(args)
    assert cfg.d_model == 128 and cfg.moe == get_reduced("granite-moe-3b-a800m").moe
    assert out.exists()


def test_launch_serve_mixtral_on_cpu(capsys):
    out = serve_cli.main(["--arch", "mixtral-8x22b", "--device", "cpu", "--batch", "2",
                          "--prompt-len", "8", "--max-new", "4"])
    assert tuple(out.shape) == (2, 4)
    assert "[serve] mixtral-8x22b on cpu" in capsys.readouterr().out
