"""qk-norm, prefix embeddings and M-RoPE in the port (`models/common.py::
head_rms_norm`, `models/rope.py::apply_mrope`, the qk-norm and M-RoPE
branches of `attn_apply`, the prefix splice of `lm.forward`, the prefix and
3-D positions of the serving engine and `make_lm_loss`), held against the
JAX package on the CPU at reduced sizes in f32, with the reference's weights
carried by `params_from_jax`:

  * `head_rms_norm`, `mrope_sections` and `apply_mrope` (three distinct
    position streams, head_dim 64 and 128), and M-RoPE equal to RoPE on
    equal streams;
  * the four configs (qwen3-8b, minitron-8b, qwen2-vl-2b, musicgen-large),
    published and reduced, field for field, and their published parameter
    counts;
  * the reduced forward of all four without and with a prefix, and with
    explicit (B, S, 3) positions where the config reads them;
  * prefill + decode against the reference's step by step and against the
    port's teacher-forced forward (tests/test_serve.py's 2e-3, cache_len =
    S + prefix), and the greedy Engine's tokens with a prefix;
  * `make_lm_loss` with a prefix: the loss and every gradient leaf
    (`q_norm` and `k_norm` among them) against `jax.value_and_grad`;
  * DASO runs of reduced qwen2-vl on a prefix batch and of reduced qwen3,
    the macro executor bit for bit the per-step one;
  * the Engine's `max_len` and device checks with a prefix, and the
    launchers on the CPU.
Inputs are made from a seed with numpy."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.models import common as jax_common
from repro.models import rope as jax_rope
from repro.models.lm import forward as jax_forward
from repro.models.lm import init_params as jax_init_params
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import make_decode_fn as jax_make_decode_fn
from repro.serve.engine import make_prefill_fn as jax_make_prefill_fn
from repro.train.step import make_lm_loss as jax_make_lm_loss
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import common, rope
from repro_torch.models.lm import forward, init_params
from repro_torch.serve.engine import Engine, make_decode_fn, make_prefill_fn
from repro_torch.train import TrainLoopConfig, run_training
from repro_torch.train.step import make_lm_loss
from repro_torch.tree import flatten, leaves

ARCHS = ("qwen3-8b", "minitron-8b", "qwen2-vl-2b", "musicgen-large")
# the reference's init_params, counted with jax.eval_shape
PARAM_COUNTS = {"qwen3-8b": 8_190_735_360, "minitron-8b": 9_882_046_464,
                "qwen2-vl-2b": 1_543_656_960, "musicgen-large": 3_229_812_736}
LOGIT_RTOL = 1e-4  # of max(1, the largest logit): f32 through a 2-layer LM
GRAD_RTOL = 1e-4   # of each leaf's largest value
SERVE_ATOL = 2e-3  # tests/test_serve.py::test_decode_matches_teacher_forcing
ROPE_ATOL = 1e-5   # sin / cos of one f32 angle differ by an ulp or so
FIELDS = [f.name for f in dataclasses.fields(get_config("llama3.2-1b"))
          if f.name not in ("param_dtype", "compute_dtype")]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rng(seed):
    return np.random.default_rng(seed)


def _scaled_close(got, want, rtol, what=""):
    want = np.asarray(want)
    tol = rtol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol, f"{what}: max err {err} > {tol}"


def _prefix_len(cfg):
    """The config's stub prefix, or 4 rows for a config without one (the
    splice takes any prefix)."""
    return cfg.prefix_embed_len or 4


def _prefix(cfg, B, seed):
    """0.1 x N(0, 1), as the reference's tests make the stub embeddings."""
    return (0.1 * _rng(seed).standard_normal((B, _prefix_len(cfg), cfg.d_model))
            ).astype(np.float32)


def _streams(B, S, seed):
    """Three distinct position streams: a 4 x 4 grid's (t = 0, row, col)
    over the first 16 positions, then each stream counting on from its
    largest, as Qwen2-VL numbers an image before text."""
    grid = np.stack([np.zeros(16), np.arange(16) // 4, np.arange(16) % 4], -1)
    text = grid.max() + 1 + np.arange(S - 16)[:, None].repeat(3, -1)
    pos = np.concatenate([grid, text])[None].repeat(B, 0).astype(np.int32)
    return pos + _rng(seed).integers(0, 3, (B, 1, 1)).astype(np.int32)


def _pair(arch, seed):
    jcfg, cfg = jax_get_reduced(arch), get_reduced(arch)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jp, params_from_jax(_np(jp))


# -- building blocks --------------------------------------------------------------------

def test_head_rms_norm_matches_jax():
    x = _rng(0).standard_normal((2, 5, 3, 64), dtype=np.float32)
    s = 0.1 * _rng(1).standard_normal(64, dtype=np.float32)
    want = jax_common.head_rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6)
    got = common.head_rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert common.head_rms_norm(xb, torch.from_numpy(s), 1e-6).dtype == torch.bfloat16


@pytest.mark.parametrize("head_dim,want", [(128, (32, 16, 16)), (64, (16, 8, 8)),
                                           (32, (8, 4, 4))])
def test_mrope_sections_match_jax(head_dim, want):
    assert rope.mrope_sections(head_dim) == want == jax_rope.mrope_sections(head_dim)


@pytest.mark.parametrize("head_dim", [64, 128])
def test_apply_mrope_matches_jax_on_distinct_streams(head_dim):
    rng = _rng(head_dim)
    q = rng.standard_normal((2, 24, 4, head_dim), dtype=np.float32)
    k = rng.standard_normal((2, 24, 2, head_dim), dtype=np.float32)
    pos = _streams(2, 24, head_dim) * 37  # angles up to ~1500 rad
    assert not (pos[..., 0] == pos[..., 1]).all() and not (pos[..., 1] == pos[..., 2]).all()
    jq, jk = jax_rope.apply_mrope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), 1e6)
    tq, tk = rope.apply_mrope(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=ROPE_ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ROPE_ATOL)
    # each section follows its own stream: moving the width stream alone
    # leaves the temporal and height pairs as they were
    moved = pos.copy()
    moved[..., 2] += 5
    mq, _ = rope.apply_mrope(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(moved), 1e6)
    t, h, _ = rope.mrope_sections(head_dim)
    half = head_dim // 2
    for lo in (0, half):  # both halves of the rotate-half layout
        assert torch.equal(mq[..., lo:lo + t + h], tq[..., lo:lo + t + h])
        assert not torch.equal(mq[..., lo + t + h:lo + half], tq[..., lo + t + h:lo + half])


def test_mrope_equals_rope_on_equal_streams():
    rng = _rng(13)
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 32), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 8, 2, 32), dtype=np.float32))
    pos1 = torch.arange(8, dtype=torch.int32).expand(1, 8)
    q1, k1 = rope.apply_rope(q, k, pos1, 10000.0)
    q3, k3 = rope.apply_mrope(q, k, pos1[..., None].expand(1, 8, 3), 10000.0)
    assert torch.equal(q1, q3) and torch.equal(k1, k3)


# -- configs -----------------------------------------------------------------------------

@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_jax(arch, full):
    assert arch in ARCH_IDS
    jcfg = jax_get_config(arch) if full else jax_get_reduced(arch)
    cfg = get_config(arch) if full else get_reduced(arch)
    for f in FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert str(cfg.param_dtype) == f"torch.{jcfg.param_dtype}"
    assert str(cfg.compute_dtype) == f"torch.{jcfg.compute_dtype}"
    if not full:
        assert cfg.prefix_embed_len == min(get_config(arch).prefix_embed_len, 8)


def test_registry_holds_the_references_ids():
    from repro.configs.base import ARCH_IDS as JAX_ARCH_IDS
    assert sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS)


@pytest.mark.parametrize("arch", ARCHS)
def test_published_parameter_count(arch):
    cfg = get_config(arch)
    n = sum(x.numel() for x in leaves(init_params(cfg, torch.Generator(), "meta")))
    assert n == PARAM_COUNTS[arch]


def test_validate_refuses_an_unknown_rope_type():
    with pytest.raises(ValueError, match="rope_type"):
        get_reduced("qwen2-vl-2b").replace(rope_type="yarn").validate()


def test_qk_norm_leaves_draw_nothing_and_convert():
    """Under qk_norm every other leaf keeps its bits (the zero scales draw
    nothing from the generator), and the reference's q_norm / k_norm leaves
    come across by `params_from_jax` to the port's tree."""
    cfg = get_reduced("qwen3-8b")
    with_norm = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    without = init_params(cfg.replace(qk_norm=False), torch.Generator().manual_seed(3), "cpu")
    attn = with_norm["blocks"][0]["attn"]
    assert attn["q_norm"].shape == attn["k_norm"].shape == (cfg.n_layers, cfg.head_dim)
    assert not attn["q_norm"].any() and not attn["k_norm"].any()
    rest = {k: v for k, v in attn.items() if k not in ("q_norm", "k_norm")}
    assert all(torch.equal(a, b) for a, b in zip(leaves(rest),
                                                 leaves(without["blocks"][0]["attn"])))
    jp = _np(jax_init_params(jax_get_reduced("qwen3-8b"), jax.random.PRNGKey(0)))
    tp = params_from_jax(jp)
    assert flatten(tp)[1] == flatten(with_norm)[1]
    assert [tuple(x.shape) for x in leaves(tp)] == [tuple(x.shape) for x in leaves(with_norm)]
    assert np.array_equal(tp["blocks"][0]["attn"]["k_norm"].numpy(),
                          jp["blocks"][0]["attn"]["k_norm"])


# -- forward ----------------------------------------------------------------------------

FORWARD_CASES = [(a, c) for a in ARCHS for c in ("tokens", "prefix")] + [
    ("qwen2-vl-2b", "positions"), ("qwen2-vl-2b", "prefix_positions"),
    ("musicgen-large", "positions")]


@pytest.mark.parametrize("arch,case", FORWARD_CASES)
def test_forward_matches_jax(arch, case):
    """The reduced forward against the reference's: tokens only, a stub
    prefix, explicit positions ((B, S, 3) streams under M-RoPE, whose
    stream 0 the sinusoidal positions read under rope_type none), or both.
    Under qk_norm the scales are set off zero so that they count."""
    jcfg, cfg, jp, tp = _pair(arch, 1)
    if cfg.qk_norm:
        rng = _rng(2)
        for blk in jp["blocks"]:
            for name in ("q_norm", "k_norm"):
                blk["attn"][name] = jnp.asarray(
                    0.3 * rng.standard_normal(blk["attn"][name].shape), jnp.float32)
        tp = params_from_jax(_np(jp))
    B, S_tok = 2, 24
    toks = _rng(9).integers(0, cfg.vocab_size, (B, S_tok)).astype(np.int32)
    kw, tkw = {}, {}
    P = 0
    if "prefix" in case:
        pe = _prefix(cfg, B, 4)
        P = pe.shape[1]
        kw["prefix_embeds"], tkw["prefix_embeds"] = jnp.asarray(pe), torch.from_numpy(pe)
    if "positions" in case:
        pos = _streams(B, P + S_tok, 5)
        kw["positions"], tkw["positions"] = jnp.asarray(pos), torch.from_numpy(pos)
    want = jax_forward(jp, jnp.asarray(toks), jcfg, **kw)["logits"]
    got = forward(tp, torch.from_numpy(toks), cfg, attn_impl="plain", **tkw)["logits"]
    assert tuple(got.shape) == (B, P + S_tok, cfg.vocab_size)
    _scaled_close(got.numpy(), want, LOGIT_RTOL, "logits")
    # the kernel route's plain version on the CPU gives the same logits
    kern = forward(tp, torch.from_numpy(toks), cfg, **tkw)["logits"]
    _scaled_close(kern.numpy(), want, LOGIT_RTOL, "kernel route logits")


def test_default_positions_tile_under_mrope():
    """The M-RoPE default is arange over the spliced length on all three
    streams: the same logits as those positions passed explicitly."""
    _, cfg, _, tp = _pair("qwen2-vl-2b", 2)
    toks = torch.from_numpy(_rng(3).integers(0, cfg.vocab_size, (2, 12)))
    pe = torch.from_numpy(_prefix(cfg, 2, 6))
    S = pe.shape[1] + 12
    pos = torch.arange(S, dtype=torch.int32)[None, :, None].expand(2, S, 3)
    a = forward(tp, toks, cfg, prefix_embeds=pe, attn_impl="plain")["logits"]
    b = forward(tp, toks, cfg, prefix_embeds=pe, positions=pos, attn_impl="plain")["logits"]
    assert torch.equal(a, b)


# -- serving ----------------------------------------------------------------------------

def _jax_serve(jcfg, jp, toks, pe, S0, n_dec, cache_len):
    prefill = jax_make_prefill_fn(jcfg, cache_len=cache_len)
    decode = jax_make_decode_fn(jcfg)
    P = 0 if pe is None else pe.shape[1]
    st = prefill(jp, jnp.asarray(toks[:, :S0]),
                 prefix_embeds=None if pe is None else jnp.asarray(pe))
    cache, logits = st["cache"], [np.asarray(st["logits_last"])]
    for i in range(n_dec):
        out = decode(jp, cache, jnp.asarray(toks[:, S0 + i:S0 + i + 1]),
                     jnp.asarray(P + S0 + i, jnp.int32))
        logits.append(np.asarray(out["logits"]))
        cache = out["cache"]
    return logits


def _port_serve(cfg, tp, toks, pe, S0, n_dec, cache_len):
    prefill = make_prefill_fn(cfg, cache_len=cache_len)
    decode = make_decode_fn(cfg)
    P = 0 if pe is None else pe.shape[1]
    t = torch.from_numpy(toks)
    st = prefill(tp, t[:, :S0], prefix_embeds=None if pe is None else torch.from_numpy(pe))
    cache, logits = st["cache"], [st["logits_last"].numpy()]
    for i in range(n_dec):
        out = decode(tp, cache, t[:, S0 + i:S0 + i + 1], P + S0 + i)
        logits.append(out["logits"].numpy())
        cache = out["cache"]
    return logits


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing_and_jax(arch):
    """tests/test_serve.py::test_decode_matches_teacher_forcing's twin with
    the config's own prefix (none for qwen3 and minitron): prefill + 6
    decode steps within 2e-3 of the teacher-forced forward, and step by
    step within LOGIT_RTOL of the reference's prefill and decode."""
    jcfg, cfg, jp, tp = _pair(arch, 2)
    B, S, S0 = 2, 32, 26
    P = cfg.prefix_embed_len
    toks = _rng(10).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pe = _prefix(cfg, B, 7) if P else None
    got = _port_serve(cfg, tp, toks, pe, S0, S - S0, S + P)
    want = _jax_serve(jcfg, jp, toks, pe, S0, S - S0, S + P)
    for i, (g, w) in enumerate(zip(got, want)):
        _scaled_close(g, w, LOGIT_RTOL, f"step {i}")
    full = forward(tp, torch.from_numpy(toks), cfg, attn_impl="plain",
                   prefix_embeds=None if pe is None else torch.from_numpy(pe))["logits"]
    errs = [float(np.abs(full[:, P + S0 - 1 + i].numpy() - g).max())
            for i, g in enumerate(got)]
    assert max(errs) < SERVE_ATOL, errs


def test_prefill_with_distinct_streams_matches_jax():
    """A qwen2-vl prefill on explicit (B, S, 3) streams (the grid, then
    text) against the reference's: the last logits, and the cache the next
    decode step reads (its logits)."""
    jcfg, cfg, jp, tp = _pair("qwen2-vl-2b", 3)
    B, S_tok = 2, 20
    toks = _rng(11).integers(0, cfg.vocab_size, (B, S_tok + 1)).astype(np.int32)
    pe = _prefix(cfg, B, 8)
    S = pe.shape[1] + S_tok
    pos = _streams(B, S, 9)
    jst = jax_make_prefill_fn(jcfg, cache_len=S + 1)(
        jp, jnp.asarray(toks[:, :S_tok]), prefix_embeds=jnp.asarray(pe),
        positions=jnp.asarray(pos))
    tst = make_prefill_fn(cfg, cache_len=S + 1)(
        tp, torch.from_numpy(toks[:, :S_tok]), prefix_embeds=torch.from_numpy(pe),
        positions=torch.from_numpy(pos))
    _scaled_close(tst["logits_last"].numpy(), jst["logits_last"], LOGIT_RTOL, "prefill")
    jd = jax_make_decode_fn(jcfg)(jp, jst["cache"], jnp.asarray(toks[:, S_tok:]),
                                  jnp.asarray(S, jnp.int32))
    td = make_decode_fn(cfg)(tp, tst["cache"], torch.from_numpy(toks[:, S_tok:]), S)
    _scaled_close(td["logits"].numpy(), jd["logits"], LOGIT_RTOL, "decode")


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-large"])
def test_engine_with_prefix_matches_jax_engine(arch):
    jcfg, cfg, jp, tp = _pair(arch, 4)
    prompts = _rng(12).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    pe = _prefix(cfg, 2, 13)
    max_len = pe.shape[1] + 8 + 6
    jtok = JaxEngine(jcfg, jp, max_len=max_len).generate(
        jnp.asarray(prompts), 6, prefix_embeds=jnp.asarray(pe))
    ttok = Engine(cfg, tp, max_len=max_len, device="cpu").generate(
        torch.from_numpy(prompts), 6, prefix_embeds=torch.from_numpy(pe))
    assert ttok.dtype == torch.int32
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def test_engine_counts_the_prefix_against_max_len():
    cfg = get_reduced("qwen2-vl-2b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    P = cfg.prefix_embed_len
    pe = torch.zeros((1, P, cfg.d_model))
    prompts = torch.zeros((1, 8), dtype=torch.int64)
    eng = Engine(cfg, params, max_len=P + 8 + 3, device="cpu")
    assert eng.generate(prompts, 4, prefix_embeds=pe).shape == (1, 4)
    with pytest.raises(ValueError, match="prefix 8 \\+ prompt 8 \\+ 5 new tokens"):
        eng.generate(prompts, 5, prefix_embeds=pe)
    assert eng.generate(prompts, 4 + P).shape == (1, 4 + P)  # no prefix: room for P more
    with pytest.raises(ValueError, match="prefix_embeds on meta"):
        eng.generate(prompts, 2, prefix_embeds=pe.to("meta"))


# -- training ---------------------------------------------------------------------------

def _loss_batch(cfg, B, S_tok, seed, prefix=True):
    toks = _rng(seed).integers(0, cfg.vocab_size, (B, S_tok + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if prefix:
        pe = _prefix(cfg, B, seed + 1)
        batch["prefix_embeds"] = pe
        ignore = np.full((B, pe.shape[1]), -1, np.int32)
        batch["labels"] = np.concatenate([ignore, batch["labels"]], 1)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_gradients_match_jax(arch):
    """jax.value_and_grad of the reference's make_lm_loss against torch
    autograd of the port's on a prefix batch (labels -1 over the prefix),
    every leaf; under qk_norm the q_norm / k_norm leaves get a gradient."""
    jcfg, cfg, jp, tp = _pair(arch, 6)
    batch = _loss_batch(cfg, 2, 16, 8)
    (jl, _), jg = jax.jit(jax.value_and_grad(jax_make_lm_loss(jcfg), has_aux=True))(
        jp, jax.tree.map(jnp.asarray, batch))
    for t in leaves(tp):
        t.requires_grad_(True)
    tl, _ = make_lm_loss(cfg)(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    want, (got, treedef) = jax.tree.leaves(_np(jg)), flatten(tp)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _scaled_close(g.grad.numpy(), w, GRAD_RTOL, f"leaf {i}")
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            assert tp["blocks"][0]["attn"][name].grad.abs().max() > 0, name


def test_microbatched_prefix_batch_matches_jax():
    """Gradient accumulation over 2 chunks of a prefix batch: every leaf,
    prefix_embeds and the spliced labels among them, split along B; loss
    and gradients against the reference's `microbatched_value_and_grad`."""
    from repro.core import daso as jdaso
    from repro_torch.core import daso
    jcfg, cfg, jp, tp = _pair("qwen2-vl-2b", 7)
    batch = _loss_batch(cfg, 4, 12, 20)
    (jl, _), jg = jax.jit(jdaso.microbatched_value_and_grad(jax_make_lm_loss(jcfg), 2))(
        jp, jax.tree.map(jnp.asarray, batch))
    (tl, _), tg = daso.microbatched_value_and_grad(make_lm_loss(cfg), 2)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for i, (g, w) in enumerate(zip(leaves(tg), jax.tree.leaves(_np(jg)), strict=True)):
        _scaled_close(g.numpy(), w, GRAD_RTOL, f"leaf {i}")


R, PER, SEQ = 2, 2, 16


def _replica_data(cfg, prefix):
    src = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=SEQ, seed=1)
    P = cfg.prefix_embed_len

    def data(step):
        b = {k: v.reshape(R, PER, SEQ) for k, v in src.batch(R * PER, step).items()}
        if prefix:
            g = torch.Generator().manual_seed(100 + step)
            b["prefix_embeds"] = 0.1 * torch.randn((R, PER, P, cfg.d_model), generator=g)
            b["labels"] = torch.cat([torch.full((R, PER, P), -1, dtype=torch.int32),
                                     b["labels"]], -1)
        return b
    return data


@pytest.mark.parametrize("arch,prefix", [("qwen2-vl-2b", True), ("qwen3-8b", False)])
def test_daso_run_macro_bit_for_bit_per_step(arch, prefix):
    """DASO (R = 2, b_max 2) over a few cycles of every mode on a reduced
    qwen2-vl with a prefix leaf (R, B, P, D) in every batch, and on a
    reduced qwen3: the macro executor stages the prefix as it stages the
    tokens, and its losses and carry are the per-step executor's bit for
    bit; the loss falls."""
    cfg = get_reduced(arch).replace(n_layers=1)
    params0 = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    kw = dict(strategy="daso", n_steps=12, n_replicas=R, local_world=2, b_max=2,
              lr=0.05, loss_window=4, device="cpu")
    runs = {ex: run_training(make_lm_loss(cfg), params0, _replica_data(cfg, prefix),
                             TrainLoopConfig(executor=ex, **kw), log=None)
            for ex in ("per_step", "macro")}
    a, b = runs["macro"], runs["per_step"]
    assert a.losses == b.losses
    assert all(torch.equal(x, y) for x, y in zip(leaves(a.carry), leaves(b.carry), strict=True))
    assert {h[1] for h in b.controller.history} >= {"blocking", "send", "receive"}
    assert b.losses[-1] < b.losses[0]


# -- launchers --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_on_cpu(arch, capsys):
    out = serve_cli.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                          "--prompt-len", "8", "--max-new", "4"])
    assert tuple(out.shape) == (2, 4)
    assert f"[serve] {arch} on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_on_cpu(arch, tmp_path, capsys):
    """The reduced config trains on tokens alone, as the reference's
    launcher trains it."""
    train_cli.main(["--arch", arch, "--device", "cpu", "--steps", "4", "--nodes", "2",
                    "--per-node-batch", "1", "--seq-len", "8", "--layers", "1",
                    "--metrics-out", str(tmp_path / "m.json")])
    assert "[train]" in capsys.readouterr().out
    assert (tmp_path / "m.json").exists()
