"""Training through the recurrent families on the CPU: the plain backwards
of the selective scan (K7) and of the RG-LRU scan (K8), and the port's
gradients through them, held against the JAX package, which differentiates
its chunked associative scans with jax.grad (no Pallas is involved: the
reference trains without K7 / K8). Inputs are made from a seed with numpy.

  * `ssm_scan_bwd_ref` / `rglru_scan_bwd_ref` against
    `torch.autograd.gradcheck` of the plain forwards in f64;
  * `ops.ssm_scan` / `ops.rglru_scan` gradients of every input, for a loss
    that reads the sequence, h_final or both, against jax.grad of the
    reference's `selective_scan` / `linear_recurrence` (several chunk
    sizes, N 1 and 16, a ragged Di, S = 1, a nonzero h0), within GRAD_RTOL
    of each gradient's largest magnitude (f32 sums in other orders: the
    reference's scan is a tree, the plain backward a sequential loop);
  * `mamba_apply` / `rglru_apply` parameter gradients and `make_lm_loss`
    gradients of the reduced falcon-mamba-7b and recurrentgemma-9b;
  * one DASO step per exchange kind (the f32 stale merge of a receive step
    on falcon-mamba-7b, the bf16 wire of a blocking step on
    recurrentgemma-9b);
  * the launcher training both reduced configs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core import daso as jdaso
from repro.models import mamba as jax_mamba
from repro.models import rglru as jax_rglru
from repro.models.lm import init_params as jax_init_params
from repro.optim.optimizers import sgd as jax_sgd
from repro.train.step import make_lm_loss as jax_make_lm_loss
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core import daso
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as train_cli
from repro_torch.models import mamba, rglru
from repro_torch.optim.optimizers import sgd
from repro_torch.train.step import make_lm_loss
from repro_torch.tree import leaves

MAMBA_ARCH, RGEMMA_ARCH = "falcon-mamba-7b", "recurrentgemma-9b"
GRAD_RTOL = 1e-4   # of each gradient's largest magnitude, f32
STEP_ATOL = 1e-5   # a DASO step's params / momentum / in-flight (test_torch_moe.py)
BF16_ULP = 2.0 ** -7  # one bf16 ulp of a value, at most, relative to it
MAX_WIRE_FLIPS = 32   # param positions of a blocking step allowed one wire ulp off
R, PER, SEQ = 4, 2, 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The small models' ops are too small to split across threads; beside
    the suite's other workers, each op that fans out to torch's thread pool
    waits for every thread of it (the launcher test took 130 s with the pool
    beside five busy processes, under 1 s without). One thread for this
    module, then the worker's setting back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed):
    return np.random.default_rng(seed)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_close(got, want, rtol=GRAD_RTOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rtol, f"{what}: {err:.3e} of the largest magnitude > {rtol}"


def _scan_inputs(seed, B, S, Di, N, random_h0=True):
    """x, dt, A, Bm, Cm, h0 (f32 numpy) as the mixer makes them, and
    cotangents of y and h_final."""
    rng = _rng(seed)
    x = rng.standard_normal((B, S, Di), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, Di)))).astype(np.float32)
    A = -np.exp(0.5 * rng.standard_normal((Di, N))).astype(np.float32)
    Bm = rng.standard_normal((B, S, N), dtype=np.float32)
    Cm = rng.standard_normal((B, S, N), dtype=np.float32)
    h0 = (rng.standard_normal((B, Di, N), dtype=np.float32) if random_h0
          else np.zeros((B, Di, N), np.float32))
    dy = rng.standard_normal((B, S, Di), dtype=np.float32)
    dh = rng.standard_normal((B, Di, N), dtype=np.float32)
    return (x, dt, A, Bm, Cm, h0), dy, dh


def _rglru_inputs(seed, B, S, W, random_h0=True):
    rng = _rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, W))))).astype(np.float32)
    gx = rng.standard_normal((B, S, W), dtype=np.float32)
    h0 = (rng.standard_normal((B, W), dtype=np.float32) if random_h0
          else np.zeros((B, W), np.float32))
    dhs = rng.standard_normal((B, S, W), dtype=np.float32)
    dh = rng.standard_normal((B, W), dtype=np.float32)
    return (a, gx, h0), dhs, dh


# -- the plain backwards against gradcheck, in f64 ------------------------------------

class _PlainSsm(torch.autograd.Function):
    """ssm_scan_ref forward, ssm_scan_bwd_ref backward: gradcheck compares
    this backward with the forward's finite differences."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return ref.ssm_scan_ref(*args)

    @staticmethod
    def backward(ctx, dy, dh):
        return ref.ssm_scan_bwd_ref(*ctx.saved_tensors, dy, dh)


class _PlainRglru(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, gx, h0):
        hs, h = ref.rglru_scan_ref(a, gx, h0)
        ctx.save_for_backward(a, gx, h0, hs)
        return hs, h

    @staticmethod
    def backward(ctx, dhs, dh):
        return ref.rglru_scan_bwd_ref(*ctx.saved_tensors, dhs, dh)


@pytest.mark.parametrize("B,S,Di,N", [(2, 5, 3, 4), (1, 1, 2, 3), (2, 4, 3, 1)])
def test_ssm_scan_bwd_ref_passes_gradcheck(B, S, Di, N):
    args, _, _ = _scan_inputs(S + N, B, S, Di, N)
    x64 = [torch.from_numpy(a).double().requires_grad_() for a in args]
    assert torch.autograd.gradcheck(_PlainSsm.apply, x64, eps=1e-6, atol=1e-7, rtol=1e-5)


def test_ssm_scan_bwd_ref_takes_no_final_state_cotangent():
    args, dy, _ = _scan_inputs(3, 2, 6, 3, 4)
    t = [torch.from_numpy(a).double() for a in args]
    zero = ref.ssm_scan_bwd_ref(*t, torch.from_numpy(dy).double(), torch.zeros_like(t[5]))
    none = ref.ssm_scan_bwd_ref(*t, torch.from_numpy(dy).double(), None)
    for a, b in zip(zero, none, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,S,W", [(2, 6, 3), (1, 1, 4), (3, 4, 1)])
def test_rglru_scan_bwd_ref_passes_gradcheck(B, S, W):
    args, _, _ = _rglru_inputs(S + W, B, S, W)
    x64 = [torch.from_numpy(a).double().requires_grad_() for a in args]
    assert torch.autograd.gradcheck(_PlainRglru.apply, x64, eps=1e-6, atol=1e-7, rtol=1e-5)


def test_rglru_scan_bwd_ref_rounds_the_product_then_the_sum():
    """g_t = dhs_t + a_{t+1} g_{t+1} as two f32 roundings, the rule the
    backward kernel is held to bit for bit; in f32 whatever a's dtype."""
    args, dhs, dh = _rglru_inputs(5, 2, 7, 5)
    a, gx, h0 = (torch.from_numpy(x) for x in args)
    hs, _ = ref.rglru_scan_ref(a, gx, h0)
    da, dgx, dh0 = ref.rglru_scan_bwd_ref(a, gx, h0, hs, torch.from_numpy(dhs),
                                          torch.from_numpy(dh))
    g = torch.from_numpy(dhs[:, -1]) + torch.from_numpy(dh)
    for t in range(6, -1, -1):
        if t < 6:
            g = torch.from_numpy(dhs[:, t]) + a[:, t + 1] * g
        assert torch.equal(dgx[:, t], g)
        assert torch.equal(da[:, t], g * (hs[:, t - 1] if t else h0))
    assert torch.equal(dh0, a[:, 0] * g)
    bf = [x.to(torch.bfloat16) for x in (a, gx)]
    da16, dgx16, _ = ref.rglru_scan_bwd_ref(*bf, h0, hs, torch.from_numpy(dhs), None)
    assert da16.dtype == dgx16.dtype == torch.bfloat16


# -- ops.ssm_scan / ops.rglru_scan gradients against jax.grad -----------------------

def _jax_vjp(fn, n_in):
    """jit(inputs, cotangents -> the VJP of fn's (out, h_final)); one trace
    per shape."""
    def vjp(*args):
        _, pull = jax.vjp(fn, *args[:n_in])
        return pull(tuple(args[n_in:]))
    return jax.jit(vjp)


_SSM_VJP = {c: _jax_vjp(lambda *a, c=c: jax_mamba.selective_scan(*a, chunk=c), 6)
            for c in (4, 64)}
_LR_VJP = {c: _jax_vjp(lambda *a, c=c: jax_mamba.linear_recurrence(*a, chunk=c), 3)
           for c in (4, 512)}


# which outputs the loss reads: both, the sequence only (no cotangent of
# h_final), h_final only (no cotangent of the sequence)
USES = ("both", "sequence", "final")


def _cotangents(uses, cot_out, cot_h):
    """The cotangents the loss gives (out, h_final), zeros for an unused
    output, as jax.vjp takes them."""
    return (cot_out if uses != "final" else np.zeros_like(cot_out),
            cot_h if uses != "sequence" else np.zeros_like(cot_h))


def _torch_grads(fn, args, uses, cot_out, cot_h):
    """The gradients of a loss that reads `uses` of fn's (out, h_final):
    autograd hands the backward None for an output the loss does not read."""
    xs = [torch.from_numpy(a).requires_grad_() for a in args]
    out, h = fn(*xs)
    terms = []
    if uses != "final":
        terms.append((out * torch.from_numpy(cot_out)).sum())
    if uses != "sequence":
        terms.append((h * torch.from_numpy(cot_h)).sum())
    return [g.numpy() for g in torch.autograd.grad(sum(terms), xs)]


@pytest.mark.parametrize("chunk", [4, 64])
@pytest.mark.parametrize("B,S,Di,N,random_h0", [
    (2, 24, 13, 16, True),   # ragged Di, several chunks of 4
    (2, 8, 8, 1, False),     # N = 1, zero h0
    (3, 1, 5, 16, True),     # S = 1
])
@pytest.mark.parametrize("uses", USES)
def test_ssm_scan_grads_match_jax(chunk, B, S, Di, N, random_h0, uses):
    args, dy, dh = _scan_inputs(S * N + Di, B, S, Di, N, random_h0)
    want = _SSM_VJP[chunk](*(jnp.asarray(a) for a in args),
                           *(jnp.asarray(c) for c in _cotangents(uses, dy, dh)))
    got = _torch_grads(ops.ssm_scan, args, uses, dy, dh)
    for name, g, w in zip(("x", "dt", "A", "Bm", "Cm", "h0"), got, want, strict=True):
        _assert_close(g, w, what=name)


@pytest.mark.parametrize("chunk", [4, 512])
@pytest.mark.parametrize("B,S,W,random_h0", [(2, 24, 13, True), (2, 9, 8, False),
                                             (3, 1, 5, True)])
@pytest.mark.parametrize("uses", USES)
def test_rglru_scan_grads_match_jax(chunk, B, S, W, random_h0, uses):
    args, dhs, dh = _rglru_inputs(S + W, B, S, W, random_h0)
    want = _LR_VJP[chunk](*(jnp.asarray(a) for a in args),
                          *(jnp.asarray(c) for c in _cotangents(uses, dhs, dh)))
    got = _torch_grads(ops.rglru_scan, args, uses, dhs, dh)
    for name, g, w in zip(("a", "gx", "h0"), got, want, strict=True):
        _assert_close(g, w, what=name)


def test_bf16_inputs_take_gradients_in_their_dtype():
    """x / Bm / Cm (and a / gx) in bf16: their gradients come back in bf16,
    the f32 inputs' in f32, each the f32 plain backward's rounded."""
    args, dy, dh = _scan_inputs(8, 2, 6, 8, 4)
    t = [torch.from_numpy(a) for a in args]
    for i in (0, 3, 4):
        t[i] = t[i].to(torch.bfloat16)
    xs = [a.clone().requires_grad_() for a in t]
    y, h = ops.ssm_scan(*xs)
    grads = torch.autograd.grad((y * torch.from_numpy(dy)).sum(), xs)
    want = ref.ssm_scan_bwd_ref(*t, torch.from_numpy(dy), None)
    for g, w, x in zip(grads, want, t, strict=True):
        assert g.dtype == x.dtype and torch.equal(g, w)


# -- the mixers, the LM loss and DASO against the JAX package ----------------------

@functools.lru_cache(maxsize=None)
def _setup(arch):
    """Both packages' reduced configs and the reference's params (numpy,
    its init traced once: eager, the init takes seconds), made once per
    arch."""
    jcfg = jax_get_reduced(arch)
    jp = _np(jax.jit(lambda key: jax_init_params(jcfg, key))(jax.random.PRNGKey(0)))
    return jcfg, get_reduced(arch), jp


def _mixer_grads(jax_apply, torch_apply, jcfg, cfg, jm, x, cot):
    """Gradients of sum(apply(p, x) * cot) in both packages, by leaf name."""
    def jloss(p):
        return jnp.sum(jax_apply(p, jnp.asarray(x), jcfg)[0] * jnp.asarray(cot))
    want = _np(jax.jit(jax.grad(jloss))(jax.tree.map(jnp.asarray, jm)))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in jm.items()}
    out, _ = torch_apply(tp, torch.from_numpy(x), cfg)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), list(tp.values()),
                              allow_unused=True, materialize_grads=True)
    return dict(zip(tp, (g.numpy() for g in got))), want


@pytest.mark.parametrize("arch,kind,apply", [
    (MAMBA_ARCH, "mamba", (jax_mamba.mamba_apply, mamba.mamba_apply)),
    (RGEMMA_ARCH, "rec", (jax_rglru.rglru_apply, rglru.rglru_apply)),
])
def test_mixer_param_grads_match_jax(arch, kind, apply):
    """Every parameter of the first layer's recurrent mixer, at the reduced
    config's widths, on 20 tokens: the gradient through the scan's backward
    (and the conv, gates, projections around it) within GRAD_RTOL."""
    jcfg, cfg, jp = _setup(arch)
    jm = jax.tree.map(lambda a: a[0], jp["blocks"][0][kind])
    rng = _rng(21)
    x = 0.5 * rng.standard_normal((2, 20, cfg.d_model), dtype=np.float32)
    cot = rng.standard_normal((2, 20, cfg.d_model), dtype=np.float32)
    got, want = _mixer_grads(*apply, jcfg, cfg, jm, x, cot)
    assert sorted(got) == sorted(want)
    for k in want:
        _assert_close(got[k], want[k], what=k)


def _batch(cfg, n, seed, step=0):
    b = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=SEQ, seed=seed).batch(n, step=step)
    return {k: v.numpy() for k, v in b.items()}


@pytest.mark.parametrize("arch", [MAMBA_ARCH, RGEMMA_ARCH])
def test_lm_loss_grads_match_jax(arch):
    """`make_lm_loss` of the reduced config (falcon-mamba-7b: 2 mamba layers;
    recurrentgemma-9b: two RG-LRU layers and a local-attention layer):
    loss within 1e-5 and every leaf's gradient within GRAD_RTOL."""
    jcfg, cfg, jp = _setup(arch)
    batch = _batch(cfg, 2, seed=4)
    (jl, _), jg = jax.jit(jax.value_and_grad(jax_make_lm_loss(jcfg), has_aux=True))(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, batch))
    vg = daso.value_and_grad(make_lm_loss(cfg))
    (tl, _), tg = vg(params_from_jax(jp), {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-5, rtol=0)
    g, w = leaves(tg), jax.tree.leaves(_np(jg))
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        _assert_close(a.numpy(), b, what=f"leaf {i}")


def _daso_problem(arch):
    jcfg, tcfg, p0 = _setup(arch)
    rng = _rng(12)

    def spread(scale):
        return jax.tree.map(lambda a: (a[None] + scale * rng.standard_normal(
            (R,) + a.shape)).astype(np.float32), p0)

    params, inflight = spread(0.01), spread(0.02)
    opt = {"mu": jax.tree.map(lambda a: (0.1 * rng.standard_normal(a.shape))
                              .astype(np.float32), params)}
    batch = {k: v.reshape((R, PER, SEQ)) for k, v in _batch(tcfg, R * PER, 1, 3).items()}
    return dict(jcfg=jcfg, tcfg=tcfg, jax=(params, opt, inflight), batch=batch)


@pytest.mark.parametrize("arch,mode", [(MAMBA_ARCH, "receive"), (RGEMMA_ARCH, "blocking")])
def test_daso_step_matches_jax(arch, mode):
    """One DASO step (4 replicas) per exchange kind, each on one of the two
    families: through the recurrent LM's gradient and the stale f32 merge
    (receive) or the bf16 wire (blocking). Params, momentum, in-flight
    buffer and the metrics within STEP_ATOL, element for element. One
    exception, on the blocking step's params, the only leaves that crossed
    the bf16 wire: the f32 params the two packages pack differ in their last
    bits, and a value at a bf16 rounding edge rounds to its other
    neighbour. The average over the wire then moves by one bf16 ulp of the
    sums it forms, so such a position may differ by BF16_ULP of the sum of
    its R incoming magnitudes (the step's input params stand for the packed
    values, which the step moves by lr x grad), in every replica's row (each
    holds the average), and at most MAX_WIRE_FLIPS positions in all may (11
    of the 2,135,808 a replica do)."""
    daso_problem = _daso_problem(arch)
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
    flips = 0
    for i, (got, want) in enumerate(zip(tout[:3], jout[:3])):
        g, w = leaves(got), jax.tree.leaves(_np(want))
        assert len(g) == len(w)
        for j, (a, b, p_in) in enumerate(zip(g, w, jax.tree.leaves(params))):
            err = np.abs(a.numpy().astype(np.float64) - b)
            off = err > STEP_ATOL
            if mode == "blocking" and i == 0:
                wire_sum = np.abs(p_in.astype(np.float64)).sum(axis=0)
                flip = off & (err <= BF16_ULP * wire_sum + STEP_ATOL)
                flips += int(flip.any(axis=0).sum())
                off &= ~flip
            assert not off.any(), (f"state {i} leaf {j}: {int(off.sum())} elements off, "
                                   f"worst {err.max():.3e}")
    assert flips <= MAX_WIRE_FLIPS, f"{flips} positions one wire ulp off the reference's"
    tm, jm = tout[3], jout[3]
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), atol=STEP_ATOL, rtol=0,
                                   err_msg=k)


# -- the launcher ------------------------------------------------------------------

@pytest.mark.parametrize("arch", [MAMBA_ARCH, RGEMMA_ARCH])
def test_launcher_trains_the_reduced_config(arch, capsys):
    """The reduced config (no --tiny) trains on the macro executor: finite
    losses and one summary line."""
    res = train_cli.main(["--arch", arch, "--device", "cpu", "--steps", "6", "--nodes", "2",
                          "--per-node-batch", "2", "--seq-len", "16"])
    assert len(res.losses) == 6 and np.isfinite(res.losses).all()
    assert "[train] strategy=daso steps=6" in capsys.readouterr().out
