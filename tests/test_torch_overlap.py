"""The port's one-cycle overlap schedule held against the JAX package on
the CPU (twins of tests/test_overlap.py), and the slice as a whole:

  * Eq. (1) with extra staleness 0 is the pre-overlap merge, bit for bit;
  * the controller's ov_start / ov_sync~E tokens, the plan_cycle cut after
    an ov step, its state dicts (with and without `_ov_last`) and the sync
    fraction, each equal to the reference's;
  * the 4-slot carry, and the sync baseline refusing the overlap schedule;
  * one step of each OV mode of `daso_overlap_step` within 1e-5 of the
    reference's (f32, the two frameworks sum in other orders inside the
    model): on the LM at the f32 / bf16 tiers, and on the int8 tier on an
    MLP whose leaves both packages pack in one order (with int8 send /
    blocking steps); the LM's int8 exchange follows the port's own leaf
    order, which differs from the reference's stacked layers (stated and
    checked here);
  * 60 quickstart-scale steps of `--wire-format int8 --overlap one_cycle`
    on the per-step executor against the reference's: identical mode
    history (ov_sync~E tokens included) and sync_fraction, losses within
    rtol 1e-4; and the twin of tests/test_executor.py:121 (int8 wire
    training converges).
Inputs are made from a seed with numpy."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_reduced as jax_get_reduced
from repro.core import daso as jdaso
from repro.core import executor as jexecutor
from repro.core import schedule as jschedule
from repro.data.synthetic import SyntheticLM as JaxSyntheticLM
from repro.models.lm import init_params as jax_init_params
from repro.optim.optimizers import sgd as jax_sgd
from repro.train.loop import TrainLoopConfig as JaxTrainLoopConfig
from repro.train.loop import run_training as jax_run_training
from repro.train.step import make_lm_loss as jax_make_lm_loss
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core import daso, executor, schedule
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.optim.optimizers import sgd
from repro_torch.train.loop import TrainLoopConfig, run_training
from repro_torch.train.step import make_lm_loss
from repro_torch.tree import leaves

R, PER, SEQ = 4, 2, 16
STEP_ATOL = 1e-5
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
            vocab_size=128)


# -- Eq. (1) with extra staleness -------------------------------------------------

def _old_eq1(local, stale, s, p):
    """The pre-overlap Eq. (1) merge, written out independently (JAX)."""
    s2, pf = jnp.float32(2.0 * s), jnp.float32(float(p))
    out = (s2 * local.astype(jnp.float32) + pf * stale.astype(jnp.float32)) / (s2 + pf)
    return out.astype(local.dtype)


@settings(max_examples=15, deadline=None)
@given(st.integers(1, 8), st.integers(2, 64), st.sampled_from(["float32", "bfloat16"]))
def test_extra_staleness_zero_is_pre_overlap_merge(staleness, world, dtype):
    """tests/test_overlap.py:58: extra_staleness=0 is bit-exact with the
    pre-overlap merge, and (S, E) merges as (S + E, 0)."""
    rng = np.random.default_rng(staleness * 1000 + world)
    x, y = (rng.standard_normal((2, 33)).astype(np.float32) for _ in range(2))
    want = _old_eq1(jnp.asarray(x).astype(dtype), jnp.asarray(y).astype(dtype),
                    staleness, world)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ty = torch.from_numpy(y).to(getattr(torch, dtype))
    got = ops.eq1_merge(tx, ty, staleness=staleness, global_world=world, extra_staleness=0)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    shifted = ops.eq1_merge(tx, ty, staleness=1, global_world=world,
                            extra_staleness=staleness - 1)
    assert torch.equal(shifted, got)


# -- controller schedule ------------------------------------------------------------

def _kw(overlap="one_cycle", **kw):
    base = dict(n_replicas=2, global_world=4, b_max=4, warmup_steps=3, cooldown_steps=2,
                total_steps=16, overlap=overlap)
    base.update(kw)
    return base


def _controllers(**kw):
    return (jschedule.DasoController(jdaso.DasoConfig(**_kw(**kw)), loss_window=50),
            schedule.DasoController(daso.DasoConfig(**_kw(**kw)), loss_window=50))


def _json(sd):
    return json.loads(json.dumps(sd))


def test_split_ov_tokens():
    """tests/test_overlap.py:155."""
    for tok in ("ov_sync~2", "ov_sync", "local", "ov_start", "send~0"):
        assert schedule.split_ov(tok) == jschedule.split_ov(tok)
    assert schedule.split_ov("ov_sync~2") == (schedule.Mode.OV_SYNC, 2)
    for tok in ("ov_sync~1+host", "ov_start", "send+host", "local", "blocking"):
        assert schedule.is_ov_mode(tok) == jschedule.is_ov_mode(tok)
    assert schedule.is_ov_mode("ov_sync~1+host") and not schedule.is_ov_mode("send+host")


def test_overlap_schedule_tokens():
    """tests/test_overlap.py:155: warm-up blocking, ov_start, B - 1 locals,
    ov_sync~E with E = age - min(W, age); cool-down resets the snapshot."""
    jc, tc = _controllers()
    modes = [tc.mode_for_step(s) for s in range(16)]
    assert modes == [jc.mode_for_step(s) for s in range(16)]
    assert [m for m, _ in modes[:3]] == ["blocking"] * 3
    assert modes[3] == ("ov_start", 1)
    assert [m for m, _ in modes[4:7]] == ["local"] * 3
    assert modes[7] == modes[11] == ("ov_sync~3", 1)
    assert [m for m, _ in modes[14:]] == ["blocking"] * 2
    assert tc._ov_last is None
    assert _json(tc.state_dict()) == _json(jc.state_dict())


@pytest.mark.parametrize("b_max", [1, 2, 4, 8])
def test_overlap_schedule_matches_jax_with_plateaus(b_max):
    """Halve / reset through plateaus under overlap: the same loss trace
    gives the same tokens and state dicts."""
    kw = dict(n_replicas=4, global_world=16, b_max=b_max, warmup_steps=3,
              cooldown_steps=4, total_steps=120, plateau_patience=2, overlap="one_cycle")
    jc = jschedule.DasoController(jdaso.DasoConfig(**kw), loss_window=5)
    tc = schedule.DasoController(daso.DasoConfig(**kw), loss_window=5)
    for t in range(120):
        assert tc.mode_for_step(t) == jc.mode_for_step(t)
        loss = 5.0 - 0.1 * min(t, 30) + 0.001 * (t % 3)
        jc.observe_loss(loss)
        tc.observe_loss(loss)
        assert _json(tc.state_dict()) == _json(jc.state_dict())
    assert tc.global_sync_fraction() == jc.global_sync_fraction()


def test_overlap_plan_cycle_cuts_after_ov_step():
    """tests/test_overlap.py:171."""
    jc, tc = _controllers()
    for start, want in ((0, ["blocking"] * 3), (3, ["ov_start"]),
                        (4, ["local"] * 3 + ["ov_sync~3"]),
                        (8, ["local"] * 3 + ["ov_sync~3"])):
        shape = tc.plan_cycle(start)
        assert shape == jc.plan_cycle(start)
        assert [m for m, _ in shape] == want


def test_overlap_controller_state_roundtrip():
    """tests/test_overlap.py:179."""
    jc, tc = _controllers(total_steps=40, cooldown_steps=0)
    for s in range(9):
        assert tc.mode_for_step(s) == jc.mode_for_step(s)
    sd = tc.state_dict()
    assert sd["_ov_last"] == 7 and _json(sd) == _json(jc.state_dict())
    b = _controllers(total_steps=40, cooldown_steps=0)[1]
    b.load_state_dict(_json(sd))
    for s in range(9, 20):
        assert tc.mode_for_step(s) == b.mode_for_step(s)


def test_pre_overlap_state_dict_loads():
    """tests/test_overlap.py:193: a state dict without `_ov_last` keeps the
    default, so the next cycling step re-snapshots."""
    jc, tc = _controllers()
    for s in range(6):
        tc.mode_for_step(s)
        jc.mode_for_step(s)
    sd, jsd = tc.state_dict(), jc.state_dict()
    del sd["_ov_last"], jsd["_ov_last"]
    b, jb = _controllers()[1], _controllers()[0]
    b.load_state_dict(sd)
    jb.load_state_dict(jsd)
    assert b._ov_last is None
    assert b.mode_for_step(6) == jb.mode_for_step(6) == ("ov_start", 1)


def test_overlap_sync_fraction_counts_ov_sync():
    """tests/test_overlap.py:208: 3 warm-up + 2 ov_sync + 2 cool-down."""
    jc, tc = _controllers()
    for s in range(16):
        tc.mode_for_step(s)
        jc.mode_for_step(s)
    assert tc.global_sync_fraction() == pytest.approx(7 / 16)
    assert tc.global_sync_fraction() == jc.global_sync_fraction()


# -- executor -------------------------------------------------------------------------

def _problem_cfgs():
    return (jax_get_reduced("llama3.2-1b").replace(**TINY),
            get_reduced("llama3.2-1b").replace(**TINY))


@pytest.fixture(scope="module")
def problem():
    """A JAX 4-slot carry (params_R, opt_R, inflight, pending) whose replicas
    and buffers all differ, and one replicated batch."""
    jcfg, tcfg = _problem_cfgs()
    p0 = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def spread(scale):
        return jax.tree.map(lambda a: (a[None] + scale * rng.standard_normal(
            (R,) + a.shape)).astype(np.float32), p0)

    params, inflight, pending = spread(0.01), spread(0.02), spread(0.03)
    opt = {"mu": jax.tree.map(lambda a: (0.1 * rng.standard_normal(a.shape))
                              .astype(np.float32), params)}
    src = SyntheticLM(vocab_size=tcfg.vocab_size, seq_len=SEQ, seed=1)
    flat = src.batch(R * PER, step=3)
    batch = {k: v.reshape((R, PER, SEQ)).numpy() for k, v in flat.items()}
    return dict(jcfg=jcfg, tcfg=tcfg, carry=(params, opt, inflight, pending), batch=batch)


def _port(tree):
    return state_from_jax(tree, "cpu")


def _assert_tree_close(got, want_np):
    g, w = leaves(got), leaves(_port(want_np))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=STEP_ATOL, rtol=0)


def test_overlap_carry_is_four_slot():
    """tests/test_overlap.py:226."""
    _, tcfg = _problem_cfgs()
    p0 = {"w": torch.ones(3, 2)}
    loss = make_lm_loss(tcfg)
    ov = executor.make_strategy("daso", loss, sgd(0.9), daso.DasoConfig(**_kw()))
    off = executor.make_strategy("daso", loss, sgd(0.9), daso.DasoConfig(**_kw("off")))
    assert ov.overlap and not off.overlap
    assert len(ov.init_carry(p0)) == 4 and len(off.init_carry(p0)) == 3
    assert ov.init_carry(p0)[3]["w"].shape == (2, 3, 2)


def test_sync_strategy_rejects_overlap():
    """tests/test_overlap.py:393."""
    _, tcfg = _problem_cfgs()
    with pytest.raises(ValueError, match="sync"):
        run_training(make_lm_loss(tcfg), {"w": torch.ones(8, 1)}, None,
                     TrainLoopConfig(strategy="sync", n_steps=4, overlap="one_cycle",
                                     device="cpu"), log=None)


OV_CASES = [("local", 0), ("ov_start", 0), ("ov_sync", 0), ("ov_sync", 2), ("blocking", 0)]


@pytest.mark.parametrize("wire", [None, "bf16"])
@pytest.mark.parametrize("mode,extra", OV_CASES)
def test_overlap_step_of_each_mode_matches_jax(problem, mode, extra, wire):
    """On the LM, at the default tiers (f32 cycling, bf16 blocking) and bf16
    throughout. (The int8 tier on the LM: see
    test_int8_lm_exchange_follows_the_port_leaf_order.)"""
    jcfg, tcfg = problem["jcfg"], problem["tcfg"]
    carry, batch = problem["carry"], problem["batch"]
    kw = dict(n_replicas=R, global_world=R * 4, b_max=4, overlap="one_cycle",
              wire_format=wire)
    jstep = jax.jit(jdaso.daso_overlap_step(jax_make_lm_loss(jcfg), jax_sgd(0.9, 1e-4),
                                            jdaso.DasoConfig(**kw), mode=mode, staleness=1,
                                            extra_staleness=extra))
    jout = jstep(*(jax.tree.map(jnp.asarray, t) for t in carry),
                 jax.tree.map(jnp.asarray, batch), jnp.float32(0.05))
    tstep = daso.daso_overlap_step(make_lm_loss(tcfg), sgd(0.9, 1e-4),
                                   daso.DasoConfig(**kw), mode=mode, staleness=1,
                                   extra_staleness=extra)
    tout = tstep(*(_port(t) for t in carry),
                 {k: torch.from_numpy(v) for k, v in batch.items()}, 0.05)
    for got, want in zip(tout[:4], jout[:4]):
        _assert_tree_close(got, jax.tree.map(np.asarray, want))
    assert sorted(tout[4]) == sorted(jout[4])
    for k in jout[4]:
        np.testing.assert_allclose(tout[4][k].numpy(), np.asarray(jout[4][k]),
                                   atol=STEP_ATOL, rtol=0)


# -- the int8 tier on a model whose leaves both packages order alike -------------------

D_IN, D_H = 8, 16


@pytest.fixture(scope="module")
def mlp():
    """tests/conftest.py's MLP problem, made with numpy: params {"w1", "w2"}
    flatten (and so pack) in the same order in both packages, so the int8
    tier's blocks group the same elements. A 4-slot carry whose replicas
    and buffers differ, and one replicated batch."""
    rng = np.random.default_rng(3)

    def spread(scale):
        return {"w1": (0.3 * rng.standard_normal((R, D_IN, D_H)) * (1 + scale)).astype(np.float32),
                "w2": (0.3 * rng.standard_normal((R, D_H, 1)) + scale).astype(np.float32)}

    params, inflight, pending = spread(0.0), spread(0.02), spread(0.05)
    opt = {"mu": {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
                  for k, v in params.items()}}
    x = rng.standard_normal((R, 16, D_IN)).astype(np.float32)
    w = rng.standard_normal((D_IN, D_H)).astype(np.float32) * 0.5
    y = (np.tanh(x @ w).sum(-1, keepdims=True) * 0.3).astype(np.float32)
    return dict(carry=(params, opt, inflight, pending), batch={"x": x, "y": y})


def _jax_mlp_loss(params, batch):
    pred = jnp.tanh(batch["x"] @ params["w1"]) @ params["w2"]
    return jnp.mean((pred - batch["y"]) ** 2), {}


def _mlp_loss(params, batch):
    pred = torch.tanh(batch["x"] @ params["w1"]) @ params["w2"]
    return torch.mean((pred - batch["y"]) ** 2), {}


def _tensors(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want):
    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=STEP_ATOL, rtol=0)


@pytest.mark.parametrize("mode,extra", OV_CASES)
def test_int8_overlap_step_of_each_mode_matches_jax(mlp, mode, extra):
    carry, batch = mlp["carry"], mlp["batch"]
    kw = dict(n_replicas=R, global_world=R * 4, b_max=4, overlap="one_cycle",
              wire_format="int8", int8_block=64)
    jout = jax.jit(jdaso.daso_overlap_step(
        _jax_mlp_loss, jax_sgd(0.9, 1e-4), jdaso.DasoConfig(**kw), mode=mode,
        staleness=1, extra_staleness=extra))(
        *(jax.tree.map(jnp.asarray, t) for t in carry),
        jax.tree.map(jnp.asarray, batch), jnp.float32(0.05))
    tout = daso.daso_overlap_step(_mlp_loss, sgd(0.9, 1e-4), daso.DasoConfig(**kw),
                                  mode=mode, staleness=1, extra_staleness=extra)(
        *(_tensors(t) for t in carry), _tensors(batch), 0.05)
    for got, want in zip(tout, jout):
        _close(got, want)


@pytest.mark.parametrize("mode", ["send", "blocking", "send_receive"])
def test_int8_send_and_blocking_steps_match_jax(mlp, mode):
    params, opt, inflight, _ = mlp["carry"]
    kw = dict(n_replicas=R, global_world=R * 4, b_max=4, wire_format="int8")
    jout = jax.jit(jdaso.daso_train_step(_jax_mlp_loss, jax_sgd(0.9, 1e-4),
                                         jdaso.DasoConfig(**kw), mode=mode, staleness=2))(
        *(jax.tree.map(jnp.asarray, t) for t in (params, opt, inflight)),
        jax.tree.map(jnp.asarray, mlp["batch"]), jnp.float32(0.05))
    tout = daso.daso_train_step(_mlp_loss, sgd(0.9, 1e-4), daso.DasoConfig(**kw),
                                mode=mode, staleness=2)(
        *(_tensors(t) for t in (params, opt, inflight)), _tensors(mlp["batch"]), 0.05)
    for got, want in zip(tout, jout):
        _close(got, want)


def test_int8_lm_exchange_is_bit_exact_with_the_reference_stacked_tree(problem):
    """The int8 blocks run over the packed arena in leaf order, and span
    leaves. The port's LM keeps the reference's stacked tree ("blocks":
    [{leaf: (n_full, ...)}], "rem"), so both arenas list the same elements
    in the same order, the 256-element blocks group the same elements, and
    the port's int8 replica mean is bit-exact with the reference's on the
    reference's own tree."""
    params = problem["carry"][0]
    got = daso.replica_mean(_port(params), wire_format="int8")
    want = jdaso.replica_mean(jax.tree.map(jnp.asarray, params), wire_format="int8")
    for a, b in zip(leaves(got), jax.tree.leaves(want), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_overlap_step_refusals():
    cfg = daso.DasoConfig(n_replicas=4, global_world=16, overlap="one_cycle")
    with pytest.raises(ValueError, match="overlap mode"):
        daso.daso_overlap_step(None, sgd(), cfg, mode="send")
    with pytest.raises(ValueError, match="outside 2..4"):
        daso.daso_overlap_step(None, sgd(), cfg, mode="local", inner_syncs=(("host", 8),))


# -- the slice end to end --------------------------------------------------------------

QUICK = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
             vocab_size=256)
# loss traces of 60 steps: the two frameworks sum in different orders inside
# the model (~1e-7 relative per step in f32) and SGD carries the difference
# forward (tests/test_torch_train.py)
RTOL = 1e-4
QR, QPER, QSEQ, QSTEPS = 4, 4, 32, 60


@pytest.fixture(scope="module")
def int8_overlap_runs():
    jcfg = jax_get_reduced("llama3.2-1b").replace(**QUICK)
    tcfg = get_reduced("llama3.2-1b").replace(**QUICK)
    params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    jsrc = JaxSyntheticLM(vocab_size=256, seq_len=QSEQ, seed=0)
    tsrc = SyntheticLM(vocab_size=256, seq_len=QSEQ, seed=0)

    def jdata(step):
        b = jsrc.batch(QR * QPER, step)
        return {k: v.reshape((QR, QPER) + v.shape[1:]) for k, v in b.items()}

    def tdata(step):
        b = tsrc.batch(QR * QPER, step)
        return {k: v.reshape((QR, QPER) + v.shape[1:]) for k, v in b.items()}

    kw = dict(strategy="daso", n_steps=QSTEPS, n_replicas=QR, local_world=4, b_max=4,
              lr=0.05, wire_format="int8", overlap="one_cycle")
    jres = jax_run_training(jax_make_lm_loss(jcfg), jax.tree.map(jnp.asarray, params),
                            jdata, JaxTrainLoopConfig(executor="per_step", **kw), log=None)
    tres = run_training(make_lm_loss(tcfg), params_from_jax(params), tdata,
                        TrainLoopConfig(device="cpu", **kw), log=None)
    return jres, tres


def test_int8_overlap_schedule_identical_to_jax(int8_overlap_runs):
    jres, tres = int8_overlap_runs
    assert [h[1:] for h in tres.controller.history] == \
        [h[1:] for h in jres.controller.history]
    assert tres.sync_fraction == jres.sync_fraction
    modes = {h[1] for h in tres.controller.history}
    assert modes == {"blocking", "ov_start", "ov_sync~3", "local"}
    assert len(tres.carry) == 4


def test_int8_overlap_loss_trace_matches_jax(int8_overlap_runs):
    jres, tres = int8_overlap_runs
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=RTOL)
    assert tres.losses[-1] < tres.losses[0]


def test_int8_wire_training_converges():
    """tests/test_executor.py:121: the int8 tier trains (finite losses) and
    ends within quantization distance of the f32-wire run."""
    tcfg = get_reduced("llama3.2-1b").replace(**QUICK)
    jcfg = jax_get_reduced("llama3.2-1b").replace(**QUICK)
    params = params_from_jax(jax.tree.map(
        np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(8))))
    src = SyntheticLM(vocab_size=256, seq_len=QSEQ, seed=8)

    def data(step):
        b = src.batch(2 * QPER, step)
        return {k: v.reshape((2, QPER) + v.shape[1:]) for k, v in b.items()}

    def run(wire):
        return run_training(make_lm_loss(tcfg), params, data, TrainLoopConfig(
            n_steps=24, n_replicas=2, local_world=4, b_max=4, lr=0.1, wire_format=wire,
            warmup_frac=4 / 24, cooldown_frac=4 / 24, loss_window=10 ** 9, device="cpu"),
            log=None)

    i8, f32 = run("int8"), run("f32")
    assert np.all(np.isfinite(i8.losses))
    assert i8.final_loss < i8.losses[0]  # it trains
    gap = max(float((a - b).abs().max()) for a, b in zip(leaves(i8.params),
                                                         leaves(f32.params)))
    assert gap < 0.05  # small quantization drift, not divergence


def test_launcher_runs_int8_overlap(tmp_path, capsys):
    """The launcher's default macro executor runs each ov_sync cycle as an
    overlap cycle: the exchange, the local steps, the merge."""
    out = tmp_path / "m.json"
    res = launch_train.main(["--tiny", "--device", "cpu", "--steps", "12", "--nodes", "2",
                             "--per-node-batch", "2", "--seq-len", "16", "--wire-format",
                             "int8", "--overlap", "one_cycle", "--metrics-out", str(out)])
    text = capsys.readouterr().out
    assert "wire(cycling/blocking)=int8/int8" in text and "overlap=one_cycle" in text
    m = json.loads(out.read_text())
    assert m["sync_fraction"] == res.sync_fraction
    n_sync = sum(h[1].startswith("ov_sync") for h in res.controller.history)
    assert n_sync > 0
    assert m["executor_stats"]["overlap_cycles"] == n_sync
    assert "[train] executor:" in text


def test_overlap_config_field_matches_jax_default():
    assert [f.name for f in dataclasses.fields(daso.DasoConfig)] == \
        [f.name for f in dataclasses.fields(jdaso.DasoConfig)]
    assert daso.OV_MODES == jdaso.OV_MODES
    assert jexecutor.DasoStrategy.overlap.__doc__ and executor.DasoStrategy.overlap.__doc__
