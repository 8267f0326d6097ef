"""The port's resilience plane (`repro_torch.resilience`, the membership masks
of core/flatbuf.py and core/daso.py, the controller's fault hooks), the twin
of tests/test_resilience.py, held against the JAX package on the CPU:

  * the masked fused mean against the survivor oracle (f32, bf16) and bit
    for bit the reference's (f32, bf16, int8), the masked int8 mean within
    quantization distance of the f32 one;
  * Eq. (1) at the surviving world's fractional P_eff, bit for bit the
    reference's, with the dropped rows frozen;
  * every step variant (and the overlap step builders) freezing a dropped
    replica's params and momentum bit for bit, the loss over the active
    replicas; `freeze_inactive` bit for bit the reference's, the identity
    without a mask;
  * `reseed_carry` / `donor_mean_rows` bit for bit the reference's (f32,
    bf16 and int32 leaves), the carry's aliasing kept;
    `normalize_membership`'s validation as the reference's;
  * the controller's membership flush and DCN stretch: the same state,
    events and trace instants as the reference's on the same floats;
  * `FaultPlan`: JSON written by either package read by the other, the same
    queries, validation messages and node resolution;
  * the supervisor end to end against the reference's on the same plan:
    membership timeline, applied events, invalidations, the instants of
    both traces (the executor's `invalidate` with its `dropped` count, the
    controller's `membership_change` / `dcn_scale`), simulated clock,
    wasted wait, losses; one `fault_event` span per event, every event
    valid;
  * `finalize_params` skipping dead rows; the supervisor without faults
    bit for bit the plain executor; a faulted run resumed from its
    mid-crash TrainState bit for bit the uninterrupted one; the resume of
    tests/test_resilience.py on both executors; the unported options'
    refusals (items 16, 18).

The legs that need HLO (the one-collective contract under a mask) are
ROADMAP item 21. Inputs are made from a seed with numpy."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import daso as jdaso
from repro.core import executor as jexecutor
from repro.core import flatbuf as jflatbuf
from repro.core import schedule as jschedule
from repro.optim import optimizers as jopt
from repro.optim.schedules import constant_lr as jax_constant_lr
from repro.resilience import faults as jfaults
from repro.resilience import membership as jmembership
from repro.obs import trace as jtrace
from repro.resilience.supervisor import run_with_faults as jax_run_with_faults
from repro.topo import TopologySpec as JaxTopologySpec
from repro_torch.checkpoint import io
from repro_torch.core import daso, executor, flatbuf, schedule
from repro_torch.obs.trace import Tracer, load_events, validate_event
from repro_torch.optim.optimizers import sgd
from repro_torch.optim.schedules import constant_lr
from repro_torch.resilience import FaultEvent, FaultPlan, membership, run_with_faults
from repro_torch.topo import TopologySpec
from repro_torch.train.loop import TrainLoopConfig, run_training
from repro_torch.tree import leaves

D, H, PER = 8, 16, 8
MASKS = [(1.0, 1.0, 0.0, 1.0), (0.0, 1.0, 0.0, 1.0), (1.0, 0.0, 0.0, 0.0)]


def _tree(seed, R=4):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((R, 5, 3)).astype(np.float32),
            "nested": {"b": rng.standard_normal((R, 7)).astype(np.float32),
                       "s": rng.standard_normal((R, 1)).astype(np.float32)}}


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _same(got, want):
    """Bit for bit, leaf by leaf (bf16 leaves compared as bf16)."""
    g, w = leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b)
        if a.dtype == torch.bfloat16:
            a = a.float().numpy()
            b = b.astype(np.float32)
        else:
            a = a.contiguous().numpy()
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint32) if a.dtype == np.float32 else a,
                                      b.view(np.uint32) if b.dtype == np.float32 else b)


# -- the masked exchange ----------------------------------------------------------

@pytest.mark.parametrize("wire_format", ["f32", "bf16"])
@pytest.mark.parametrize("mask", MASKS)
def test_masked_fused_mean_matches_survivor_oracle(wire_format, mask):
    """The membership-weighted fused mean equals the mean over the
    surviving rows only, on every row, and the reference's bit for bit."""
    tree = _tree(0)
    got = daso.replica_mean(_t(tree), wire_format=wire_format, mask=mask)
    _same(got, jdaso.replica_mean(_j(tree), wire_format=wire_format, mask=mask))
    alive = [i for i, m in enumerate(mask) if m]
    wd = torch.bfloat16 if wire_format == "bf16" else torch.float32
    tol = dict(rtol=1e-7, atol=1e-7) if wire_format == "f32" else dict(rtol=1e-2, atol=1e-2)
    for x, g in zip(leaves(_t(tree)), leaves(got)):
        sub = x[alive].to(wd).float()
        want = (sub.sum(0) / len(alive)).expand(x.shape)
        np.testing.assert_allclose(g.numpy(), want.numpy(), **tol)


@pytest.mark.parametrize("mask", MASKS)
def test_masked_int8_mean_is_the_reference_and_close_to_the_f32_one(mask):
    tree = _tree(2)
    got = daso.replica_mean(_t(tree), wire_format="int8", mask=mask)
    _same(got, jdaso.replica_mean(_j(tree), wire_format="int8", mask=mask))
    f32 = daso.replica_mean(_t(tree), wire_format="f32", mask=mask)
    for a, b in zip(leaves(got), leaves(f32)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=0.05)


def test_masked_mean_without_a_mask_is_unchanged():
    """mask=None and the all-active mask give the unmasked numbers."""
    tree = _t(_tree(3))
    for wf in ("f32", "bf16", "int8"):
        a = daso.replica_mean(tree, wire_format=wf)
        b = daso.replica_mean(tree, wire_format=wf, mask=flatbuf.normalize_membership(
            (1, 1, 1, 1), 4))
        for x, y in zip(leaves(a), leaves(b)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("p_eff", [16 * 3 / 4, 4 * 2 / 3, 40 / 3])
def test_dynamic_p_receive_matches_the_reference(p_eff):
    """Eq. (1) at a fractional P_eff, bit for bit the reference's, the
    dropped row frozen, and within 1e-6 of the closed form."""
    params = _tree(3)
    inflight = jax.tree.map(lambda x: x * 0.5, params)
    mask = (1.0, 0.0, 1.0, 1.0)
    got = daso.global_receive(_t(params), _t(inflight), staleness=2, global_world=p_eff,
                              mask=mask)
    _same(got, jdaso.global_receive(_j(params), _j(inflight), staleness=2,
                                    global_world=p_eff, mask=mask))
    for g, x, s in zip(leaves(got), jax.tree.leaves(params), jax.tree.leaves(inflight)):
        want = (4.0 * x + p_eff * s) / (4.0 + p_eff)
        want[1] = x[1]
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(g[1].numpy(), x[1])


def test_freeze_inactive_matches_the_reference():
    new, old = _tree(4), _tree(5)
    assert daso.freeze_inactive(_t(new), _t(old), None) is not None
    t_new = _t(new)
    assert daso.freeze_inactive(t_new, _t(old), None) is t_new
    for mask in MASKS:
        _same(daso.freeze_inactive(_t(new), _t(old), mask),
              jdaso.freeze_inactive(_j(new), _j(old), mask))


def test_masked_level_group_mean_in_the_step_builders():
    """An inner sync of a masked step (`inner_syncs`) is the reference's,
    bit for bit, and keeps the dropped row."""
    tree = _tree(6)
    for mask in MASKS:
        for perm in (None, (2, 0, 3, 1)):
            got = daso.level_group_mean(_t(tree), 2, mask=mask, perm=perm)
            _same(got, jdaso.level_group_mean(_j(tree), 2, mask=mask, perm=perm))


# -- frozen ghosts ------------------------------------------------------------------

def _mlp(seed, R):
    rng = np.random.default_rng(seed)
    params0 = {"w1": (0.3 * rng.standard_normal((D, H))).astype(np.float32),
               "w2": (0.3 * rng.standard_normal((H, 1))).astype(np.float32)}
    wtrue = (0.5 * rng.standard_normal((D, H))).astype(np.float32)

    def batch(step):
        x = np.random.default_rng((seed, step)).standard_normal((R, PER, D)).astype(
            np.float32)
        return {"x": x, "y": (np.tanh(x @ wtrue).sum(-1, keepdims=True) * 0.3).astype(
            np.float32)}

    return params0, batch


def _jax_loss(params, b):
    return jnp.mean((jnp.tanh(b["x"] @ params["w1"]) @ params["w2"] - b["y"]) ** 2), {}


def _loss(params, b):
    return torch.mean((torch.tanh(b["x"] @ params["w1"]) @ params["w2"] - b["y"]) ** 2), {}


def _rows(params0, R, seed):
    rng = np.random.default_rng(seed)
    return {k: (v[None] + 0.05 * rng.standard_normal((R,) + v.shape)).astype(np.float32)
            for k, v in params0.items()}


@pytest.mark.parametrize("mode", ["local", "send", "receive", "blocking", "hard_avg"])
def test_elastic_step_freezes_dead_rows(mode):
    """A dropped replica's params and momentum rows leave every step variant
    bit for bit as they came; the active rows train; the loss averages the
    active replicas; the carry is the reference's within rtol 2e-5."""
    params0, batch = _mlp(4, 4)
    cfg = daso.DasoConfig(n_replicas=4, global_world=16, b_max=4)
    jcfg = jdaso.DasoConfig(n_replicas=4, global_world=16, b_max=4)
    mask = (1.0, 1.0, 0.0, 1.0)
    params, inflight = _rows(params0, 4, 1), _rows(params0, 4, 2)
    opt = {"mu": _rows({k: 0 * v for k, v in params0.items()}, 4, 3)}
    step = daso.daso_train_step(_loss, sgd(momentum=0.9), cfg, mode=mode, staleness=1,
                                membership=mask)
    p2, o2, _, m = step(_t(params), _t(opt), _t(inflight), _t(batch(0)), 0.1)
    for a, b in zip(leaves(p2), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a[2].numpy(), b[2])
        assert not np.allclose(a[0].numpy(), b[0])
    for a, b in zip(leaves(o2), jax.tree.leaves(opt)):
        np.testing.assert_array_equal(a[2].numpy(), b[2])
    lr_ = m["loss_per_replica"]
    torch.testing.assert_close(m["loss"], (lr_[0] + lr_[1] + lr_[3]) / 3, rtol=1e-6, atol=0)
    jstep = jdaso.daso_train_step(_jax_loss, jopt.sgd(momentum=0.9), jcfg, mode=mode,
                                  staleness=1, membership=mask)
    jp, jo, _, jm = jstep(_j(params), _j(opt), _j(inflight), _j(batch(0)), 0.1)
    for a, b in zip(leaves((p2, o2)), jax.tree.leaves((jp, jo))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-6)


@pytest.mark.parametrize("mode", ["ov_start", "ov_sync~1", "blocking"])
def test_overlap_steps_take_the_membership(mode):
    """`daso_overlap_step` and `daso_overlap_compute_step` under a mask: the
    reference's carry within rtol 2e-5, the dropped rows frozen."""
    params0, batch = _mlp(5, 4)
    mask = (0.0, 1.0, 1.0, 1.0)
    base, extra = schedule.split_ov(mode)
    params, pending = _rows(params0, 4, 1), _rows(params0, 4, 2)
    opt = {"mu": _rows({k: 0 * v for k, v in params0.items()}, 4, 3)}
    outs = []
    for pkg in ("port", "jax"):
        dm, lo, opt_fn, conv = ((daso, _loss, sgd, _t) if pkg == "port"
                                else (jdaso, _jax_loss, jopt.sgd, _j))
        cfg = dm.DasoConfig(n_replicas=4, global_world=16, b_max=4, overlap="one_cycle")
        step = dm.daso_overlap_step(lo, opt_fn(momentum=0.9), cfg, mode=base, staleness=1,
                                    extra_staleness=extra, membership=mask)
        outs.append(step(conv(params), conv(opt), conv(pending), conv(pending),
                         conv(batch(0)), 0.1))
        comp = dm.daso_overlap_compute_step(lo, opt_fn(momentum=0.9), cfg, membership=mask)
        outs.append(comp(conv(params), conv(opt), conv(batch(0)), 0.1))
    for got, want in ((outs[0], outs[2]), (outs[1], outs[3])):
        n = len(got) - 1
        for a, b in zip(leaves(got[:n]), jax.tree.leaves(want[:n]), strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=1e-6)
        for a, b in zip(leaves(got[0]), jax.tree.leaves(params)):
            np.testing.assert_array_equal(a[0].numpy(), b[0])


# -- reseeding -----------------------------------------------------------------------

def test_reseed_carry_matches_the_reference():
    """The joiner's rows become the donors' mean in every leaf (f32, bf16,
    int32), bit for bit the reference's; the other rows are untouched; an
    aliased leaf stays one tensor."""
    rng = np.random.default_rng(5)
    params = _tree(5)
    extra = {"h": rng.standard_normal((4, 9)).astype(jnp.bfloat16),
             "n": rng.integers(-50, 50, (4, 3)).astype(np.int32)}
    donor_mask = (1.0, 1.0, 0.0, 1.0)
    jcarry = (_j(params), _j(extra), _j(params))
    tp = _t(params)
    tcarry = (tp, {"h": torch.from_numpy(extra["h"].view(np.int16)).view(torch.bfloat16),
                   "n": torch.from_numpy(extra["n"])}, tp)
    got = membership.reseed_carry(tcarry, donor_mask, [2])
    _same(got, jmembership.reseed_carry(jcarry, donor_mask, [2]))
    _same(membership.donor_mean_rows(tcarry, donor_mask),
          jmembership.donor_mean_rows(jcarry, donor_mask))
    for a, b in zip(leaves(got[0]), leaves(got[2])):
        assert a is b
    for x, y in zip(leaves(tcarry), leaves(got)):
        assert torch.equal(x[[0, 1, 3]], y[[0, 1, 3]])
    assert membership.reseed_carry(tcarry, donor_mask, []) is tcarry
    with pytest.raises(ValueError, match="donor and joiner"):
        membership.reseed_carry(tcarry, (1.0,) * 4, [2])
    with pytest.raises(ValueError, match="outside"):
        membership.reseed_carry(tcarry, donor_mask, [7])


def test_normalize_membership_validation():
    for fn in (flatbuf.normalize_membership, jflatbuf.normalize_membership):
        assert fn(None, 4) is None
        assert fn((1, 1, 1, 1), 4) is None
        assert fn([1, 0, 1, 1], 4) == (1.0, 0.0, 1.0, 1.0)
        with pytest.raises(ValueError, match="entries"):
            fn((1.0, 0.0), 4)
        with pytest.raises(ValueError, match="no active"):
            fn((0.0,) * 4, 4)
        with pytest.raises(ValueError, match="0/1"):
            fn((0.5, 1.0), 2)


# -- the controller's hooks ---------------------------------------------------------

def _controllers(loss_window=5):
    return (schedule.DasoController(daso.DasoConfig(n_replicas=4, global_world=16, b_max=4),
                                    loss_window=loss_window),
            jschedule.DasoController(jdaso.DasoConfig(n_replicas=4, global_world=16,
                                                      b_max=4), loss_window=loss_window))


def test_controller_membership_change_flushes_plateau_stats(tmp_path):
    """The window is dropped and the baseline restarts; a post-fault loss
    bump does not count toward the patience; the port's state_dict, events
    and trace instant are the reference's."""
    tc, jc = _controllers()
    tc.tracer = Tracer(str(tmp_path / "t.jsonl"))
    for c in (tc, jc):
        for _ in range(3):
            c.observe_loss(1.0)
        assert c.window_remaining() == 2
        c.notify_membership_change(3, 3)
        assert c.window_remaining() == 5
        assert c.events == [(3, "membership", 3.0)]
        b0 = c.b
        for _ in range(5):
            c.observe_loss(10.0)
        assert c.b == b0
    assert tc.state_dict() == jc.state_dict()
    tc.tracer.close()
    (ev,) = [e for e in load_events(str(tmp_path / "t.jsonl")) if e["ph"] == "i"]
    validate_event(ev)
    assert (ev["name"], ev["args"]) == ("membership_change", {
        "reason": "plateau_stats_flushed", "step": 3, "n_active": 3})


def test_controller_dcn_scale_stretches_b():
    tc, jc = _controllers()
    for c in (tc, jc):
        c.notify_dcn_scale(0.25, step=7)
        assert c.b == 16 and c.w == 4       # b_max / scale, W = B / 4
        c.notify_dcn_scale(0.001, step=8)
        assert c.b == 16                    # capped at 4 b_max
        c.notify_dcn_scale(1.0, step=9)
        assert c.b == 4 and c.w == 1        # back to b_max
        c.notify_dcn_scale(0.5, step=10)
        assert c.b == 8 and c.w == 2
        with pytest.raises(ValueError):
            c.notify_dcn_scale(0.0)
    assert tc.state_dict() == jc.state_dict()
    assert tc.events == jc.events


# -- the fault-plan DSL --------------------------------------------------------------

EVENTS = [{"step": 20, "kind": "rejoin", "replica": 1},
          {"step": 5, "kind": "crash", "replica": 1},
          {"step": 8, "kind": "straggle", "replica": 0, "factor": 3.0},
          {"step": 10, "kind": "degrade_dcn", "factor": 0.5},
          {"step": 15, "kind": "restore_dcn"},
          {"step": 12, "kind": "recover", "replica": 0}]


def test_fault_plan_json_reads_across_packages(tmp_path):
    """A plan written by either package reads the same in the other, with
    the same queries."""
    tp, jp = FaultPlan.from_dicts(EVENTS), jfaults.FaultPlan.from_dicts(EVENTS)
    assert tp.to_json() == jp.to_json()
    path = tmp_path / "plan.json"
    path.write_text(tp.to_json())
    assert jfaults.FaultPlan.from_json(str(path)) == jp
    assert FaultPlan.from_json(jp.to_json()) == tp
    tp.validate(4)
    assert [e.step for e in tp.events] == [5, 8, 10, 12, 15, 20]
    assert tp.boundaries() == jp.boundaries()
    for step in range(0, 24):
        assert tp.membership_at(step, 4) == jp.membership_at(step, 4)
        assert tp.dcn_scale_at(step) == jp.dcn_scale_at(step)
        assert tp.slowdowns_at(step, 4) == jp.slowdowns_at(step, 4)
        assert tp.next_boundary_after(step) == jp.next_boundary_after(step)
    assert json.loads(tp.to_json())["events"][0] == {"step": 5, "kind": "crash",
                                                     "replica": 1, "factor": 1.0}


def test_fault_plan_validation_rejects_incoherent_scripts():
    cases = [([{"step": 1, "kind": "crash", "replica": 0},
               {"step": 2, "kind": "crash", "replica": 0}], "already down"),
             ([{"step": 1, "kind": "rejoin", "replica": 0}], "already active"),
             ([{"step": 1, "kind": "crash", "replica": 0},
               {"step": 2, "kind": "crash", "replica": 1}], "no active"),
             ([{"step": 1, "kind": "crash", "replica": 9}], "outside"),
             ([{"step": 1, "kind": "crash", "node": "pod0"}], "resolve")]
    for events, match in cases:
        msgs = []
        for mod in (FaultPlan, jfaults.FaultPlan):
            with pytest.raises(ValueError, match=match) as ei:
                mod.from_dicts(events).validate(2)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultEvent(step=1, kind="meteor")
    with pytest.raises(ValueError, match="bandwidth fraction"):
        FaultEvent(step=1, kind="degrade_dcn", factor=2.0)
    with pytest.raises(ValueError, match="exactly one"):
        FaultEvent(step=1, kind="crash")


def test_fault_plan_resolves_topology_nodes_as_the_reference():
    text = "chip:1 x host:2 x pod:2"
    events = [{"step": 3, "kind": "crash", "node": "pod1"},
              {"step": 6, "kind": "rejoin", "node": "pod1/host0"},
              {"step": 7, "kind": "straggle", "node": "pod0", "factor": 2.0}]
    got = FaultPlan.from_dicts(events).resolve(TopologySpec.load(text))
    want = jfaults.FaultPlan.from_dicts(events).resolve(JaxTopologySpec.load(text))
    assert got.to_json() == want.to_json()
    got.validate(4)


# -- the supervisor ------------------------------------------------------------------

SUPERVISED = [{"step": 10, "kind": "crash", "replica": 3},
              {"step": 12, "kind": "straggle", "replica": 1, "factor": 1.5},
              {"step": 14, "kind": "degrade_dcn", "factor": 0.25},
              {"step": 22, "kind": "restore_dcn"},
              {"step": 24, "kind": "recover", "replica": 1},
              {"step": 26, "kind": "rejoin", "replica": 3}]


def _strategy(pkg, n_steps, R=4, loss_window=10, name="daso"):
    dm, ex, sc, lo, opt = ((daso, executor, schedule, _loss, sgd) if pkg == "port"
                           else (jdaso, jexecutor, jschedule, _jax_loss, jopt.sgd))
    cfg = dm.DasoConfig(n_replicas=R, global_world=4 * R, b_max=4, warmup_steps=n_steps // 10,
                        cooldown_steps=n_steps // 10, total_steps=n_steps)
    return ex.make_strategy(name, lo, opt(momentum=0.9), cfg,
                            controller=sc.DasoController(cfg, loss_window=loss_window))


def _supervise(pkg, n_steps, plan_events, *, R=4, seed=6, **kw):
    params0, batch = _mlp(seed, R)
    conv = _t if pkg == "port" else _j
    strat = _strategy(pkg, n_steps, R)
    run, fp, lr = ((run_with_faults, FaultPlan, constant_lr) if pkg == "port"
                   else (jax_run_with_faults, jfaults.FaultPlan, jax_constant_lr))
    ex = (executor if pkg == "port" else jexecutor).MacroCycleExecutor(strat)
    return run(strat, conv(params0), lambda t: conv(batch(t)), lr(0.1), n_steps,
               fp.from_dicts(plan_events), executor=ex, **kw), ex


def test_supervisor_end_to_end_matches_the_reference(tmp_path):
    """40 steps at R = 4 through a crash, a straggler, a degraded network
    and a rejoin, in both packages: the same timeline, applied events,
    invalidations, executor counts, controller events and history, the same
    simulated clock and wasted wait; losses within the executors'
    tolerances. The port's run is traced: one fault_event span per event,
    the controller's membership_change / dcn_scale instants, every event
    valid."""
    cost = dict(t_compute_s=0.1, exchange_cost_fn=lambda n, s: 0.05 * n / s)
    tracer = Tracer(str(tmp_path / "t.jsonl"))
    jtracer = jtrace.Tracer(str(tmp_path / "j.jsonl"))
    got, tex = _supervise("port", 40, SUPERVISED, tracer=tracer, **cost)
    want, jex = _supervise("jax", 40, SUPERVISED, tracer=jtracer, **cost)
    tracer.close()
    jtracer.close()
    assert got.membership_timeline == want.membership_timeline == \
        [(0, (1.0,) * 4), (10, (1.0, 1.0, 1.0, 0.0)), (26, (1.0,) * 4)]
    keys = ("step", "kind", "replica", "factor")
    assert [{k: e[k] for k in keys} for e in got.applied] == \
        [{k: e[k] for k in keys} for e in want.applied]
    assert got.invalidations == want.invalidations == 2
    for f in ("dispatches", "steps", "cycles", "compiles", "fallback_steps", "invalidations"):
        assert getattr(tex.stats, f) == getattr(jex.stats, f), f
    assert got.simulated_time_s == pytest.approx(want.simulated_time_s, rel=1e-12)
    assert got.wasted_wait_s == want.wasted_wait_s
    assert len(got.recovery_s()) == 2 and all(t > 0 for t in got.recovery_s())
    tc, jc = got.result.controller, want.result.controller
    assert tc.events == jc.events and tc.history == [tuple(h) for h in jc.history]
    np.testing.assert_allclose(got.result.losses, want.result.losses, rtol=1e-5, atol=1e-6)
    for a, b in zip(leaves(got.result.params), jax.tree.leaves(want.result.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=1e-6)
    events = load_events(str(tmp_path / "t.jsonl"))
    for ev in events:
        validate_event(ev)
    spans = [e for e in events if e["name"] == "fault_event"]
    assert [(e["args"]["step"], e["args"]["kind"]) for e in spans] == \
        [(e["step"], e["kind"]) for e in sorted(SUPERVISED, key=lambda e: e["step"])]
    names = [e["name"] for e in events if e["ph"] == "i"]
    assert names.count("membership_change") == 2 and names.count("dcn_scale") == 2
    jevents = jtrace.load_events(str(tmp_path / "j.jsonl"))

    def instants(evs):
        return [(e["name"], e["args"].get("dropped"), e["args"].get("reason"))
                for e in evs if e["ph"] == "i" and e["name"] != "tracer_self"]
    assert instants(events) == instants(jevents)
    assert [a for n, a, _ in instants(events) if n == "invalidate"] == \
        [a for n, a, _ in instants(jevents) if n == "invalidate"] and \
        names.count("invalidate") == 2


def test_finalize_params_skips_dead_replica_rows():
    strat = _strategy("port", 20)
    strat.set_membership([0.0, 1.0, 1.0, 1.0])
    assert strat.membership == (0.0, 1.0, 1.0, 1.0) and strat.n_active() == 3
    params0, _ = _mlp(8, 4)
    carry = strat.init_carry(_t(params0))
    rows = {k: v + torch.arange(4.0).reshape((4,) + (1,) * (v.dim() - 1))
            for k, v in carry[0].items()}
    out = strat.finalize_params((rows,) + carry[1:])
    for k in rows:
        assert torch.equal(out[k], rows[k][1])
    strat.set_membership([1.0] * 4)
    assert strat.membership is None
    assert torch.equal(strat.finalize_params((rows,) + carry[1:])["w1"], rows["w1"][0])


def test_supervisor_matches_plain_executor_without_faults():
    """An empty plan changes no number: the losses, metrics and the whole
    carry of run_compiled_training, bit for bit."""
    params0, batch = _mlp(7, 2)
    rep = run_with_faults(_strategy("port", 24, R=2), _t(params0), lambda t: _t(batch(t)),
                          constant_lr(0.1), 24, FaultPlan())
    ref = executor.run_compiled_training(_strategy("port", 24, R=2), _t(params0),
                                         lambda t: _t(batch(t)), constant_lr(0.1), 24)
    assert rep.result.losses == ref.losses and rep.result.metrics == ref.metrics
    for a, b in zip(leaves(rep.result.carry), leaves(ref.carry), strict=True):
        assert torch.equal(a, b)
    assert rep.invalidations == 0 and rep.membership_timeline == [(0, (1.0, 1.0))]


def test_faulted_run_resumes_bit_exact(tmp_path):
    """A TrainState saved while replica 3 is down (its mask in the state)
    and resumed by the supervisor: the uninterrupted faulted run's losses
    and carry, bit for bit."""
    params0, batch = _mlp(9, 4)
    plan = [{"step": 6, "kind": "crash", "replica": 3},
            {"step": 20, "kind": "rejoin", "replica": 3}]
    saved = {}

    def cb(step, carry, losses):
        if 8 <= step < 20 and not saved:
            saved["step"] = step
            io.save_train_state(str(tmp_path / "ck"), io.TrainState(
                step=step, carry=carry, controller=strat.controller.state_dict(),
                membership=list(strat.membership), losses=list(losses)))

    strat = _strategy("port", 32)
    full = run_with_faults(strat, _t(params0), lambda t: _t(batch(t)), constant_lr(0.1), 32,
                           FaultPlan.from_dicts(plan), ckpt_every=4, ckpt_cb=cb)
    ts = io.load_train_state(str(tmp_path / "ck"), device="cpu")
    assert ts.membership == [1.0, 1.0, 1.0, 0.0]
    strat2 = _strategy("port", 32)
    strat2.controller.load_state_dict(ts.controller)
    resumed = run_with_faults(strat2, _t(params0), lambda t: _t(batch(t)), constant_lr(0.1),
                              32, FaultPlan.from_dicts(plan[1:]), start_step=ts.step,
                              carry=ts.carry, membership=ts.membership)
    assert ts.losses + resumed.result.losses == full.result.losses
    for a, b in zip(leaves(resumed.result.carry), leaves(full.result.carry), strict=True):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="before resume step"):
        run_with_faults(_strategy("port", 32), _t(params0), lambda t: _t(batch(t)),
                        constant_lr(0.1), 32, FaultPlan.from_dicts(plan), start_step=ts.step,
                        carry=ts.carry, membership=ts.membership)


@pytest.mark.parametrize("executor_kind", ["macro", "per_step"])
def test_deterministic_resume_matches_uninterrupted(executor_kind, tmp_path):
    """tests/test_resilience.py's resume, bit for bit within the port."""
    params0, batch = _mlp(0, 2)
    base = dict(strategy="daso", n_steps=40, n_replicas=2, loss_window=10,
                executor=executor_kind, device="cpu")

    def run(**kw):
        return run_training(_loss, _t(params0), lambda t: _t(batch(t)),
                            TrainLoopConfig(**base, **kw), log=None)
    fresh = run()
    run(ckpt_every=10, ckpt_dir=str(tmp_path))
    states = io.list_train_state_dirs(str(tmp_path))
    mid = states[len(states) // 2]
    resumed = run(resume_from=mid)
    assert resumed.losses == fresh.losses
    for a, b in zip(leaves(resumed.carry), leaves(fresh.carry), strict=True):
        assert torch.equal(a, b)
    assert [h[1] for h in resumed.controller.history] == \
        [h[1] for h in fresh.controller.history]


def test_supervisor_refuses_what_is_not_ported(tmp_path):
    """Item 18's autotune path is refused. Item 16's `placement` and
    `health` are taken: a one-process placement gives the unplaced run's
    numbers bit for bit, and the health monitor hears of the last cycle."""
    from repro_torch.launch.distributed import ProcessPlacement
    from repro_torch.resilience import runtime

    events = [{"step": 3, "kind": "crash", "replica": 1},
              {"step": 6, "kind": "rejoin", "replica": 1}]
    plain, _ = _supervise("port", 8, events)
    health = runtime.HealthMonitor(runtime.HealthConfig(run_dir=str(tmp_path)),
                                   proc_id=0).start()
    try:
        placed, ex = _supervise("port", 8, events, health=health,
                                placement=ProcessPlacement(
                                    TopologySpec.load("chip:4 x pod:4"), device="cpu"))
    finally:
        health.close()
    assert ex.placement is not None and ex.health is health
    assert placed.result.losses == plain.result.losses
    for a, b in zip(leaves(placed.result.params), leaves(plain.result.params), strict=True):
        assert torch.equal(a, b)
    assert runtime.read_heartbeat(str(tmp_path), 0, 0)["step"] == 8
    params0, _ = _mlp(1, 4)
    with pytest.raises(NotImplementedError, match="item 18"):
        run_with_faults(_strategy("port", 8), _t(params0), None, None, 8, FaultPlan(),
                        autotune_every=4)
