"""The port's self-tuning plane (`repro_torch.topo.probe`, the controllers'
`retune`, the supervisor's autotune path, `TrainLoopConfig.autotune`), the
twin of tests/test_tuning.py, held against the JAX package on the CPU on the
same inputs:

  * the probe: two port probes give the same checksums bit for bit, and
    the reference's within 1e-6 relative (both sum 16,384 f32 values, in
    different orders); the same levels probed; `annotated_level_costs`,
    `measured_bandwidths`, `derive_retuned_periods` (the no-op identity on
    three topologies) and `fit_level_costs` equal to the reference's;
  * `retune` (both controllers) on given cost dicts: the no-op on the
    annotations (no state, no event, no trace), the DCN stretch, the
    periods from the cost ratio, the `%period` pin, each with the
    reference's return value, state_dict, events and trace instants;
  * the regrouping: `skew_permutation` equal to the reference's and never
    adding wasted wait, the permuted group mean keeping the global mean
    and bit for bit the reference's and a numpy permute-then-mean oracle,
    `normalize_group_perm`, `heartbeat_skew`;
  * persistence: the tuned periods, b, w and the DCN scale through the
    controller's state_dict and a TrainState, in either package;
  * the supervisor: autotune on a healthy plan a bit-exact no-op; a DCN
    degradation found within 3 cycles; a straggler reshuffle; a reshuffled
    run that trains; each against the reference's `retunes`,
    `reshuffles`, controller events and history on the same plan and cost
    model, and the traced `autotune_probe` spans read by
    tools/trace_report.py;
  * `run_training(autotune=True)` and its skip under `distributed`.

Timed costs are never compared between the packages: the probe's wall
clock differs from run to run. Inputs are made from a seed with numpy."""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.checkpoint import io as jio
from repro.core import daso as jdaso
from repro.optim import optimizers as jopt
from repro.optim.schedules import constant_lr as jax_constant_lr
from repro.resilience import faults as jfaults
from repro.resilience import runtime as jruntime
from repro.resilience.supervisor import run_with_faults as jax_run_with_faults
from repro.topo import lower as jlower
from repro.topo import probe as jprobe
from repro.topo import spec as jspec
from repro_torch.checkpoint import io
from repro_torch.core import daso, executor, schedule
from repro_torch.obs.trace import Tracer, load_events, validate_event
from repro_torch.optim.optimizers import sgd
from repro_torch.optim.schedules import constant_lr
from repro_torch.resilience import FaultPlan, run_with_faults
from repro_torch.resilience import runtime
from repro_torch.topo import lower, probe
from repro_torch.topo.spec import TopologySpec
from repro_torch.train import loop
from repro_torch.tree import leaves

SPEC3 = "chip:2 x host:2@50e9 x pod:2@25e9"   # R = 4
TOPOS = ["chip:4 x pod:2", SPEC3, "chip:2 x host:2@600e9 x rack:2@50e9 x pod:2@25e9"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, H, PER = 8, 16, 8


def _specs(text=SPEC3):
    return jspec.TopologySpec.parse(text), TopologySpec.parse(text)


# -- the probe ---------------------------------------------------------------------

def test_active_probe_checksums_are_deterministic_and_the_references():
    """Two port probes: the same checksums bit for bit and the same levels
    (every inner level with groups of more than one, and the outer key), all
    costs positive; the checksums within 1e-6 of the reference's."""
    jsp, sp = _specs()
    a = probe.active_probe(sp, rounds=2)
    b = probe.active_probe(sp, rounds=2)
    assert a.checksums == b.checksums
    assert set(a.costs) == set(b.costs) == {"host", probe.OUTER_KEY}
    assert all(t > 0 for t in a.costs.values())
    assert a.rounds == 2 and a.param_bytes == 4 * 4 * (1 << 12)  # R rows of f32
    want = jprobe.active_probe(jsp, rounds=1)
    assert set(want.checksums) == set(a.checksums) and want.param_bytes == a.param_bytes
    for k, v in want.checksums.items():
        assert a.checksums[k] == pytest.approx(v, rel=1e-6)


def test_annotated_costs_and_bandwidths_are_the_references():
    jsp, sp = _specs()
    costs = probe.annotated_level_costs(sp, param_bytes=100e9)
    assert costs == jprobe.annotated_level_costs(jsp, param_bytes=100e9)
    assert costs["host"] == pytest.approx(100e9 / 50e9)
    assert costs[probe.OUTER_KEY] == pytest.approx(100e9 / 25e9)
    meas = {"host": 2.5, "_outer": 4.0, "ghost": 0.0}
    assert probe.measured_bandwidths(sp, meas, param_bytes=100e9) == \
        jprobe.measured_bandwidths(jsp, meas, param_bytes=100e9)


@pytest.mark.parametrize("text", TOPOS)
def test_retuned_periods_identity_on_annotated_costs(text):
    """The no-op invariant: the spec's own annotated costs give the static
    lowering, in both packages; a quartered host link, the reference's
    periods."""
    jsp, sp = _specs(text)
    costs = probe.annotated_level_costs(sp)
    assert probe.derive_retuned_periods(sp, costs) == lower.derive_inner_periods(sp) == \
        jprobe.derive_retuned_periods(jsp, jprobe.annotated_level_costs(jsp))
    slow = {k: (4 * v if k != probe.OUTER_KEY else v) for k, v in costs.items()}
    assert probe.derive_retuned_periods(sp, slow) == jprobe.derive_retuned_periods(jsp, slow)


def test_fit_level_costs_is_the_references():
    rng = np.random.default_rng(3)
    samples = [(name, float(s)) for name in ("host", "_outer", "rack")
               for s in rng.uniform(1.0, 9.0, size=int(rng.integers(1, 6)))]
    assert probe.fit_level_costs(samples) == jprobe.fit_level_costs(samples)


# -- retune -------------------------------------------------------------------------

def _controllers(text=SPEC3):
    jsp, sp = _specs(text)
    jc = jlower.make_controller(jsp, jlower.daso_config_from(jsp, total_steps=64),
                                loss_window=10 ** 9)
    tc = lower.make_controller(sp, lower.daso_config_from(sp, total_steps=64),
                               loss_window=10 ** 9)
    return jc, tc


class _Instants:
    """A tracer that keeps its instants."""

    def __init__(self):
        self.events = []

    def instant(self, name, cat, **args):
        self.events.append((name, cat, args))


def _retune_both(jc, tc, meas, ann, **kw):
    jc.tracer, tc.tracer = _Instants(), _Instants()
    want = jc.retune(meas, annotated=ann, **kw)
    got = tc.retune(meas, annotated=ann, **kw)
    assert got == want
    assert json.loads(json.dumps(tc.state_dict())) == json.loads(json.dumps(jc.state_dict()))
    assert tc.events == [tuple(e) for e in jc.events]
    assert tc.tracer.events == jc.tracer.events
    return got


def test_retune_noop_when_measured_matches_annotated():
    jc, tc = _controllers()
    ann = probe.annotated_level_costs(TopologySpec.parse(SPEC3))
    before = (tc.b, tc.w, dict(tc.inner_periods), list(tc.events))
    assert _retune_both(jc, tc, dict(ann), ann) is False
    assert (tc.b, tc.w, dict(tc.inner_periods), list(tc.events)) == before
    assert tc.tracer.events == []


@pytest.mark.parametrize("factor", [4.0, 2.0, 1.02, 0.5])
def test_retune_outer_scale_is_the_references(factor):
    """A slower outer link stretches B (events dcn_scale and retune), one
    within rel_tol is a no-op, a faster one clamps B to b_max."""
    jc, tc = _controllers()
    b0 = tc.b
    ann = probe.annotated_level_costs(TopologySpec.parse(SPEC3))
    meas = dict(ann)
    meas[probe.OUTER_KEY] = ann[probe.OUTER_KEY] * factor
    changed = _retune_both(jc, tc, meas, ann, step=8)
    assert changed is (factor != 1.02)
    if factor > 1.02:
        assert tc.b > b0
        assert [k for (_, k, _) in tc.events][:2] == ["dcn_scale", "retune"]


def test_base_controller_retune_is_the_references():
    """The 2-level controller owns the outer level only."""
    jc, tc = _controllers("chip:4 x pod:2")
    assert type(tc) is schedule.DasoController
    assert _retune_both(jc, tc, {"_outer": 8.0}, {"_outer": 2.0}, step=3) is True
    assert _retune_both(jc, tc, {"_outer": 8.0}, {"_outer": 2.0}, step=5) is False
    assert _retune_both(jc, tc, {"_outer": 2.0}, {"_outer": 2.0}, step=7) is True
    assert _retune_both(jc, tc, {"_outer": 0.0}, {"_outer": 2.0}) is False
    assert _retune_both(jc, tc, {"_outer": 1.0}, None) is False


def test_retune_rederives_inner_periods_from_cost_ratio():
    jc, tc = _controllers()
    assert tc.inner_periods == {"host": 2}
    ann = probe.annotated_level_costs(TopologySpec.parse(SPEC3))
    meas = dict(ann)
    meas["host"] = ann["host"] / 2.0
    meas[probe.OUTER_KEY] = ann[probe.OUTER_KEY] * 2.0
    assert _retune_both(jc, tc, meas, ann, step=4) is True
    assert tc.inner_periods["host"] == 1
    assert "retune_periods" in [k for (_, k, _) in tc.events]


def test_retune_respects_pinned_periods():
    jc, tc = _controllers("chip:2 x host:2@50e9%2 x pod:2@25e9")
    assert tc.pinned_periods == ("host",)
    ann = probe.annotated_level_costs(TopologySpec.parse("chip:2 x host:2@50e9%2 x pod:2@25e9"))
    meas = dict(ann)
    meas["host"] = ann["host"] / 8.0
    meas[probe.OUTER_KEY] = ann[probe.OUTER_KEY] * 2.0
    _retune_both(jc, tc, meas, ann, step=4)
    assert tc.inner_periods["host"] == 2


# -- the regrouping ------------------------------------------------------------------

@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 10 ** 6), group_size=st.sampled_from([2, 4]),
       masked=st.booleans())
def test_permuted_group_mean_preserves_global_mean(seed, group_size, masked):
    """For any regrouping the group means keep the (membership-weighted)
    global mean, and the port's is the reference's bit for bit."""
    R = 8
    rng = np.random.default_rng(seed)
    perm = tuple(int(i) for i in rng.permutation(R))
    w = rng.normal(size=(R, 5)).astype(np.float32)
    mask = tuple(1.0 if (not masked or i != 3) else 0.0 for i in range(R))
    got = daso.level_group_mean({"w": torch.from_numpy(w)}, group_size, mask=mask,
                                perm=perm)["w"].numpy()
    want = np.asarray(jdaso.level_group_mean({"w": jnp.asarray(w)}, group_size, mask=mask,
                                             deterministic=True, perm=perm)["w"])
    np.testing.assert_array_equal(got, want)
    m = np.asarray(mask, np.float64)[:, None]
    target = (w.astype(np.float64) * m).sum(0) / m.sum()
    np.testing.assert_allclose((got.astype(np.float64) * m).sum(0) / m.sum(), target,
                               rtol=1e-6, atol=1e-6)


def test_permuted_group_mean_matches_permute_then_mean_oracle():
    R, g = 8, 2
    rng = np.random.default_rng(0)
    perm = (3, 0, 6, 1, 7, 2, 5, 4)
    x = rng.normal(size=(R, 4, 3)).astype(np.float32)
    out = daso.level_group_mean({"w": torch.from_numpy(x)}, g, perm=perm)["w"].numpy()
    xp = x[list(perm)]
    mp = xp.reshape(R // g, g, 4, 3).mean(1, keepdims=True)
    mp = np.broadcast_to(mp, (R // g, g, 4, 3)).reshape(R, 4, 3)
    np.testing.assert_array_equal(out, mp[np.argsort(perm)])
    np.testing.assert_array_equal(out, np.asarray(jdaso.level_group_mean(
        {"w": jnp.asarray(x)}, g, deterministic=True, perm=perm)["w"]))


def test_identity_perm_normalizes_to_fast_path():
    for p in ((0, 1, 2, 3), None, (1, 0, 3, 2)):
        assert daso.normalize_group_perm(p, 4) == jdaso.normalize_group_perm(p, 4)
    assert daso.normalize_group_perm((0, 1, 2, 3), 4) is None
    with pytest.raises(ValueError):
        daso.normalize_group_perm((0, 0, 1, 2), 4)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10 ** 6))
def test_skew_permutation_never_increases_wasted_wait(seed):
    rng = np.random.default_rng(seed)
    slow = [float(s) for s in rng.uniform(1.0, 3.0, size=8)]
    perm = probe.skew_permutation(slow)
    assert perm == jprobe.skew_permutation(slow)
    before = probe.wasted_wait_s(slow, [1.0] * 8, 2, None, 1.0)
    after = probe.wasted_wait_s(slow, [1.0] * 8, 2, perm, 1.0)
    assert after <= before + 1e-9
    assert after == jprobe.wasted_wait_s(slow, [1.0] * 8, 2, perm, 1.0)
    assert probe.skew_permutation([1.0, 1.02, 0.99, 1.0]) is None


def test_heartbeat_skew_normalizes_to_fastest():
    before = {0: {"step": 0, "t": 0.0}, 1: {"step": 0, "t": 0.0}}
    after = {0: {"step": 10, "t": 1.0}, 1: {"step": 5, "t": 1.0}}
    skew = runtime.heartbeat_skew(before, after)
    assert skew == jruntime.heartbeat_skew(before, after)
    assert skew[0] == pytest.approx(1.0) and skew[1] == pytest.approx(2.0)


# -- persistence ----------------------------------------------------------------------

def _tuned():
    jc, tc = _controllers()
    ann = probe.annotated_level_costs(TopologySpec.parse(SPEC3))
    meas = dict(ann)
    meas[probe.OUTER_KEY] = ann[probe.OUTER_KEY] * 4.0
    meas["host"] = ann["host"] / 2.0
    _retune_both(jc, tc, meas, ann, step=8)
    return jc, tc


def test_controller_state_dict_persists_tuned_periods():
    _, ctl = _tuned()
    tuned = dict(ctl.inner_periods)
    sd = ctl.state_dict()
    assert sd["inner_periods"] == tuned and sd["_dcn_scale"] == 0.25
    fresh = _controllers()[1]
    fresh.load_state_dict(sd)
    assert fresh.inner_periods == tuned
    for t in range(4, 24):
        assert fresh.mode_for_step(t) == ctl.mode_for_step(t)
    legacy = _controllers()[1]
    legacy.load_state_dict({k: v for k, v in sd.items() if k != "inner_periods"})
    assert legacy.inner_periods == {"host": 2}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_train_state_resume_restores_tuned_periods(writer, tmp_path):
    """A TrainState saved after a retune (by either package) gives the port
    the tuned periods, b, w and DCN scale; the round trip is exact."""
    jc, tc = _tuned()
    if writer == "port":
        io.save_train_state(str(tmp_path), io.TrainState(
            step=8, carry=({"w": torch.ones((4, 3))},), controller=tc.state_dict(),
            membership=[1.0] * 4, strategy="hier_daso"))
    else:
        jio.save_train_state(str(tmp_path), jio.TrainState(
            step=8, carry=({"w": jnp.ones((4, 3))},), controller=jc.state_dict(),
            membership=[1.0] * 4, strategy="hier_daso"))
    loaded = io.load_train_state(str(tmp_path), device="cpu")
    assert loaded.version == io.TRAIN_STATE_VERSION >= 3
    resumed = _controllers()[1]
    resumed.load_state_dict(loaded.controller)
    assert resumed.inner_periods == tc.inner_periods == {"host": 1}
    assert (resumed.b, resumed.w, resumed._dcn_scale) == (tc.b, tc.w, 0.25)
    assert resumed.state_dict() == tc.state_dict()


# -- the supervisor --------------------------------------------------------------------

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


def _cost(n, s):
    return 0.05 / s


def _supervise(pkg, n_steps, events, *, seed=12, **kw):
    """The hier_daso MLP problem on SPEC3 through either package's
    supervisor, with tests/test_tuning.py's cost model."""
    params0, batch = _mlp(seed, 4)
    jsp, sp = _specs()
    if pkg == "port":
        strat = lower.build_topology_strategy(
            _loss, sgd(momentum=0.9), sp, lower.daso_config_from(
                sp, warmup_steps=2, cooldown_steps=2, total_steps=n_steps),
            loss_window=10 ** 9)
        conv = torch.from_numpy
        run, plan, lr = run_with_faults, FaultPlan.from_dicts(events), constant_lr(0.1)
        ex = executor.MacroCycleExecutor(strat)
    else:
        strat = jlower.build_topology_strategy(
            _jax_loss, jopt.sgd(momentum=0.9), jsp, jlower.daso_config_from(
                jsp, warmup_steps=2, cooldown_steps=2, total_steps=n_steps),
            loss_window=10 ** 9)
        conv = jnp.asarray
        run, plan = jax_run_with_faults, jfaults.FaultPlan.from_dicts(events)
        lr = jax_constant_lr(0.1)
        from repro.core.executor import MacroCycleExecutor
        ex = MacroCycleExecutor(strat)
    rep = run(strat, {k: conv(v) for k, v in params0.items()},
              lambda t: {k: conv(v) for k, v in batch(t).items()}, lr, n_steps, plan,
              executor=ex, t_compute_s=0.01, exchange_cost_fn=_cost, **kw)
    return rep, strat, ex


def _assert_supervised_as_the_reference(got, want):
    keys = ("step", "cycle", "measured_s", "nominal_s", "schedule_changed", "reshuffled")
    assert [{k: r[k] for k in keys} for r in got[0].retunes] == \
        [{k: r[k] for k in keys} for r in want[0].retunes]
    assert got[0].reshuffles == want[0].reshuffles
    assert got[0].invalidations == want[0].invalidations
    assert got[0].membership_timeline == want[0].membership_timeline
    assert got[0].simulated_time_s == pytest.approx(want[0].simulated_time_s, rel=1e-12)
    assert got[0].wasted_wait_s == pytest.approx(want[0].wasted_wait_s, rel=1e-12)
    tc, jc = got[1].controller, want[1].controller
    assert tc.events == [tuple(e) for e in jc.events]
    assert tc.history == [tuple(h) for h in jc.history]
    assert tc.inner_periods == jc.inner_periods
    assert got[1].group_perm == want[1].group_perm
    np.testing.assert_allclose(got[0].result.losses, want[0].result.losses,
                               rtol=1e-5, atol=1e-6)


def test_autotune_without_faults_is_bit_exact_noop():
    """Autotune on a healthy plan probes every cycle and changes nothing:
    the untuned run's losses, metrics and carry bit for bit."""
    runs = [_supervise("port", 24, [], autotune_every=k)[0] for k in (0, 1)]
    assert runs[1].retunes == [] and runs[1].reshuffles == 0
    assert runs[1].invalidations == 0
    assert runs[0].result.losses == runs[1].result.losses
    assert runs[0].result.metrics == runs[1].result.metrics
    for a, b in zip(leaves(runs[0].result.carry), leaves(runs[1].result.carry), strict=True):
        assert torch.equal(a, b)


def test_supervisor_discovers_dcn_degradation_within_k_cycles(tmp_path):
    """With oracle notification off (the autotune default) a DCN
    degradation is found by the probe, and the schedule stretched within 3
    cycles of the event; as the reference's run of the plan. The traced
    run's autotune_probe spans and retune instants are valid, one span per
    probe round, and tools/trace_report.py reads the trace."""
    events = [{"step": 8, "kind": "degrade_dcn", "factor": 0.25}]
    tracer = Tracer(str(tmp_path / "t.jsonl"))
    got = _supervise("port", 32, events, autotune_every=1, tracer=tracer)
    tracer.close()
    want = _supervise("jax", 32, events, autotune_every=1)
    _assert_supervised_as_the_reference(got, want)
    rep, strat, ex = got
    assert np.all(np.isfinite(rep.result.losses))
    evs = load_events(str(tmp_path / "t.jsonl"))
    for ev in evs:
        validate_event(ev)
    probes = [e for e in evs if e["name"] == "autotune_probe"]
    assert len(probes) == len(rep.result.cycles) and all(e["ph"] == "X" for e in probes)
    # the degradation's cycle: the first probe round at or after its step
    # (a round every cycle), whether or not that round changed anything
    degrade_cycle = min(e["args"]["cycle"] for e in probes if e["args"]["step"] >= 8)
    sched = [r for r in rep.retunes if r["schedule_changed"]]
    assert sched and sched[0]["step"] >= 8
    assert sched[0]["cycle"] - degrade_cycle <= 3
    assert strat.controller.b > 4 and ex.stats.invalidations >= 1
    assert "retune" in [k for (_, k, _) in strat.controller.events]
    assert sum(e["name"] == "retune" for e in evs) >= 1
    spec = importlib.util.spec_from_file_location(
        "trace_report", os.path.join(REPO, "tools", "trace_report.py"))
    tr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tr)
    report = tr.build_report(tr.load_events(str(tmp_path / "t.jsonl")))
    assert report["schema_errors"] == [] and "resilience" in report["summary"]


def test_supervisor_reshuffles_on_straggler_skew():
    """Stragglers 1 and 3 in different host groups: a probe round regroups
    them together, as the reference does, and the wasted wait drops below
    the run without reshuffling."""
    events = [{"step": 4, "kind": "straggle", "replica": 1, "factor": 3.0},
              {"step": 4, "kind": "straggle", "replica": 3, "factor": 3.0}]
    got = _supervise("port", 32, events, seed=13, autotune_every=1)
    _assert_supervised_as_the_reference(
        got, _supervise("jax", 32, events, seed=13, autotune_every=1))
    rep, strat, _ = got
    assert rep.reshuffles >= 1
    perm = strat.group_perm
    assert {1, 3} in [set(perm[i:i + 2]) for i in range(0, 4, 2)]
    still = _supervise("port", 32, events, seed=13, autotune_every=1, reshuffle=False)[0]
    assert still.reshuffles == 0 and rep.wasted_wait_s < still.wasted_wait_s


def test_reshuffled_training_stays_finite_and_trains():
    events = [{"step": 6, "kind": "straggle", "replica": 0, "factor": 2.5},
              {"step": 6, "kind": "straggle", "replica": 2, "factor": 2.5}]
    got = _supervise("port", 40, events, seed=14, autotune_every=2)
    _assert_supervised_as_the_reference(
        got, _supervise("jax", 40, events, seed=14, autotune_every=2))
    rep = got[0]
    assert len(rep.result.losses) == 40 and np.all(np.isfinite(rep.result.losses))
    assert rep.result.final_loss < rep.result.losses[0]


def test_oracle_notify_follows_autotune():
    """Without autotune a degrade_dcn event tells the controller directly;
    with it only the probe does, unless oracle_notify is set."""
    events = [{"step": 8, "kind": "degrade_dcn", "factor": 0.25}]
    kinds = {}
    for name, kw in (("oracle", {}), ("probe", {"autotune_every": 4}),
                     ("both", {"autotune_every": 4, "oracle_notify": True})):
        rep, strat, _ = _supervise("port", 24, events, **kw)
        kinds[name] = [k for (_, k, _) in strat.controller.events]
    assert kinds["oracle"] == ["dcn_scale"]
    assert kinds["probe"][:2] == ["dcn_scale", "retune"] and kinds["probe"].count("retune") == 1
    assert kinds["both"] == ["dcn_scale"]


def test_reshuffling_autotune_is_refused_under_overlap_dispatch():
    """Across processes under dispatch "overlap" a regrouped inner sync
    could gather beside the exchange's gather: refused, naming serial."""
    from repro_torch.launch.distributed import ProcessPlacement

    placement = ProcessPlacement(TopologySpec.parse(SPEC3), device="cpu")
    placement.n_procs, placement.dispatch = 2, "overlap"
    params0, batch = _mlp(1, 4)
    sp = TopologySpec.parse(SPEC3)
    strat = lower.build_topology_strategy(_loss, sgd(momentum=0.9), sp,
                                          lower.daso_config_from(sp, total_steps=8))
    with pytest.raises(ValueError, match="--dispatch serial"):
        run_with_faults(strat, {k: torch.from_numpy(v) for k, v in params0.items()},
                        lambda t: {k: torch.from_numpy(v) for k, v in batch(t).items()},
                        constant_lr(0.1), 8, FaultPlan(), placement=placement,
                        autotune_every=1)


# -- the loop ---------------------------------------------------------------------------

def test_run_training_autotune_probes_and_retunes():
    """`autotune=True` probes each level at startup and retunes (a wall-clock
    measurement, so only its shape is held); without a topology, and under
    `distributed`, the schedule is left as configured with the reference's
    messages."""
    params0, batch = _mlp(5, 4)
    lines = []
    kw = dict(strategy="daso", n_steps=8, loss_window=10, device="cpu", autotune=True)
    res = loop.run_training(_loss, {k: torch.from_numpy(v) for k, v in params0.items()},
                            lambda t: {k: torch.from_numpy(v) for k, v in batch(t).items()},
                            loop.TrainLoopConfig(topology=SPEC3, **kw), log=lines.append)
    assert len(res.losses) == 8
    line = next(x for x in lines if x.startswith("[train] autotune probe: measured"))
    assert "us/sync -> retuned=" in line and "inner_periods=" in line
    lines.clear()
    loop.run_training(_loss, {k: torch.from_numpy(v) for k, v in params0.items()},
                      lambda t: {k: torch.from_numpy(v) for k, v in batch(t).items()},
                      loop.TrainLoopConfig(**kw), log=lines.append)
    assert "[train] autotune: no topology spec to probe; schedule left as configured" in lines
    lines.clear()
    cfg = loop.TrainLoopConfig(topology=SPEC3, distributed=True, **kw)
    strat = loop.build_strategy(_loss, cfg, sgd(momentum=0.9))
    loop.startup_probe(cfg, strat, torch.device("cpu"), lines.append)
    assert lines == ["[train] autotune: startup wall-clock probe skipped under "
                     "--distributed (see docs/tuning.md)"]
    assert loop.TrainLoopConfig().autotune_every == 8
