"""The resilience supervisor: a fault plan driven end to end on the
simulated clock (`repro/resilience/supervisor.py`).

It wraps the macro-cycle executor's loop (core/executor.py) with three
pieces:

  * **elastic membership**: at a crash or rejoin the supervisor sets the
    strategy's membership mask (`DasoStrategy.set_membership`, which drops
    its step variants), invalidates the executor's programs (they run the
    old variants) and, on a rejoin, reseeds the joiner's carry rows from the
    survivors' mean first (resilience/membership.py);
  * **deterministic fault injection**: each cycle is cut at the plan's next
    event step, so every event lands between cycles where the plan says,
    and the controller hears of it (`notify_membership_change`,
    `notify_dcn_scale`) and adapts B / W;
  * **checkpoints**: `ckpt_every` / `ckpt_cb` as the executor's own, so a
    faulted run resumes too.

Beside the training result it reports each event's recovery cost (the
host's handling plus the first cycle after the event, which builds the new
programs) and a simulated wall clock that charges each step's compute at
its slowest active straggler and each exchange at the degraded network's
cost. With a tracer each event is a `fault_event` span, each checkpoint a
`checkpoint_save` span, and the tracer is handed to the executor and the
controller.

Across processes (`placement`, launch/distributed.py::ProcessPlacement)
the same loop runs on each process's replica rows: the carry is placed, a
rejoin reseeds the fetched carry on the host and puts it back (the same
bytes on every process), and the final params are broadcast from their
owner, so a faulted N-process run is the one-process run bit for bit.
`health` (resilience/runtime.py::HealthMonitor) hears of every cycle, so a
supervised worker's watchdog moves only while the group makes progress.

Self-tuning (`autotune_every` = K > 0): every K cycles the supervisor
probes one exchange at the network's current state on the simulated clock
(`exchange_cost_fn`, charged to it: a probe is not free), sets it against
the nominal cost and feeds both to `controller.retune`; with `reshuffle` it
also sorts the replicas' slowdowns into a regrouping
(`topo/probe.py::skew_permutation`, `DasoStrategy.set_group_permutation`)
when the innermost group is smaller than R. Any change invalidates the
executor's programs. Under autotune the degraded network is found by the
probe, so `oracle_notify` (the fault events' direct word to the
controller) defaults to off; each probe round is an `autotune_probe` span.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.core.executor import (MacroCycleExecutor, Strategy, dispatch_planned_cycle,
                                       resolve_executor)
from repro_torch.core.schedule import Mode, split_mode, split_ov
from repro_torch.core.simulator import SimResult
from repro_torch.resilience.faults import FaultPlan
from repro_torch.resilience.membership import reseed_carry
from repro_torch.topo import probe as probe_mod

OVERLAP_RESHUFFLE = (
    "autotune with reshuffling regroups the inner syncs, and a regrouped "
    "group can span processes: under dispatch 'overlap' its gather would run "
    "while the overlap exchange's gather is in flight. Use --dispatch serial "
    "(run_with_faults also takes reshuffle=False)")

# outermost-level actions that cross the network between nodes, each charged
# one exchange on the simulated clock (a hierarchical token counts by its
# outer action: inner-level syncs ride faster links)
_SYNC_MODES = (Mode.SEND, Mode.SEND_RECEIVE, Mode.BLOCKING, Mode.HARD_AVG,
               Mode.GOSSIP, Mode.ELASTIC, Mode.PUSH)


@dataclass
class ResilienceReport:
    result: SimResult
    applied: List[Dict] = field(default_factory=list)  # one record per event
    invalidations: int = 0
    simulated_time_s: float = 0.0
    membership_timeline: List = field(default_factory=list)  # (step, mask)
    # the autotune path: one record per probe round that changed the
    # schedule or the grouping, and the number of regroupings
    retunes: List[Dict] = field(default_factory=list)
    reshuffles: int = 0
    # straggler wait an inner-group barrier wastes on the simulated clock
    # (topo/probe.py::wasted_wait_s)
    wasted_wait_s: float = 0.0

    def recovery_s(self) -> List[float]:
        """Per membership event: the host's handling + the first cycle after
        it (which builds the new programs)."""
        return [e["handle_s"] + e["first_cycle_s"] for e in self.applied
                if e["kind"] in ("crash", "rejoin")]


def run_with_faults(strategy: Strategy, params0, data_fn: Callable,
                    lr_fn: Callable, n_steps: int, plan: FaultPlan, *,
                    executor: Optional[MacroCycleExecutor] = None,
                    t_compute_s: float = 0.0,
                    exchange_cost_fn: Optional[Callable] = None,
                    topo=None, ckpt_every: int = 0,
                    ckpt_cb: Optional[Callable] = None, placement=None,
                    start_step: int = 0, carry=None, membership=None,
                    health=None, tracer=None, autotune_every: int = 0,
                    oracle_notify: Optional[bool] = None,
                    reshuffle: bool = True) -> ResilienceReport:
    """Run `n_steps` on the macro-cycle executor while replaying `plan`.

    `strategy` must have a replica axis (daso / hier_daso / local_sgd /
    gossip / easgd / downpour); its controller hears the events.
    `t_compute_s` and `exchange_cost_fn(n_active, dcn_scale) -> seconds`
    feed the simulated clock (0 and None: numbers only). `topo` (a
    `repro_torch.topo.TopologySpec`, by default the strategy's) resolves
    events that name topology nodes ("pod1", "pod1/host0") into per-replica
    events; without one such a plan is refused by `validate`.
    `ckpt_every` / `ckpt_cb(completed_steps, carry, losses)` as in
    `executor.run_compiled_training`.

    Resume: `start_step`, a restored `carry` and the checkpoint's
    `membership` continue a faulted run whose controller the caller has
    restored. An event before `start_step` is refused: the past is in the
    checkpoint already. `tracer` takes the `fault_event` and
    `checkpoint_save` spans and goes to the executor and the controller
    unless they have one. `placement` and `health` go to the executor
    (unless it has its own); the module docstring says what they do.

    `autotune_every` = K > 0 runs a probe round every K cycles (the module
    docstring), `reshuffle` lets it regroup the replicas. `oracle_notify`
    says whether degrade_dcn / restore_dcn events tell the controller
    directly; None means yes unless autotune is on. A multi-process run
    under dispatch "overlap" refuses a reshuffling autotune: a regrouped
    inner sync could cross processes while the exchange's gather is in
    flight (dispatch "serial" takes it)."""
    cfg = strategy.cfg
    if cfg is None:
        raise ValueError("run_with_faults needs a replica-axis strategy "
                         "with a DasoConfig (daso / hier_daso / local_sgd / "
                         "gossip / easgd / downpour)")
    n_replicas = cfg.n_replicas
    if topo is None:
        topo = getattr(strategy, "topo", None)
    if topo is not None:
        plan = plan.resolve(topo)
    mask = list(membership) if membership is not None else [1.0] * n_replicas
    past = [e for e in plan.events if e.step < start_step]
    if past:
        raise ValueError(
            f"fault plan has {len(past)} event(s) before resume step "
            f"{start_step} (first: {past[0]}); a resumed run replays only "
            "future events — the past is already in the checkpoint")
    plan.validate(n_replicas, alive0=[m > 0.0 for m in mask])

    ex, placement = resolve_executor(strategy, executor, placement)
    if (autotune_every > 0 and reshuffle and placement is not None
            and placement.n_procs > 1 and placement.dispatch == "overlap"):
        raise ValueError(OVERLAP_RESHUFFLE)
    if health is not None and ex.health is None:
        ex.health = health
    if tracer is not None and not ex.tracer.enabled:
        ex.tracer = tracer
    if (strategy.controller is not None and ex.tracer.enabled
            and getattr(strategy.controller, "tracer", None) is None):
        # schedule decisions (plateau, membership, dcn) land in the same trace
        strategy.controller.tracer = ex.tracer
    if membership is not None and any(m <= 0.0 for m in mask):
        # the checkpoint was taken under a reduced active set: the step
        # variants take its mask before anything runs
        strategy.set_membership(mask)
    slot = [strategy.init_carry(params0) if carry is None else carry]
    del carry
    if placement is not None:
        slot.append(placement.put_carry(slot.pop()))
    slowdowns = [1.0] * n_replicas
    dcn_scale = 1.0
    if oracle_notify is None:
        oracle_notify = autotune_every <= 0
    # the probe's measurement: the exchange's cost at the network's current
    # state; without a cost model, the normalized cost 1 / scale (the same
    # inferred scale, at no simulated price)
    probe_cost = (exchange_cost_fn if exchange_cost_fn is not None
                  else (lambda n, s: 1.0 / max(s, 1e-9)))
    # the innermost inner group of more than one replica, for the inner
    # barrier's wasted wait (no inner level: the only barrier is global)
    inner_group = n_replicas
    if topo is not None:
        sizes = [topo.group_size(lvl.name) for lvl in topo.levels[1:-1]
                 if topo.group_size(lvl.name) > 1]
        if sizes:
            inner_group = min(sizes)

    report = ResilienceReport(result=None)
    report.membership_timeline.append((start_step, tuple(mask)))
    losses: List[float] = []
    metrics_log: List[Dict[str, float]] = []
    seconds: List[float] = []
    cycles = []
    sim_time = 0.0
    pending_first_cycle: List[Dict] = []  # events waiting for their next cycle
    next_ckpt = (start_step // ckpt_every + 1) * ckpt_every if ckpt_every else None

    def membership_event(rec, step):
        strategy.set_membership(mask)
        ex.invalidate()
        if strategy.controller is not None:
            strategy.controller.notify_membership_change(step, int(sum(mask)))
        report.membership_timeline.append((step, tuple(mask)))
        pending_first_cycle.append(rec)

    def apply_event(ev, step):
        nonlocal dcn_scale
        t0 = time.perf_counter()
        rec = {"step": step, "kind": ev.kind, "replica": ev.replica,
               "factor": ev.factor, "first_cycle_s": 0.0}
        if ev.kind == "crash":
            mask[ev.replica] = 0.0
            membership_event(rec, step)
        elif ev.kind == "rejoin":
            # reseed BEFORE the mask flips: the donors are the survivors;
            # across processes on the gathered host carry, then placed again
            if placement is not None:
                slot.append(placement.put_carry(reseed_carry(
                    placement.fetch(slot.pop()), tuple(mask), [ev.replica])))
            else:
                slot.append(reseed_carry(slot.pop(), tuple(mask), [ev.replica]))
            mask[ev.replica] = 1.0
            membership_event(rec, step)
        elif ev.kind == "straggle":
            slowdowns[ev.replica] = ev.factor
        elif ev.kind == "recover":
            slowdowns[ev.replica] = 1.0
        elif ev.kind in ("degrade_dcn", "restore_dcn"):
            dcn_scale = ev.factor if ev.kind == "degrade_dcn" else 1.0
            if oracle_notify and strategy.controller is not None:
                strategy.controller.notify_dcn_scale(dcn_scale, step=step)
        rec["handle_s"] = time.perf_counter() - t0
        report.applied.append(rec)

    def autotune(step, cycle_idx):
        """One probe round: the exchange's cost at the network's current
        state against the nominal one, through `retune`, and the regrouping
        by skew."""
        nonlocal sim_time
        ctl = strategy.controller
        if ctl is None:
            return
        n_active = int(sum(1 for m in mask if m > 0.0))
        measured = probe_cost(n_active, dcn_scale)
        nominal = probe_cost(n_active, 1.0)
        if exchange_cost_fn is not None:
            sim_time += measured  # the probe's own exchange
        with ex.tracer.span("autotune_probe", cat="resilience", step=step,
                            cycle=cycle_idx, measured_s=measured, nominal_s=nominal):
            changed = ctl.retune({"_outer": measured}, annotated={"_outer": nominal},
                                 step=step)
            reshuffled = False
            if (reshuffle and hasattr(strategy, "set_group_permutation")
                    and inner_group < n_replicas):
                perm = probe_mod.skew_permutation(slowdowns)
                if perm != strategy.group_perm:
                    strategy.set_group_permutation(perm)
                    reshuffled = True
                    report.reshuffles += 1
        if changed or reshuffled:
            ex.invalidate()
            report.retunes.append({"step": step, "cycle": cycle_idx,
                                   "measured_s": measured, "nominal_s": nominal,
                                   "schedule_changed": bool(changed),
                                   "reshuffled": reshuffled})

    step = start_step
    cycle_idx = 0
    while step < n_steps:
        for ev in plan.events_at(step):
            # the span covers the carry surgery and the invalidation; the
            # programs it makes the next cycle build land in that cycle's
            # span (its fresh_compile flag), as first_cycle_s does
            with ex.tracer.span("fault_event", cat="resilience", kind=ev.kind,
                                step=step, replica=ev.replica, factor=ev.factor):
                apply_event(ev, step)
        if autotune_every > 0 and cycle_idx % autotune_every == 0:
            autotune(step, cycle_idx)
        # cut the cycle at the next event: events land between cycles
        max_len = min(ex.max_cycle_len, n_steps - step)
        boundary = plan.next_boundary_after(step)
        if boundary is not None:
            max_len = min(max_len, boundary - step)
        cycle_plan = strategy.plan_cycle(step, max_len)
        t0 = time.perf_counter()
        carry, cycle_losses, per_step_metrics, dt = dispatch_planned_cycle(
            ex, slot, cycle_plan, data_fn, lr_fn, n_steps)
        slot.append(carry)
        del carry
        cycle_s = time.perf_counter() - t0
        for rec in pending_first_cycle:
            rec["first_cycle_s"] = cycle_s
        pending_first_cycle.clear()
        # simulated clock: compute at the slowest ACTIVE replica, each sync
        # step one exchange at the degraded network's cost
        worst = max((s for s, m in zip(slowdowns, mask) if m), default=1.0)
        sim_time += len(cycle_plan) * t_compute_s * worst
        if exchange_cost_fn is not None:
            n_active = int(sum(mask))
            for mode, _ in cycle_plan.shape:
                if split_ov(split_mode(mode)[0])[0] in _SYNC_MODES:
                    sim_time += exchange_cost_fn(n_active, dcn_scale)
        report.wasted_wait_s += len(cycle_plan) * probe_mod.wasted_wait_s(
            slowdowns, mask, inner_group, getattr(strategy, "group_perm", None),
            t_compute_s)
        losses.extend(cycle_losses)
        metrics_log.extend(per_step_metrics)
        strategy.observe(cycle_losses)
        cycles.append((cycle_plan.shape, dt))
        seconds.extend([dt / len(cycle_plan)] * len(cycle_plan))
        step += len(cycle_plan)
        cycle_idx += 1
        if next_ckpt is not None and ckpt_cb is not None and step >= next_ckpt:
            if ex.exchange_stream is not None:
                torch.cuda.current_stream().wait_stream(ex.exchange_stream)
            with ex.tracer.span("checkpoint_save", cat="checkpoint", step=step):
                ckpt_cb(step, slot[0], losses)
            next_ckpt = (step // ckpt_every + 1) * ckpt_every

    carry = slot.pop()
    report.result = SimResult(losses=losses, metrics=metrics_log,
                              params=strategy.finalize_params(carry),
                              sync_fraction=strategy.sync_fraction(),
                              controller=strategy.controller,
                              executor_stats=ex.stats, step_seconds=seconds,
                              carry=carry, cycles=cycles, placement=placement)
    report.invalidations = ex.stats.invalidations
    report.simulated_time_s = sim_time
    return report
