"""End-to-end training entry point (`repro/train/loop.py`): strategy selection
through the registry (daso / hier_daso / sync / local_sgd / gossip / easgd /
downpour), an optional
N-level topology (`topology`, repro_torch/topo), LR schedule, loss trace
and the schedule's sync fraction, on one of two executors:

  * ``executor="macro"`` (default): the macro-cycle executor
    (core/executor.py), one dispatch and one loss fetch per controller
    cycle; under the overlap schedule each cycle's exchange runs on its own
    CUDA stream while the cycle's local steps run;
  * ``executor="per_step"``: one step per dispatch (core/simulator.py), the
    path the macro executor is held to bit for bit.

Checkpoints (`checkpoint/io.py`): with `ckpt_every` and `ckpt_dir` a
resumable `TrainState` (carry, controller state, loss trace) lands in
`ckpt_dir/step_XXXXXXXX/`, on a cycle boundary on the macro executor and
every `ckpt_every` steps on the per-step one; `resume_from` continues from
one with the uninterrupted run's numbers bit for bit, and the returned loss
trace is the whole run's. A TrainState keeps the strategy's membership mask
(elastic membership, resilience/), and a resume sets it again.

Across processes (`distributed=True`, launch/distributed.py): the run is
placed over the process group that `launch.distributed.initialize` joined,
each process holding its block of replica rows of the topology
(`topology` is required); every cross-replica reduction runs the
order-fixed chain (`DasoConfig.deterministic_reduce`), process 0 alone
logs and writes checkpoints (gathered from every process), a resume keeps
each process's rows, and the numbers are the one-process run's bit for
bit. `health` (resilience/runtime.py::HealthMonitor) hears of each cycle.

`exchange_impl="per_leaf"` runs the outer exchange leaf by leaf
(core/daso.py); `autotune` probes each level's sync on the device before
the first step and retunes the schedule (`startup_probe`).

Runs on CUDA unless `device="cpu"`, and raises without CUDA.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.checkpoint.io import (TrainState, fit_tree, load_train_state,
                                       save_train_state)
from repro_torch.core.compression import transfer_bytes
from repro_torch.core.daso import DasoConfig
from repro_torch.core.executor import (MacroCycleExecutor, get_strategy, list_strategies,
                                       make_strategy, run_compiled_training)
from repro_torch.core.simulator import SimResult, run_per_step_training
from repro_torch.device import resolve_device
from repro_torch.optim.optimizers import Optimizer, sgd
from repro_torch.optim.schedules import constant_lr
from repro_torch.topo import TopologySpec, build_topology_strategy
from repro_torch.topo import probe as topo_probe
from repro_torch.tree import leaves, tree_map


@dataclass
class TrainLoopConfig:
    # registered name: daso | hier_daso | sync | local_sgd | gossip | easgd |
    # downpour
    strategy: str = "daso"
    n_steps: int = 200
    n_replicas: int = 4               # paper "nodes"
    local_world: int = 4              # paper GPUs per node
    b_max: int = 4
    # N-level cluster topology (repro_torch/topo): a spec string ("chip:4 x
    # host:2 x pod:2"), inline JSON or a JSON file path. When set it
    # supersedes n_replicas / local_world (from the level fanouts) and, for
    # daso / hier_daso, selects the per-level sync schedule: a 2-level spec
    # lowers to the stock daso strategy (the legacy run bit for bit), a
    # deeper one to hier_daso. gossip / easgd / downpour take a 2-level spec
    # for sizing only
    topology: Optional[str] = None
    warmup_frac: float = 0.1          # warm-up epochs as a step fraction
    cooldown_frac: float = 0.1
    lr: float = 0.05
    loss_window: int = 20
    executor: str = "macro"           # macro | per_step
    max_cycle_len: int = 32           # cap on a macro-cycle's length
    # wire tier of the global exchange: None derives bf16 / f32 per phase,
    # "f32" | "bf16" | "int8" forces one tier for both
    wire_format: Optional[str] = None
    # "per_leaf": the outer exchange leaf by leaf (one K3 / K2 launch and,
    # across processes, one gather per leaf), bit for bit the fused one
    exchange_impl: str = "fused"
    # "one_cycle": the double-buffered overlap schedule (core/daso.py
    # daso_overlap_step), each exchange merged one cycle stale
    overlap: str = "off"
    # the macro executor waits for each overlap exchange before the cycle's
    # local steps: the same numbers, and the exchange's own time
    overlap_serial_exchange: bool = False
    # checkpoints: every `ckpt_every` steps (0 = off) a TrainState lands in
    # `ckpt_dir/step_XXXXXXXX/`; `resume_from` names one such directory
    ckpt_every: int = 0
    ckpt_dir: Optional[str] = None
    resume_from: Optional[str] = None
    device: str = "cuda"
    # the multi-process runtime (launch/distributed.py): place the run over
    # the process group that `launch.distributed.initialize` joined, one
    # block of replica rows per process; needs `topology`. With one process
    # this is the oracle the N-process run gives bit for bit
    distributed: bool = False
    # self-tuning (topo/probe.py): time one real sync per level on the
    # device at startup and retune the lowered schedule against the spec's
    # annotations (`controller.retune`; costs equal to them change
    # nothing). `autotune_every` is the probe cadence in cycles of the
    # supervised fault path (resilience/supervisor.py); this loop probes
    # once
    autotune: bool = False
    autotune_every: int = 8


# strategies that take a topology spec for sizing only (replica count, world
# size, the outer sync period), with no per-level sync schedule
# (core/baselines.py; a spec with intermediate levels is refused for them)
_FLAT_TOPOLOGY_STRATEGIES = ("gossip", "easgd", "downpour")


def resolve_topology(cfg: TrainLoopConfig) -> Optional[TopologySpec]:
    """The run's `TopologySpec`, or None when cfg.topology is unset. Checks
    that the strategy takes one."""
    if cfg.topology is None:
        return None
    if cfg.strategy not in ("daso", "hier_daso") + _FLAT_TOPOLOGY_STRATEGIES:
        raise ValueError(f"topology specs drive the replica-axis strategies "
                         f"(daso / hier_daso / gossip / easgd / downpour); "
                         f"strategy {cfg.strategy!r} does not take one")
    return TopologySpec.load(cfg.topology)


def build_strategy(loss_fn: Callable, cfg: TrainLoopConfig, optimizer: Optimizer):
    """cfg.strategy through the registry, with its DasoConfig and
    controller for the replica-axis strategies. With cfg.topology set the
    strategy is lowered from the spec (`topo.build_topology_strategy`): R,
    the Eq. (1) world P and a pinned outer ``%period`` (b_max) come from
    the spec, intermediate levels get their periods, and the plateau
    controller drives the outermost level. gossip / easgd / downpour take
    R, P and b_max from a 2-level spec and refuse a deeper one."""
    if cfg.strategy not in list_strategies():
        raise KeyError(f"unknown strategy {cfg.strategy!r}; "
                       f"registered: {list_strategies()}")
    if cfg.strategy == "sync":
        if cfg.topology is not None:
            resolve_topology(cfg)  # raises with the explanation
        if cfg.overlap != "off":
            raise ValueError("overlap is a daso-family schedule; the sync "
                             "baseline has no non-blocking exchange to overlap")
        return make_strategy("sync", loss_fn, optimizer)
    spec = resolve_topology(cfg)
    dcfg = DasoConfig(
        n_replicas=cfg.n_replicas if spec is None else spec.n_replicas,
        global_world=cfg.n_replicas * cfg.local_world if spec is None else spec.world,
        b_max=cfg.b_max if spec is None or spec.outer.period is None else spec.outer.period,
        warmup_steps=int(cfg.warmup_frac * cfg.n_steps),
        cooldown_steps=int(cfg.cooldown_frac * cfg.n_steps),
        total_steps=cfg.n_steps,
        wire_format=cfg.wire_format,
        exchange_impl=cfg.exchange_impl,
        overlap=cfg.overlap,
        # a distributed run takes the chain of adds for the loss's replica
        # mean too, as the reference's does
        deterministic_reduce=cfg.distributed)
    if spec is not None and cfg.strategy not in _FLAT_TOPOLOGY_STRATEGIES:
        return build_topology_strategy(loss_fn, optimizer, spec, dcfg,
                                       loss_window=cfg.loss_window)
    if spec is not None and tuple(spec.inner_names()):
        raise ValueError(
            f"strategy {cfg.strategy!r} has no per-level sync schedule; "
            f"topology spec carries intermediate levels "
            f"{tuple(spec.inner_names())} — use a 2-level spec, or "
            f"daso/hier_daso for hierarchical syncing")
    if cfg.strategy == "hier_daso":
        raise ValueError("strategy 'hier_daso' needs a topology spec "
                         "(TrainLoopConfig.topology / --topology)")
    cls = get_strategy(cfg.strategy)
    controller = cls.make_controller(dcfg, loss_window=cfg.loss_window)
    return cls(loss_fn, optimizer, dcfg, controller=controller)


def ckpt_step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def make_placement(cfg: TrainLoopConfig):
    """The run's `ProcessPlacement` over the joined process group (one
    process without one), or None unless `cfg.distributed`."""
    if not cfg.distributed:
        return None
    spec = resolve_topology(cfg)
    if spec is None:
        raise ValueError("distributed runs place the replica axis of the topology; "
                         "set TrainLoopConfig.topology (--topology)")
    from repro_torch.launch.distributed import ProcessPlacement
    return ProcessPlacement(spec, device=cfg.device)


def save_placed_train_state(placement, path: str, state: TrainState) -> None:
    """Save a TrainState whose carry holds this process's rows: gathered on
    every process (collective), written by process 0 alone. Without a
    placement, `save_train_state`."""
    if placement is not None:
        state.carry = placement.fetch(state.carry)
        if not placement.is_coordinator:
            return
    save_train_state(path, state)


def wire_summary(dcfg: DasoConfig, params) -> str:
    """The wire tier of the cycling and blocking exchanges, and the bytes one
    exchange of one replica's params puts on the wire at each."""
    tiers = [dcfg.wire_format_for(blocking=b) for b in (False, True)]
    nbytes = [transfer_bytes(params, wire_format=t, int8_block=dcfg.int8_block)
              for t in tiers]
    return (f"wire(cycling/blocking)={tiers[0]}/{tiers[1]} "
            f"bytes_per_exchange={nbytes[0]}/{nbytes[1]} overlap={dcfg.overlap}")


def startup_probe(cfg: TrainLoopConfig, strategy, device, log) -> None:
    """`cfg.autotune`'s probe before the first step: `active_probe` on
    `device`, then `retune` against `annotated_level_costs` of the probe's
    payload. Without a topology there is nothing to probe; under
    `cfg.distributed` it is skipped, as in the reference: wall-clock probes
    of separate processes could disagree and split the schedule (the
    supervised path's cost model is deterministic)."""
    spec = resolve_topology(cfg)
    if spec is None or strategy.controller is None:
        if log is not None:
            log("[train] autotune: no topology spec to probe; "
                "schedule left as configured")
        return
    if cfg.distributed:
        if log is not None:
            log("[train] autotune: startup wall-clock probe skipped "
                "under --distributed (see docs/tuning.md)")
        return
    pr = topo_probe.active_probe(spec, device=device)
    changed = strategy.controller.retune(
        pr.costs, annotated=topo_probe.annotated_level_costs(spec, pr.param_bytes))
    if log is not None:
        periods = getattr(strategy.controller, "inner_periods", {})
        log(f"[train] autotune probe: measured "
            f"{ {k: round(v * 1e6, 1) for k, v in pr.costs.items()} }"
            f" us/sync -> retuned={changed} b={strategy.controller.b}"
            f" inner_periods={periods}")


def run_training(loss_fn: Callable, params0, data_fn: Callable,
                 cfg: TrainLoopConfig, *, optimizer: Optional[Optimizer] = None,
                 lr_fn: Optional[Callable] = None,
                 log: Optional[Callable] = print, tracer=None,
                 health=None) -> SimResult:
    """data_fn(step) -> batch on cfg.device. For the daso strategy the batch
    carries the leading replica axis; for sync it is flat. params0 must
    already be on cfg.device. On resume (`cfg.resume_from`) the returned
    loss trace is the whole run's: the checkpoint's losses, then this
    run's.

    `tracer` (obs.trace.Tracer) takes the run's events: the macro executor's
    cycle, overlap and checkpoint spans and the controller's decision
    events (launch/train.py wires it from --trace-out). The per-step path
    is left untraced, as in the reference: it is the numbers' oracle, not
    a surface to measure.

    `cfg.distributed` places the run over the process group (the module
    docstring); `result.carry` is then this process's rows. `health`
    (resilience.runtime.HealthMonitor) hears of each macro cycle, for
    supervised multi-process runs (launch/train.py wires it)."""
    device = resolve_device(cfg.device)
    if cfg.executor not in ("macro", "per_step"):
        raise ValueError(f"unknown executor {cfg.executor!r}; "
                         "expected 'macro' or 'per_step'")
    if health is not None and cfg.executor != "macro":
        raise ValueError("live supervision (health monitor) reports progress from "
                         "the macro executor's cycles; run supervised jobs with "
                         "executor='macro'")
    for x in leaves(params0):
        if x.device.type != device.type:
            raise ValueError(f"run_training on {device}, params on {x.device}")
    optimizer = optimizer or sgd(momentum=0.9, weight_decay=1e-4)
    lr_fn = lr_fn or constant_lr(cfg.lr)
    strategy = build_strategy(loss_fn, cfg, optimizer)
    if tracer is not None and strategy.controller is not None:
        strategy.controller.tracer = tracer
    if cfg.autotune:
        startup_probe(cfg, strategy, device, log)
    overlap = cfg.overlap if cfg.strategy != "sync" else "off"
    placement = make_placement(cfg)
    if placement is not None:
        strategy.set_placement(placement)
        if not placement.is_coordinator:
            log = None  # one process speaks for the group

    # the loaded carry, handed over by `loaded.pop()` in the call, so that no
    # frame here keeps it alive once the executor has stepped past it
    start_step, loaded, prior_losses = 0, [], []
    if cfg.resume_from:
        # fallback: a crash mid-save leaves the newest snapshot torn; resume
        # from the newest intact sibling instead
        ts = load_train_state(cfg.resume_from, device=device, expect_overlap=overlap,
                              fallback=True, placement=placement)
        if ts.strategy != cfg.strategy:
            raise ValueError(f"checkpoint was written by strategy {ts.strategy!r}, "
                             f"run requests {cfg.strategy!r}")
        start_step, prior_losses = ts.step, list(ts.losses)
        # held to this run's carry, built on the meta device (no memory), so
        # a shape that differs raises and empty containers come back
        like = strategy.init_carry(tree_map(lambda x: x.to("meta"), params0))
        if placement is not None:
            like = placement.put_carry(like)
        loaded.append(fit_tree(like, ts.carry, "carry/", what="this run's carry"))
        if ts.controller is not None and strategy.controller is not None:
            strategy.controller.load_state_dict(ts.controller)
        if ts.membership is not None and hasattr(strategy, "set_membership"):
            strategy.set_membership(ts.membership)
        del ts
        if log is not None:
            log(f"[train] resumed from {cfg.resume_from} at step {start_step}")

    ckpt_cb = None
    if cfg.ckpt_every and cfg.ckpt_dir:
        def ckpt_cb(step, cur_carry, seg_losses):
            save_placed_train_state(placement, ckpt_step_dir(cfg.ckpt_dir, step), TrainState(
                step=step, carry=cur_carry,
                controller=(strategy.controller.state_dict()
                            if strategy.controller is not None else None),
                membership=(list(strategy.membership)
                            if getattr(strategy, "membership", None) is not None
                            else None),
                strategy=cfg.strategy, overlap=overlap,
                losses=prior_losses + seg_losses))

    t0 = time.time()
    if cfg.executor == "per_step":
        result = run_per_step_training(
            strategy, params0, data_fn, lr_fn, cfg.n_steps, start_step=start_step,
            carry=loaded.pop() if loaded else None, ckpt_every=cfg.ckpt_every,
            ckpt_cb=ckpt_cb, placement=placement)
    else:
        executor = MacroCycleExecutor(strategy, max_cycle_len=cfg.max_cycle_len,
                                      serial_exchange=cfg.overlap_serial_exchange,
                                      tracer=tracer, placement=placement, health=health)
        result = run_compiled_training(
            strategy, params0, data_fn, lr_fn, cfg.n_steps, executor=executor,
            start_step=start_step, carry=loaded.pop() if loaded else None,
            ckpt_every=cfg.ckpt_every, ckpt_cb=ckpt_cb)
    if prior_losses:
        result.losses = prior_losses + result.losses
    if log is not None:
        stats = result.executor_stats
        disp = (f" dispatches={stats.dispatches}/{cfg.n_steps}"
                if stats is not None else "")
        wire = ("" if cfg.strategy == "sync" else
                f" wire={cfg.wire_format or 'auto'}/{cfg.exchange_impl} "
                + wire_summary(strategy.cfg, params0))
        log(f"[train] strategy={cfg.strategy} steps={cfg.n_steps} "
            f"final_loss={result.final_loss:.4f} "
            f"sync_frac={result.sync_fraction:.3f} wall={time.time() - t0:.1f}s"
            f"{disp}{wire} device={device}")
    return result
