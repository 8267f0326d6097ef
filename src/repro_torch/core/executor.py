"""Strategy registry and the macro-cycle executor (`repro/core/executor.py`).

Every training strategy offers one interface to the training loop: its
carry, a factory of step variants ``step(carry, batch, lr) -> (carry,
metrics)`` cached per (mode, staleness), a per-step mode decision and a
cycle planner. Registered here: `daso`, `sync` and `local_sgd`;
core/baselines.py registers `gossip`, `easgd` and `downpour` (imported at
the end of this module) and repro_torch/topo/strategy.py `hier_daso`.

The macro-cycle executor runs one controller cycle per host dispatch:

  * the controller plans a cycle, the exact (mode, staleness) sequence the
    per-step path would run, cut where loss feedback could change the
    schedule (`DasoController.plan_cycle`), so the loss is fetched to the
    host once per cycle instead of once per step;
  * `MacroCycleExecutor` builds one program per distinct cycle shape and
    caches it by shape. A program is a Python function that runs the
    cycle's step variants on the device in order, batch i and lrs[i] for
    step i, and stacks their metrics there: nothing in it waits for the
    device. (The reference compiles the cycle into one XLA program; a CUDA
    graph of it is a later speed item.) A shape seen only at the end of
    a run runs step by step instead (the tail fallback);
  * an overlap cycle (`DasoStrategy.overlap_cycle`: local steps ending in an
    ov_sync) runs as three parts: the exchange of the pending snapshot on
    the executor's own CUDA stream, the cycle's local steps on the current
    stream meanwhile, then the stale Eq. (1) merge once both are done. On
    the CPU the three run one after the other, with the same numbers.

With a tracer (obs/trace.py) the executor writes the reference's events:
a `cycle` span per dispatched cycle (its steps and per-level sync counts),
`compile` and `invalidate` instants, the overlap legs' spans and a
`checkpoint_save` span per save. Each span that times device work ends on
a wait the untraced path has anyway (the metrics' copy to the host, a
stream's synchronize, the save's copies off the card), so tracing adds no
synchronisation and changes no number.

Across processes (`placement=`, `launch/distributed.py::ProcessPlacement`)
the carry and the staged batches hold this process's replica rows, the
strategy's step variants gather what they reduce, and each cycle's
per-replica metrics are gathered once, at the fetch, and reduced there
(`Strategy.reduce_metrics`). An overlap cycle's exchange is waited for
before its local steps under ``dispatch="serial"``, and runs on a helper
thread beside them under ``"overlap"``. `health` (resilience/runtime.py)
hears of every completed cycle.

Functions that run a cycle take the carry in a one-element list and empty
it, so no caller's frame keeps the old carry alive while the cycle writes a
new one (the reference donates the carry's buffers to XLA); the per-step
path holds two carries at a time, and so does a cycle.
"""
from __future__ import annotations

import difflib
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import flatbuf
from repro_torch.core.daso import (AUX_ROWS, DasoConfig, _cross_replica_loss,
                                   daso_overlap_compute_step, daso_overlap_step,
                                   daso_train_step, dereplicate_params, global_receive,
                                   global_send, normalize_group_perm, reduce_step_metrics,
                                   replica_divergence, replicate_params, sync_train_step)
from repro_torch.core.schedule import DasoController, Mode, join_mode, split_mode, split_ov
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.optim.optimizers import Optimizer
from repro_torch.tree import leaves, tree_map

# The static fingerprint of a macro-cycle: one (mode, staleness) pair per
# step. Distinct shapes build distinct programs.
CycleShape = Tuple[Tuple[str, int], ...]

# Mode-token prefix of the compute half of an overlap cycle ("ovc:local").
# These tokens exist only in OverlapCycle.compute_shape: the controller
# never emits them.
OVERLAP_COMPUTE_PREFIX = "ovc:"


@dataclass(frozen=True)
class OverlapCycle:
    """How to run one overlap cycle: the exchange of the pending snapshot,
    the compute steps of `compute_shape` while it is in flight, then the
    merge of its result by Eq. (1) with S = staleness + extra_staleness."""
    compute_shape: CycleShape
    staleness: int
    extra_staleness: int


@dataclass(frozen=True)
class CyclePlan:
    """A planned macro-cycle: `shape[i]` is the (mode, staleness) of
    training step `start_step + i`."""
    start_step: int
    shape: CycleShape

    def __len__(self) -> int:
        return len(self.shape)


# -- strategy registry -----------------------------------------------------------

_REGISTRY: Dict[str, type] = {}


def register_strategy(name: str):
    """Class decorator: register a Strategy subclass under `name`."""
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_strategy(name: str) -> type:
    try:
        return _REGISTRY[name]
    except KeyError:
        hint = difflib.get_close_matches(name, _REGISTRY, n=1)
        suggest = f"; did you mean {hint[0]!r}?" if hint else ""
        raise KeyError(f"unknown strategy {name!r}; registered: "
                       f"{sorted(_REGISTRY)}{suggest}") from None


def list_strategies() -> List[str]:
    return sorted(_REGISTRY)


def make_strategy(name: str, loss_fn: Callable, optimizer: Optimizer,
                  cfg: Optional[DasoConfig] = None, **kw) -> "Strategy":
    return get_strategy(name)(loss_fn, optimizer, cfg, **kw)


class Strategy:
    """Carry lifecycle, cached step variants, the per-step schedule and the
    cycle planner. `n_micro` splits each batch for gradient accumulation
    (core/daso.py::microbatched_value_and_grad); the topology lowering
    passes it (topo/lower.py::build_topology_strategy)."""
    name = "?"

    def __init__(self, loss_fn: Callable, optimizer: Optimizer,
                 cfg: Optional[DasoConfig] = None, *,
                 controller: Optional[DasoController] = None, n_micro: int = 1):
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.cfg = cfg
        self.n_micro = n_micro
        self.controller = controller or (DasoController(cfg) if cfg else None)
        self._steps: Dict[Tuple[str, int], Callable] = {}
        # launch/distributed.py::ProcessPlacement, or None in one process
        self.placement = None

    def init_carry(self, params0):
        raise NotImplementedError

    def finalize_params(self, carry):
        raise NotImplementedError

    def step_fn(self, mode: str, staleness: int) -> Callable:
        key = (mode, staleness)
        if key not in self._steps:
            self._steps[key] = self.build_step(mode, staleness)
        return self._steps[key]

    def build_step(self, mode: str, staleness: int) -> Callable:
        raise NotImplementedError

    def plan_cycle(self, step: int, max_len: int) -> CyclePlan:
        raise NotImplementedError

    def next_mode(self, step: int) -> Tuple[str, int]:
        """The (mode, staleness) of `step`; consumed once per step, in
        order, giving the sequence `plan_cycle` would plan."""
        raise NotImplementedError

    def observe(self, losses: List[float]) -> None:
        """Feed per-step losses (in step order) back to the scheduler."""
        if self.controller is not None:
            for loss in losses:
                self.controller.observe_loss(loss)

    def sync_fraction(self) -> float:
        return (self.controller.global_sync_fraction()
                if self.controller is not None else 1.0)

    def divergence(self, carry) -> Optional[float]:
        return None

    def set_placement(self, placement) -> None:
        """Run the step variants on one process's replica rows
        (`launch/distributed.py::ProcessPlacement`; None: every row). The
        placement is part of every step variant, so this drops the cached
        ones; an executor's programs must be rebuilt too (the executor's
        own `placement` setter does both)."""
        if placement is not None:
            raise ValueError(f"strategy {self.name!r} has no replica axis to "
                             "place across processes")
        self.placement = None

    def reduce_metrics(self, metrics: dict) -> dict:
        """A placed cycle's gathered per-replica metrics -> the per-step
        metrics of the one-process run."""
        return metrics

    @classmethod
    def make_controller(cls, cfg: Optional[DasoConfig], *, loss_window: int = 50):
        return (DasoController(cfg, loss_window=loss_window)
                if cfg is not None else None)


@register_strategy("daso")
class DasoStrategy(Strategy):
    """The paper's strategy: carry (params_R, opt_R, inflight) with the
    replica axis R leading every leaf, controller-planned cycles, step
    variants from core/daso.py. Under the overlap schedule the carry has a
    fourth slot, the pending snapshot: (params_R, opt_R, inflight, pending).
    `membership` (a 0/1 mask over the replicas) is baked into every step
    variant (elastic membership, core/daso.py)."""

    def __init__(self, loss_fn, optimizer, cfg, *, membership=None, **kw):
        if cfg is None:
            raise ValueError("the daso strategy needs a DasoConfig")
        super().__init__(loss_fn, optimizer, cfg, **kw)
        self._membership = flatbuf.normalize_membership(membership, cfg.n_replicas)
        self._group_perm = None

    @property
    def membership(self):
        """The active-replica mask as a 0/1 tuple, or None when every
        replica is active."""
        return self._membership

    def n_active(self) -> int:
        return (self.cfg.n_replicas if self._membership is None
                else int(sum(self._membership)))

    def set_membership(self, mask) -> None:
        """Change the active-replica set. The mask is part of every step
        variant, so this drops the cached variants; the caller must
        `invalidate()` an executor whose programs run the old ones (the
        resilience supervisor does both)."""
        self._membership = flatbuf.normalize_membership(mask, self.cfg.n_replicas)
        self._steps.clear()

    @property
    def group_perm(self):
        """The replica regrouping of the inner-level syncs (None: the
        contiguous groups)."""
        return self._group_perm

    def set_placement(self, placement) -> None:
        if placement is not None and placement.n_replicas != self.cfg.n_replicas:
            raise ValueError(f"placement of {placement.n_replicas} replicas for a "
                             f"strategy of {self.cfg.n_replicas}")
        self.placement = placement
        self._steps.clear()

    def reduce_metrics(self, metrics):
        return reduce_step_metrics(self.cfg, self._membership, self.n_active(), metrics)

    def set_group_permutation(self, perm) -> None:
        """Regroup the replicas of every inner sync: slot i of the new
        grouping holds replica perm[i] (core/daso.py::
        normalize_group_perm). The permutation is part of every step
        variant, so this drops the cached variants; the caller must
        `invalidate()` an executor whose programs run the old ones."""
        self._group_perm = normalize_group_perm(perm, self.cfg.n_replicas)
        self._steps.clear()

    @property
    def overlap(self) -> bool:
        """True under the double-buffered overlap schedule (4-slot carry,
        OV_MODES tokens)."""
        return self.cfg.overlap != "off"

    def init_carry(self, params0):
        params = replicate_params(params0, self.cfg.n_replicas)
        opt_state = replicate_params(self.optimizer.init(params0),
                                     self.cfg.n_replicas)
        # the in-flight buffer is read only after a send has written it, the
        # pending snapshot only after an ov_start: both start as the params
        # themselves (no step writes into its inputs)
        if self.overlap:
            return (params, opt_state, params, params)
        return (params, opt_state, params)

    def finalize_params(self, carry):
        # under elastic membership row 0 may be a dropped replica's frozen
        # ghost: the first active replica's params instead (broadcast from
        # the process that owns it, across processes)
        idx = 0 if self._membership is None else self._membership.index(1.0)
        if self.placement is not None:
            return self.placement.row(carry[0], idx)
        return dereplicate_params(carry[0], index=idx)

    def _inner_syncs_of(self, inner: Tuple[str, ...]):
        """The (name, group_size) pairs of a mode's inner levels: none, as
        this strategy has no topology (`hier_daso` maps them)."""
        if inner:
            raise ValueError(f"mode carries inner-level syncs {inner!r} but "
                             f"strategy {self.name!r} has no topology")
        return ()

    def build_step(self, mode, staleness):
        if mode.startswith(OVERLAP_COMPUTE_PREFIX):
            # the compute half of an overlap cycle: 2-slot carry, nothing
            # across replicas (the loss reduction is deferred to the merge)
            _, inner = split_mode(mode[len(OVERLAP_COMPUTE_PREFIX):])
            raw_c = daso_overlap_compute_step(self.loss_fn, self.optimizer, self.cfg,
                                              n_micro=self.n_micro,
                                              membership=self._membership,
                                              inner_syncs=self._inner_syncs_of(inner),
                                              group_perm=self._group_perm,
                                              placement=self.placement)

            def cstep(carry, batch, lr):
                params, opt_state = carry
                params, opt_state, m = raw_c(params, opt_state, batch, lr)
                return (params, opt_state), m

            return cstep
        outer, inner = split_mode(mode)
        inner_syncs = self._inner_syncs_of(inner)
        if self.overlap:
            base, extra = split_ov(outer)
            raw_ov = daso_overlap_step(self.loss_fn, self.optimizer, self.cfg, mode=base,
                                       staleness=staleness, extra_staleness=extra,
                                       n_micro=self.n_micro, membership=self._membership,
                                       inner_syncs=inner_syncs,
                                       group_perm=self._group_perm,
                                       placement=self.placement)

            def ostep(carry, batch, lr):
                params, opt_state, inflight, pending = carry
                params, opt_state, inflight, pending, m = raw_ov(
                    params, opt_state, inflight, pending, batch, lr)
                return (params, opt_state, inflight, pending), m

            return ostep
        raw = daso_train_step(self.loss_fn, self.optimizer, self.cfg, mode=outer,
                              staleness=staleness, n_micro=self.n_micro,
                              membership=self._membership, inner_syncs=inner_syncs,
                              group_perm=self._group_perm, placement=self.placement)

        def step(carry, batch, lr):
            params, opt_state, inflight = carry
            params, opt_state, inflight, m = raw(params, opt_state, inflight,
                                                 batch, lr)
            return (params, opt_state, inflight), m

        return step

    def overlap_cycle(self, shape: CycleShape) -> Optional[OverlapCycle]:
        """How to run `shape` as an overlap cycle, or None when it runs as
        an ordinary program: only a run of local steps ending in one ov_sync
        has an exchange to hide (blocking phases, the lone ov_start and
        window-cut all-local cycles do not)."""
        if not self.overlap or not shape:
            return None
        base, extra = split_ov(split_mode(shape[-1][0])[0])
        if base != Mode.OV_SYNC:
            return None
        if any(split_mode(mode)[0] != Mode.LOCAL for mode, _ in shape[:-1]):
            return None
        compute_shape = tuple(
            (OVERLAP_COMPUTE_PREFIX + join_mode(Mode.LOCAL, split_mode(mode)[1]), 1)
            for mode, _ in shape)
        return OverlapCycle(compute_shape=compute_shape, staleness=shape[-1][1],
                            extra_staleness=extra)

    def overlap_exchange_fn(self):
        """pending -> inflight: the one outer exchange of an overlap cycle,
        at the cycling phase's wire tier, over the active replicas."""
        cfg, mask, placement = self.cfg, self._membership, self.placement

        def exchange(pending):
            return global_send(pending, wire_format=cfg.wire_format_for(blocking=False),
                               int8_block=cfg.int8_block, mask=mask, placement=placement)

        return exchange

    def overlap_merge_fn(self, staleness: int, extra_staleness: int):
        """(params, inflight, loss_per_replica (L, R)) -> (merged params,
        per-step loss (L,)): Eq. (1) through K2 with S = staleness +
        extra_staleness and the world P_eff of the active replicas, and the
        loss reduction the compute steps deferred, row by row as the
        per-step path reduces it. Placed, the loss is None: the cycle's fetch
        reduces it (`reduce_metrics`)."""
        cfg, mask, n_active = self.cfg, self._membership, self.n_active()
        placement = self.placement
        p_eff = (cfg.global_world if mask is None
                 else cfg.global_world * n_active / cfg.n_replicas)

        def merge(params, inflight, loss_r):
            params = global_receive(params, inflight, staleness=staleness,
                                    extra_staleness=extra_staleness,
                                    global_world=p_eff, mask=mask, placement=placement)
            if placement is not None:
                return params, None
            return params, _cross_replica_loss(cfg, mask, n_active, loss_r, axis=1)

        return merge

    def plan_cycle(self, step, max_len):
        return CyclePlan(step, self.controller.plan_cycle(step, max_len))

    def next_mode(self, step):
        return self.controller.mode_for_step(step)

    def divergence(self, carry):
        return float(replica_divergence(carry[0], self.placement))


@register_strategy("sync")
class SyncStrategy(Strategy):
    """Horovod-analog baseline: flat data parallelism, no replica axis.
    Every step is the same variant, so cycles are fixed-length chunks."""

    default_cycle_len = 8

    def init_carry(self, params0):
        return (params0, self.optimizer.init(params0))

    def finalize_params(self, carry):
        return carry[0]

    def build_step(self, mode, staleness):
        raw = sync_train_step(self.loss_fn, self.optimizer, self.n_micro)

        def step(carry, batch, lr):
            params, opt_state = carry
            params, opt_state, m = raw(params, opt_state, batch, lr)
            return (params, opt_state), m

        return step

    def plan_cycle(self, step, max_len):
        n = max(1, min(max_len, self.default_cycle_len))
        return CyclePlan(step, (("sync", 1),) * n)

    def next_mode(self, step):
        return ("sync", 1)

    def observe(self, losses):
        pass

    def sync_fraction(self):
        return 1.0


@register_strategy("local_sgd")
class LocalSGDStrategy(DasoStrategy):
    """Ablation: a plain parameter average (hard_avg) every b_max steps, no
    Eq. (1) staleness weighting, no plateau schedule."""

    def _mode_at(self, step: int) -> str:
        return Mode.HARD_AVG if step % max(1, self.cfg.b_max) == 0 else Mode.LOCAL

    def plan_cycle(self, step, max_len):
        b = max(1, self.cfg.b_max)
        shape = []
        while len(shape) < max_len:
            t = step + len(shape)
            if shape and t % b == 0:
                break  # the next hard_avg starts the next cycle
            shape.append(self.next_mode(t))
        return CyclePlan(step, tuple(shape))

    def next_mode(self, step):
        mode = self._mode_at(step)
        self.controller.history.append((step, mode, self.controller.b,
                                        self.controller.w))
        return (mode, 1)


# -- the executor ----------------------------------------------------------------

@dataclass
class ExecutorStats:
    dispatches: int = 0        # programs run (an overlap cycle runs three)
    steps: int = 0             # training steps covered by those programs
    cycles: int = 0            # macro-cycles run as programs
    compiles: int = 0          # programs built, one per distinct cycle shape
    fallback_steps: int = 0    # steps run by the tail fallback, one by one
    invalidations: int = 0     # cache flushes
    # overlap cycles, host clock; every leg ends where the host has waited
    # for the stream it times, and consecutive legs share their boundary, so
    # compute + visible (or blocking) + merge == wall
    overlap_cycles: int = 0
    overlap_compute_s: float = 0.0      # until the local steps are done
    # the wait for the exchange after the local steps are done: the part of
    # the exchange the local steps did not hide
    overlap_exchange_visible_s: float = 0.0
    # the exchange alone, waited for before the local steps start
    # (serial_exchange=True): the baseline of the hidden fraction
    overlap_exchange_blocking_s: float = 0.0
    overlap_merge_s: float = 0.0        # the stale Eq. (1) merge
    overlap_wall_s: float = 0.0

    def dispatches_per_step(self) -> float:
        total = self.steps + self.fallback_steps
        return self.dispatches / total if total else 0.0


def _group_runs(shape: CycleShape) -> List[Tuple[str, int, int, int]]:
    """Consecutive identical (mode, staleness) pairs grouped into
    (mode, staleness, offset, length) runs."""
    runs: List[Tuple[str, int, int, int]] = []
    for i, (mode, stale) in enumerate(shape):
        if runs and runs[-1][0] == mode and runs[-1][1] == stale:
            mode_, stale_, off, k = runs[-1]
            runs[-1] = (mode_, stale_, off, k + 1)
        else:
            runs.append((mode, stale, i, 1))
    return runs


def _stack_metrics(chunks: List[dict]) -> dict:
    """Per-step metric dicts -> one dict of (L, ...) tensors, on the device."""
    return {k: torch.stack([m[k] for m in chunks]) for k in chunks[0]}


def _step_batch(batches, i: int):
    return tree_map(lambda x: x[i], batches)


def _device_of(tree) -> torch.device:
    """The device of a tree's first leaf."""
    return leaves(tree)[0].device


class MacroCycleExecutor:
    """Runs planned cycles as programs, one per distinct `CycleShape`,
    cached in `_programs`; an overlap cycle runs its exchange on
    `exchange_stream`, a CUDA stream the executor owns (made at the first
    overlap cycle on the card). `tracer` takes the run's events; the
    default `NULL_TRACER` keeps every call site free of branches.
    `placement` runs the cycles on one process's replica rows (the
    strategy's step variants take it too), `health` hears of each
    completed cycle."""

    def __init__(self, strategy: Strategy, *, max_cycle_len: int = 32,
                 serial_exchange: bool = False, tracer=None, placement=None,
                 health=None):
        self.strategy = strategy
        self.max_cycle_len = max_cycle_len
        # wait for the exchange before the local steps start: the same
        # numbers, and overlap_exchange_blocking_s measures the exchange
        self.serial_exchange = serial_exchange
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.health = health
        self.stats = ExecutorStats()
        self.exchange_stream: Optional[torch.cuda.Stream] = None
        self._programs: Dict[CycleShape, Callable] = {}
        # the tail fallback's step variants, by (mode, staleness)
        self._per_step: Dict[Tuple[str, int], Callable] = {}
        # the overlap exchange ("exchange") and merges (("merge", S, E))
        self._ov_fns: Dict[object, Callable] = {}
        if placement is not None:
            self.placement = placement

    @property
    def placement(self):
        """The strategy's placement: the executor runs what its step
        variants are built for."""
        return self.strategy.placement

    @placement.setter
    def placement(self, placement) -> None:
        """Bind the strategy to `placement`; programs built for the previous
        one are dropped."""
        self.strategy.set_placement(placement)
        self._programs.clear()
        self._per_step.clear()
        self._ov_fns.clear()

    @property
    def cached_shapes(self) -> List[CycleShape]:
        return list(self._programs)

    def program_for(self, shape: CycleShape) -> Callable:
        if shape not in self._programs:
            self._programs[shape] = self._build_program(shape)
            self.stats.compiles += 1
            self.tracer.instant("compile", cat="executor", shape_len=len(shape),
                                modes=[m for m, _ in shape])
        return self._programs[shape]

    def invalidate(self) -> int:
        """Drop every cached program and overlap part, so later cycles use
        the strategy's current step variants. Returns how many were
        dropped. Its callers swap the strategy's step variants: after
        `DasoStrategy.set_group_permutation`, and the resilience supervisor
        (resilience/supervisor.py) when the membership changes."""
        n = len(self._programs) + len(self._per_step) + len(self._ov_fns)
        self._programs.clear()
        self._per_step.clear()
        self._ov_fns.clear()
        self.stats.invalidations += 1
        self.tracer.instant("invalidate", cat="executor", dropped=n)
        return n

    def _build_program(self, shape: CycleShape) -> Callable:
        runs = _group_runs(shape)

        def program(slot, batches, lrs):
            """([carry], batches (L, ...), lrs (L,)) -> (carry, metrics
            (L, ...)), the slot emptied."""
            carry = slot.pop()
            chunks = []
            for mode, stale, off, k in runs:
                fn = self.strategy.step_fn(mode, stale)
                for i in range(off, off + k):
                    carry, m = fn(carry, _step_batch(batches, i), lrs[i])
                    chunks.append(m)
            return carry, _stack_metrics(chunks)

        return program

    def run_cycle(self, slot: list, plan: CyclePlan, batches, lrs, *,
                  is_tail: bool = False):
        """Run one macro-cycle on the carry in `slot` (emptied). `batches`
        and `lrs` carry a leading axis of length len(plan). Returns (carry,
        stacked per-step metrics), still on the device."""
        shape = plan.shape
        ov = getattr(self.strategy, "overlap_cycle", lambda s: None)(shape)
        if ov is not None:
            return self._run_overlap(slot, ov, batches, lrs)
        if is_tail and len(shape) > 1 and shape not in self._programs:
            return self._run_per_step(slot, shape, batches, lrs)
        carry, metrics = self.program_for(shape)(slot, batches, lrs)
        self.stats.dispatches += 1
        self.stats.steps += len(shape)
        self.stats.cycles += 1
        return carry, metrics

    def _ov_exchange(self) -> Callable:
        if "exchange" not in self._ov_fns:
            self._ov_fns["exchange"] = self.strategy.overlap_exchange_fn()
        return self._ov_fns["exchange"]

    def _ov_merge(self, staleness: int, extra: int) -> Callable:
        key = ("merge", staleness, extra)
        if key not in self._ov_fns:
            self._ov_fns[key] = self.strategy.overlap_merge_fn(staleness, extra)
        return self._ov_fns[key]

    def _run_overlap(self, slot: list, ov: OverlapCycle, batches, lrs):
        """One overlap cycle in three parts: the exchange of the pending
        snapshot, enqueued first on `exchange_stream` after that stream has
        waited for the current one (which wrote the snapshot); the local
        steps on the current stream meanwhile (nothing of theirs reaches
        across replicas); then, once the current stream has waited for the
        exchange, the stale merge and the deferred loss reduction. The host
        waits for the local steps first, then for the exchange, so the
        second wait is the part of the exchange the local steps did not
        hide (`overlap_exchange_visible_s`). With `serial_exchange` it waits
        for the exchange before the local steps are enqueued
        (`overlap_exchange_blocking_s`): the same numbers, the exchange's
        own time. On the CPU each part runs when it is called."""
        params, opt_state, stale_inflight, pending = slot.pop()
        compute = [(params, opt_state)]
        del params, opt_state, stale_inflight
        exchange = self._ov_exchange()
        merge = self._ov_merge(ov.staleness, ov.extra_staleness)
        program = self.program_for(ov.compute_shape)
        main = side = None
        if _device_of(pending).type == "cuda":
            main = torch.cuda.current_stream()
            if self.exchange_stream is None:
                self.exchange_stream = torch.cuda.Stream()
            side = self.exchange_stream
            side.wait_stream(main)

        def run_exchange():
            if side is None:
                return exchange(pending)
            with torch.cuda.stream(side):
                return exchange(pending)

        def wait(stream):
            if stream is not None:
                stream.synchronize()
            return time.perf_counter()

        # across processes the exchange gathers: waited for at once under
        # dispatch "serial", on a helper thread beside the local steps under
        # "overlap" (their own collectives wait for the cycle's fetch)
        placed = self.placement
        serial = self.serial_exchange or (placed is not None and placed.dispatch == "serial")
        threaded = placed is not None and not serial
        tr, steps = self.tracer, len(ov.compute_shape)
        t0 = time.perf_counter()
        if serial:
            with tr.span("ov_exchange_blocking", cat="executor"):
                inflight = run_exchange()
                t1 = wait(side)
                self.stats.overlap_exchange_blocking_s += t1 - t0
            with tr.span("ov_compute", cat="executor", steps=steps):
                (params, opt_state), m = program(compute, batches, lrs)
                t2 = wait(main)
                self.stats.overlap_compute_s += t2 - t1
        else:
            with tr.span("ov_compute", cat="executor", steps=steps):
                if threaded:
                    def beside():
                        with placed.beside_compute():
                            return run_exchange()

                    helper = _Helper(beside)
                else:
                    inflight = run_exchange()         # in flight, not awaited
                (params, opt_state), m = program(compute, batches, lrs)
                t1 = wait(main)
                self.stats.overlap_compute_s += t1 - t0
            with tr.span("ov_exchange_visible", cat="executor"):
                if threaded:
                    inflight = helper.join()
                t2 = wait(side)
                self.stats.overlap_exchange_visible_s += t2 - t1
        with tr.span("ov_merge", cat="executor", staleness=ov.staleness,
                     extra=ov.extra_staleness):
            if side is not None:
                # the merge reads what the exchange wrote; the snapshot it
                # read may be freed once this wait is enqueued, and the
                # result, allocated on the exchange stream, is used on this
                # one from now
                main.wait_stream(side)
                for x in leaves(inflight):
                    x.record_stream(main)
            del pending
            params, loss = merge(params, inflight, m["loss_per_replica"])
            t3 = wait(main)
            self.stats.overlap_merge_s += t3 - t2
        self.stats.overlap_wall_s += t3 - t0
        metrics = dict(m)
        if loss is not None:
            metrics["loss"] = loss
        # pending <- the merged params (by reference: nothing writes in
        # place): the next cycle's exchange sends what this merge produced
        self.stats.dispatches += 3
        self.stats.steps += len(ov.compute_shape)
        self.stats.cycles += 1
        self.stats.overlap_cycles += 1
        return (params, opt_state, inflight, params), metrics

    def _per_step_fn(self, mode: str, stale: int) -> Callable:
        key = (mode, stale)
        if key not in self._per_step:
            self._per_step[key] = self.strategy.step_fn(mode, stale)
        return self._per_step[key]

    def _run_per_step(self, slot: list, shape: CycleShape, batches, lrs):
        """The tail fallback: one dispatch per step, so a shape used once at
        the end of a run builds no program."""
        carry = slot.pop()
        chunks = []
        for i, (mode, stale) in enumerate(shape):
            carry, m = self._per_step_fn(mode, stale)(carry, _step_batch(batches, i), lrs[i])
            chunks.append(m)
            self.stats.dispatches += 1
            self.stats.fallback_steps += 1
        return carry, _stack_metrics(chunks)


class _Helper:
    """`fn()` on a thread of its own; `join()` returns its result or raises
    its exception. (CUDA's current stream is per thread, so `fn` sets its
    own.)"""

    def __init__(self, fn: Callable):
        self._out: list = []
        self._thread = threading.Thread(target=self._run, args=(fn,),
                                        name="daso-exchange", daemon=True)
        self._thread.start()

    def _run(self, fn):
        try:
            self._out.append((True, fn()))
        except BaseException as e:  # handed to the joining thread
            self._out.append((False, e))

    def join(self):
        self._thread.join()
        ok, value = self._out.pop()
        if not ok:
            raise value
        return value


def resolve_executor(strategy: Strategy, executor: Optional[MacroCycleExecutor],
                     placement) -> Tuple[MacroCycleExecutor, object]:
    """One rule for an executor (the caller's or a new one) and a placement
    (or none), shared by `run_compiled_training` and the resilience
    supervisor: build the executor if needed, hand it the placement unless
    it has one, and return the placement in force."""
    ex = executor or MacroCycleExecutor(strategy, placement=placement)
    if placement is not None and ex.placement is None:
        ex.placement = placement
    return ex, ex.placement


def placed_metrics(strategy: Strategy, metrics: dict) -> dict:
    """Stacked per-step metrics (L, ...) as the one-process run gives them:
    unchanged without a placement; placed, every replica's per-replica
    values gathered in one collective and reduced step by step
    (`Strategy.reduce_metrics`)."""
    if strategy.placement is None:
        return metrics
    keys = [k for k in metrics if k == "loss_per_replica" or k.startswith(AUX_ROWS)]
    return strategy.reduce_metrics(strategy.placement.gather_metrics(metrics, keys))


def shape_sync_counts(shape: CycleShape) -> Dict[str, int]:
    """Syncs per level in one cycle shape, the plan-side counterpart of
    `DasoController.level_sync_counts`: "_outer" counts the steps whose
    outer action reaches across replicas, and each inner level its syncs."""
    counts: Dict[str, int] = {"_outer": 0}
    for m, _ in shape:
        if m.startswith(OVERLAP_COMPUTE_PREFIX):
            m = m[len(OVERLAP_COMPUTE_PREFIX):]
        outer, inner = split_mode(m)
        if split_ov(outer)[0] in (Mode.SEND, Mode.SEND_RECEIVE, Mode.BLOCKING,
                                  Mode.HARD_AVG, Mode.OV_SYNC, Mode.GOSSIP,
                                  Mode.ELASTIC, Mode.PUSH):
            counts["_outer"] += 1
        for name in inner:
            counts[name] = counts.get(name, 0) + 1
    return counts


def dispatch_planned_cycle(ex: MacroCycleExecutor, slot: list, plan: CyclePlan,
                           data_fn: Callable, lr_fn: Callable, n_steps: int):
    """Stage one planned cycle's batches (`torch.stack`) and lrs (one f32
    tensor (L,) on the batches' device, as the reference's
    `jnp.asarray(lr_list, float32)`), run it on the carry in `slot`
    (emptied), and bring its per-step metrics to the host in one transfer,
    the cycle's only wait for the device. Returns (carry, cycle_losses,
    per_step_metrics, seconds): host seconds from the staged batches to the
    metrics on the host, the span the per-step path's `step_seconds` times
    for one step.

    The whole sequence, staging included, is one `cycle` trace span, as in
    the reference; it ends on the metrics' copy to the host, so it times
    the card's work, and it is at least `seconds` long. Its args carry the
    per-level sync counts and, set after the run, `fresh_compile` (the
    cycle built its shape's program) and `fallback` (it ran step by
    step).

    Placed (`ex.placement`), the batches are this process's rows and the
    per-replica metrics are gathered and reduced before the copy to the
    host (`placed_metrics`); `ex.health` hears of the cycle once its metrics
    are on the host, so its watchdog moves only when the group has come
    through the cycle's collectives."""
    compiles0, fallback0 = ex.stats.compiles, ex.stats.fallback_steps
    with ex.tracer.span("cycle", cat="executor", start_step=plan.start_step,
                        steps=len(plan), syncs=shape_sync_counts(plan.shape)) as sp:
        steps = range(plan.start_step, plan.start_step + len(plan))
        per_step = [data_fn(t) for t in steps]
        lr_list = [lr_fn(t) for t in steps]
        if ex.placement is not None:
            batches, lrs = ex.placement.stage_cycle(per_step, lr_list)
        else:
            batches = tree_map(lambda *xs: torch.stack(xs), *per_step)
            lrs = torch.tensor(lr_list, dtype=torch.float32, device=_device_of(batches))
        del per_step
        t0 = time.perf_counter()
        carry, metrics = ex.run_cycle(slot, plan, batches, lrs,
                                      is_tail=plan.start_step + len(plan) >= n_steps)
        metrics = placed_metrics(ex.strategy, metrics)
        keys = [k for k, v in metrics.items() if v.dim() == 1]
        host = torch.stack([metrics[k].double() for k in keys]).cpu()
        seconds = time.perf_counter() - t0
        if ex.tracer.enabled:
            # span args serialize at the span's exit, so the outcome flags
            # can land after the run
            sp.args["fresh_compile"] = ex.stats.compiles > compiles0
            sp.args["fallback"] = ex.stats.fallback_steps > fallback0
    per_step_metrics = [{k: float(host[i, j]) for i, k in enumerate(keys)}
                        for j in range(len(plan))]
    cycle_losses = [m["loss"] for m in per_step_metrics]
    if ex.health is not None:
        ex.health.cycle_done(plan.start_step + len(plan))
    return carry, cycle_losses, per_step_metrics, seconds


def run_compiled_training(strategy: Strategy, params0, data_fn: Callable,
                          lr_fn: Callable, n_steps: int, *,
                          executor: Optional[MacroCycleExecutor] = None,
                          track_divergence: bool = False, start_step: int = 0,
                          carry=None, ckpt_every: int = 0,
                          ckpt_cb: Optional[Callable] = None, placement=None):
    """Macro-cycle counterpart of `simulator.run_per_step_training`: plans
    cycles with the strategy, stages each cycle's batches and runs one
    program per cycle, the same numbers as the per-step path bit for bit.

    `track_divergence` samples the replica divergence once per cycle (the
    per-step path samples every step); it is the library surface of
    `SimResult.divergence`, which the reference's own API offers and no
    launcher sets.

    Checkpoints and resume (`train/loop.py` sets these from
    `TrainLoopConfig.ckpt_every` / `resume_from`): `start_step` and a
    restored `carry` continue a run whose strategy's controller is already
    at that step; `ckpt_cb(completed_steps, carry, losses)` fires at the
    first cycle boundary at or past each multiple of `ckpt_every`, where an
    uninterrupted run also plans a new cycle, so a run resumed there gives
    the same numbers. The carry stays in the executor's one-element slot
    while the callback reads it (the callback keeps no reference to it);
    the current stream first waits for the exchange stream, so no leaf is
    copied while an overlap exchange could still write it.

    `SimResult.cycles` lists each cycle's shape and its host seconds
    (`dispatch_planned_cycle`); `step_seconds` gives each step its cycle's
    seconds over the cycle's length.

    `placement` (launch/distributed.py::ProcessPlacement, or the
    executor's) runs the same loop on this process's replica rows: the
    carry is placed, the metrics are the one-process run's, the final
    params are broadcast from their owner, and `SimResult.carry` holds this
    process's rows."""
    from repro_torch.core.simulator import SimResult

    ex, placement = resolve_executor(strategy, executor, placement)
    slot = [strategy.init_carry(params0) if carry is None else carry]
    del carry
    if placement is not None:
        slot.append(placement.put_carry(slot.pop()))
    losses: List[float] = []
    metrics_log: List[Dict[str, float]] = []
    divs: List[float] = []
    seconds: List[float] = []
    cycles: List[Tuple[CycleShape, float]] = []
    step = start_step
    next_ckpt = (start_step // ckpt_every + 1) * ckpt_every if ckpt_every else None
    while step < n_steps:
        plan = strategy.plan_cycle(step, min(ex.max_cycle_len, n_steps - step))
        carry, cycle_losses, per_step_metrics, dt = dispatch_planned_cycle(
            ex, slot, plan, data_fn, lr_fn, n_steps)
        losses.extend(cycle_losses)
        metrics_log.extend(per_step_metrics)
        strategy.observe(cycle_losses)
        cycles.append((plan.shape, dt))
        seconds.extend([dt / len(plan)] * len(plan))
        if track_divergence:
            d = strategy.divergence(carry)
            if d is not None:
                divs.extend([d] * len(plan))
        slot.append(carry)
        del carry
        step += len(plan)
        if next_ckpt is not None and ckpt_cb is not None and step >= next_ckpt:
            if ex.exchange_stream is not None:
                torch.cuda.current_stream().wait_stream(ex.exchange_stream)
            with ex.tracer.span("checkpoint_save", cat="checkpoint", step=step):
                ckpt_cb(step, slot[0], losses)
            next_ckpt = (step // ckpt_every + 1) * ckpt_every
    carry = slot.pop()
    return SimResult(losses=losses, metrics=metrics_log,
                     params=strategy.finalize_params(carry),
                     sync_fraction=strategy.sync_fraction(),
                     controller=strategy.controller, divergence=divs,
                     executor_stats=ex.stats, step_seconds=seconds, carry=carry,
                     cycles=cycles, placement=placement)


# registered on import, so every user of the registry (the launcher's
# --strategy choices, train/loop.py, the tests) sees the baselines; last,
# as baselines.py subclasses DasoStrategy from this module
from repro_torch.core import baselines  # noqa: E402,F401
