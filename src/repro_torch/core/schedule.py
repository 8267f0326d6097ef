"""Host-side DASO controller (`repro/core/schedule.py::DasoController`):
phases (warm-up / cycling / cool-down) and the selective B/W schedule of
paper §3, which drives the outermost level.

  * B (batches between global syncs) starts at b_max (the paper uses 4);
  * W (batches to wait for the exchange) starts at max(1, B/4);
  * on every training-loss plateau, B and W are halved (min 1);
  * when B == W == 1 and the loss plateaus again, both reset to their
    initial values, until cool-down.

With `DasoConfig.overlap == "one_cycle"` the cycling phase runs the
double-buffered schedule instead: ov_start, then every B steps an ov_sync
that merges the exchange of the snapshot taken B steps earlier, one cycle
stale (`_overlap_mode`).

`HierDasoController` extends it to an N-level topology (repro_torch/topo):
each intermediate replica level l carries a fixed period B_l and gets a
synchronous group sync every B_l steps, appended to the step's mode as
``outer+lvl1,lvl2`` (`join_mode`); the plateau schedule keeps driving only
the outermost level.

Pure host logic: given the step index it returns which step variant to run
and consumes windowed loss means for plateau detection. Its state_dict has
the reference's keys, so the two packages' schedules compare directly.
With a `tracer` attached, each plateau decision is a `bw_change` instant
(obs/trace.py). The resilience supervisor's hooks (`notify_membership_change`,
`notify_dcn_scale`) add `membership_change` / `dcn_scale` instants and
`events` records. The online autotune's `retune` feeds measured per-level
sync costs back into the schedule (topo/probe.py): the outermost level's
effective network scale here, and the inner levels' periods in
`HierDasoController`; a change adds a `retune` instant and event.
"""
from __future__ import annotations

import math

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.daso import DasoConfig


class Mode:
    LOCAL = "local"
    SEND = "send"
    RECEIVE = "receive"
    SEND_RECEIVE = "send_receive"
    BLOCKING = "blocking"
    HARD_AVG = "hard_avg"
    # the overlap schedule: OV_START snapshots params into the pending
    # slot, OV_SYNC exchanges the previous snapshot and merges it one cycle
    # stale; an OV_SYNC token carries its extra staleness as "~E"
    OV_START = "ov_start"
    OV_SYNC = "ov_sync"
    # the baseline strategies (core/baselines.py): GOSSIP carries its
    # ring-shift as a "~s" suffix
    # ("gossip~2"), reusing the split_ov mechanics so each shift runs as
    # its own step variant; ELASTIC is the EASGD center pull, PUSH the
    # DOWNPOUR delta push — both one global all-reduce.
    GOSSIP = "gossip"
    ELASTIC = "elastic"
    PUSH = "push"


# outermost-level actions that touch the global (cross-node) network
_GLOBAL_SYNCS = (Mode.SEND, Mode.SEND_RECEIVE, Mode.BLOCKING, Mode.OV_SYNC,
                 Mode.GOSSIP, Mode.ELASTIC, Mode.PUSH)
# the same, with the local-SGD average: what `level_sync_counts` tallies as
# the outermost level's syncs
_OUTER_SYNCS = _GLOBAL_SYNCS + (Mode.HARD_AVG,)


def split_ov(outer: str) -> Tuple[str, int]:
    """An outer-level overlap token as (base, extra_staleness):
    ``"ov_sync~2"`` -> ``("ov_sync", 2)``, ``"ov_sync"`` -> ``("ov_sync",
    0)``; other tokens pass through with 0. Each extra age is its own step
    variant, as Eq. (1)'s S is fixed per variant."""
    base, _, extra = outer.partition("~")
    return base, int(extra) if extra else 0


def is_ov_mode(mode: str) -> bool:
    """True when the step's outer action belongs to the overlap family (also
    for hierarchical tokens such as ``"ov_sync~1+host"``)."""
    return split_ov(split_mode(mode)[0])[0] in (Mode.OV_START, Mode.OV_SYNC)


def split_mode(mode: str) -> Tuple[str, Tuple[str, ...]]:
    """Split a (possibly hierarchical) mode token into the outermost-level
    action and the inner levels syncing that step: ``"send+host"`` ->
    ``("send", ("host",))``, ``"local"`` -> ``("local", ())``."""
    outer, _, inner = mode.partition("+")
    return outer, tuple(inner.split(",")) if inner else ()


def join_mode(outer: str, inner: Tuple[str, ...]) -> str:
    """Inverse of `split_mode`; with no inner syncs the token is the outer
    action itself."""
    return f"{outer}+{','.join(inner)}" if inner else outer


@dataclass
class DasoController:
    cfg: DasoConfig
    loss_window: int = 50
    _b: int = field(init=False)
    _w: int = field(init=False)
    _last_send: int = field(init=False, default=-(10 ** 9))
    _inflight_since: Optional[int] = field(init=False, default=None)
    _recv_staleness: int = field(init=False, default=1)
    # step of the last pending snapshot (ov_start or ov_sync); None: the
    # next cycling step must ov_start (a fresh run, or a blocking phase
    # superseded the snapshot)
    _ov_last: Optional[int] = field(init=False, default=None)
    _best: float = field(init=False, default=float("inf"))
    _since_improve: int = field(init=False, default=0)
    _win_acc: List[float] = field(init=False, default_factory=list)
    _dcn_scale: float = field(init=False, default=1.0)
    history: List[Tuple[int, str, int, int]] = field(init=False,
                                                     default_factory=list)
    events: List[Tuple[int, str, float]] = field(init=False,
                                                 default_factory=list)

    # obs.trace sink for decision events (plateau B/W changes), attached by
    # train/loop.py when a run is traced. A plain class attribute, not a
    # dataclass field: it never enters _STATE_FIELDS / state_dict (a
    # checkpoint round-trips through JSON), and a controller without one
    # stays silent.
    tracer = None

    def _trace(self, name: str, **args) -> None:
        if self.tracer is not None:
            self.tracer.instant(name, cat="schedule", **args)

    def __post_init__(self):
        self._b = max(1, self.cfg.b_max)
        self._w = max(1, self._b // 4)

    # -- phase logic -------------------------------------------------------
    def phase(self, step: int) -> str:
        """"warmup" for the first `warmup_steps`, "cooldown" for the last
        `cooldown_steps` (when `total_steps` is known), else "cycling".
        Pure: safe to call while planning ahead."""
        if step < self.cfg.warmup_steps:
            return "warmup"
        if (self.cfg.total_steps and self.cfg.cooldown_steps
                and step >= self.cfg.total_steps - self.cfg.cooldown_steps):
            return "cooldown"
        return "cycling"

    @property
    def b(self) -> int:
        return self._b

    @property
    def w(self) -> int:
        return self._w

    def mode_for_step(self, step: int) -> Tuple[str, int]:
        """Consume one decision: (mode, staleness S) for `step`. Call exactly
        once per step, in step order. S is the number of batches waited
        since the matching send (it feeds Eq. (1) on receive steps)."""
        if self.phase(step) in ("warmup", "cooldown"):
            # a blocking step completes any dangling exchange trivially
            self._inflight_since = None
            self._ov_last = None
            mode, stale = Mode.BLOCKING, 1
        elif self.cfg.overlap != "off":
            mode, stale = self._overlap_mode(step)
        else:
            recv = (self._inflight_since is not None
                    and step - self._inflight_since >= self._w)
            send = step - self._last_send >= self._b
            if recv:
                stale = step - self._inflight_since
                self._inflight_since = None
            else:
                stale = 1
            if send and self._inflight_since is not None:
                send = False  # previous exchange still in flight: skip
            if send:
                self._last_send = step
                self._inflight_since = step
            mode = {(False, False): Mode.LOCAL,
                    (True, False): Mode.SEND,
                    (False, True): Mode.RECEIVE,
                    (True, True): Mode.SEND_RECEIVE}[(send, recv)]
        self.history.append((step, mode, self._b, self._w))
        return mode, stale

    def _overlap_mode(self, step: int) -> Tuple[str, int]:
        """Cycling-phase decision of the overlap schedule. Every B steps an
        OV_SYNC merges the exchange of the snapshot taken B steps earlier.
        The snapshot's age splits into the S = min(W, age) the in-cycle
        schedule would charge and the extra ``age - S``, carried in the
        token (``"ov_sync~E"``)."""
        if self._ov_last is None:
            self._ov_last = step
            return Mode.OV_START, 1
        age = step - self._ov_last
        if age < self._b:
            return Mode.LOCAL, 1
        self._ov_last = step
        stale = min(self._w, age)
        extra = age - stale
        return (f"{Mode.OV_SYNC}~{extra}" if extra else Mode.OV_SYNC), stale

    # -- macro-cycle planning ----------------------------------------------
    def window_remaining(self) -> int:
        """Steps until the current plateau-detection window fills."""
        return self.loss_window - len(self._win_acc)

    def _would_send(self, step: int) -> bool:
        """Would `mode_for_step(step)` start a new send? Does not consume."""
        if self.phase(step) != "cycling":
            return False
        return (step - self._last_send >= self._b
                and self._inflight_since is None)

    def plan_cycle(self, start_step: int,
                   max_len: int = 32) -> Tuple[Tuple[str, int], ...]:
        """The (mode, staleness) sequence of one macro-cycle from
        `start_step`, consumed from the schedule in order. The cycle is cut
        at `max_len` steps, where the plateau window fills, at a phase
        change, or before the next send, so no loss feedback can change the
        schedule inside it: a B=4 / W=1 cycle is
        ``(send, receive@S, local, local)``. Under overlap the cycling cut
        comes after an ov_start / ov_sync step instead:
        ``(local, local, local, ov_sync~3)``."""
        n_max = max(1, min(max_len, self.window_remaining()))
        phase0 = self.phase(start_step)
        ov = self.cfg.overlap != "off"
        shape = []
        while len(shape) < n_max:
            t = start_step + len(shape)
            if shape:
                if self.phase(t) != phase0:
                    break
                if phase0 == "cycling" and not ov and self._would_send(t):
                    break
            shape.append(self.mode_for_step(t))
            if ov and phase0 == "cycling" and is_ov_mode(shape[-1][0]):
                break
        return tuple(shape)

    # -- plateau-driven B/W schedule ----------------------------------------
    def observe_loss(self, loss: float) -> None:
        """Feed one training loss, in step order. When a window of
        `loss_window` fills, its mean is compared with the best window so
        far; `plateau_patience` windows without improvement halve B and W,
        or reset them once both are 1."""
        self._win_acc.append(float(loss))
        if len(self._win_acc) < self.loss_window:
            return
        mean = sum(self._win_acc) / len(self._win_acc)
        self._win_acc.clear()
        if mean < self._best * (1.0 - self.cfg.plateau_threshold):
            self._best = mean
            self._since_improve = 0
            return
        self._since_improve += 1
        if self._since_improve >= self.cfg.plateau_patience:
            self._since_improve = 0
            b0, w0 = self._b, self._w
            if self._b == 1 and self._w == 1:
                self._b = max(1, self.cfg.b_max)          # paper: reset
                self._w = max(1, self._b // 4)
                reason = "plateau_reset"
            else:
                self._b = max(1, self._b // 2)             # paper: halve
                self._w = max(1, self._w // 2)
                reason = "plateau_halve"
            self._trace("bw_change", reason=reason, b_from=b0, b_to=self._b,
                        w_from=w0, w_to=self._w, window_mean=mean,
                        best=self._best,
                        patience=self.cfg.plateau_patience)

    # -- resilience hooks --------------------------------------------------
    def notify_membership_change(self, step: int, n_active: int) -> None:
        """A replica dropped or rejoined at `step`. The loss of another
        active set does not compare with the old one, so the plateau
        statistics are flushed: the current window is dropped and the best
        window restarts (a crash's loss bump would otherwise count toward
        `plateau_patience` at once). B and W stay where they are."""
        self._win_acc.clear()
        self._since_improve = 0
        self._best = float("inf")
        self.events.append((step, "membership", float(n_active)))
        self._trace("membership_change", reason="plateau_stats_flushed",
                    step=step, n_active=n_active)

    def notify_dcn_scale(self, scale: float, *, step: int = -1) -> None:
        """The outermost (cross-node) network runs at `scale` times its
        nominal bandwidth: degraded (scale < 1) or recovered (scale >= 1).
        Degraded, B stretches to ceil(b_max / scale), capped at 4 b_max, so
        the exchange's cost per step stays bounded; recovered, B comes back
        to at most b_max. W follows B at the paper's B/4."""
        if scale <= 0:
            raise ValueError(f"dcn scale must be positive, got {scale}")
        self._dcn_scale = float(scale)
        b_max = max(1, self.cfg.b_max)
        b0 = self._b
        if scale < 1.0:
            stretched = int(math.ceil(b_max / scale))
            self._b = max(self._b, min(4 * b_max, stretched))
            reason = "dcn_degraded"
        else:
            self._b = min(self._b, b_max)
            reason = "dcn_recovered"
        self._w = max(1, self._b // 4)
        self.events.append((step, "dcn_scale", float(scale)))
        self._trace("dcn_scale", reason=reason, step=step, scale=scale,
                    b_from=b0, b_to=self._b)

    def retune(self, level_costs: Dict[str, float], *,
               annotated: Optional[Dict[str, float]] = None,
               step: int = -1, rel_tol: float = 0.05) -> bool:
        """Feed one round of measured per-level sync costs (seconds per
        sync, ``"_outer"`` for the outermost level, as topo/probe.py gives
        them) back into the schedule. This controller owns the outermost
        level only: with the nominal ``"_outer"`` cost in `annotated`, the
        nominal over the measured cost is the network's effective scale (a
        link at half its bandwidth measures twice the cost), and a scale
        more than `rel_tol` away from the one in force goes through
        `notify_dcn_scale`'s stretch rule.

        Costs equal to the annotations are a strict no-op: no state change,
        no event, no trace. Returns True when the schedule changed; the
        caller then invalidates its executor, as after a membership
        change."""
        t_meas = level_costs.get("_outer")
        t_nom = (annotated or {}).get("_outer")
        if not t_meas or not t_nom or t_meas <= 0 or t_nom <= 0:
            return False
        scale = t_nom / t_meas
        if abs(scale - self._dcn_scale) <= rel_tol * self._dcn_scale:
            return False
        b0, w0 = self._b, self._w
        self.notify_dcn_scale(scale, step=step)
        self.events.append((step, "retune", float(scale)))
        self._trace("retune", step=step, scale=scale, b_from=b0, b_to=self._b,
                    bw_changed=(self._b, self._w) != (b0, w0))
        return True

    # -- checkpoint state --------------------------------------------------
    _STATE_FIELDS = ("_b", "_w", "_last_send", "_inflight_since",
                     "_recv_staleness", "_ov_last", "_best",
                     "_since_improve", "_dcn_scale")

    def state_dict(self) -> dict:
        """Full mutable state, JSON-serializable, with the reference's
        keys; `load_state_dict` of it resumes the schedule exactly."""
        sd = {k: getattr(self, k) for k in self._STATE_FIELDS}
        sd["win_acc"] = list(self._win_acc)
        sd["history"] = [list(h) for h in self.history]
        sd["events"] = [list(e) for e in self.events]
        sd["loss_window"] = self.loss_window
        return sd

    def load_state_dict(self, sd: dict) -> None:
        for k in self._STATE_FIELDS:
            # a state dict from before the overlap schedule has no _ov_last:
            # keep the default, so the next cycling step re-snapshots
            setattr(self, k, sd.get(k, getattr(self, k)))
        self._win_acc = [float(x) for x in sd["win_acc"]]
        self.history = [tuple(h) for h in sd["history"]]
        self.events = [tuple(e) for e in sd.get("events", [])]
        self.loss_window = int(sd["loss_window"])

    # -- audit -------------------------------------------------------------
    def global_sync_fraction(self) -> float:
        """Fraction of steps that touched the global network (an ov_sync~E
        token counts as ov_sync)."""
        if not self.history:
            return 0.0
        touched = sum(1 for (_, m, _, _) in self.history
                      if split_ov(split_mode(m)[0])[0] in _GLOBAL_SYNCS)
        return touched / len(self.history)

    def level_sync_counts(self) -> Dict[str, int]:
        """Syncs per level over the history: each inner level's count, and
        the outermost level's (hard_avg included) under "_outer"."""
        counts: Dict[str, int] = {"_outer": 0}
        for (_, m, _, _) in self.history:
            outer, inner = split_mode(m)
            if split_ov(outer)[0] in _OUTER_SYNCS:
                counts["_outer"] += 1
            for name in inner:
                counts[name] = counts.get(name, 0) + 1
        return counts


@dataclass
class HierDasoController(DasoController):
    """The N-level schedule (`repro/core/schedule.py::HierDasoController`).

    `inner_periods` maps each intermediate replica level's name to its fixed
    sync period B_l, innermost first (`repro_torch.topo.lower.
    derive_inner_periods`, unless the spec pins it with ``%period``). Level
    l gets a synchronous group average on every step where ``(step + 1) %
    B_l == 0``; warm-up / cool-down `blocking` steps and `hard_avg` already
    average the full world, so inner syncs are left out there.

    The outermost level keeps the inherited plateau-driven schedule. With
    no intermediate levels this class behaves as its base: the same mode
    strings, history and cycle shapes. `pinned_periods` names the levels
    whose period the spec pinned, which a retune leaves alone."""
    inner_periods: Dict[str, int] = field(default_factory=dict)
    pinned_periods: Tuple[str, ...] = ()

    def __post_init__(self):
        super().__post_init__()
        for name, period in self.inner_periods.items():
            if period < 1:
                raise ValueError(f"inner level {name!r}: period must be "
                                 f">= 1, got {period}")

    def inner_syncs_at(self, step: int) -> Tuple[str, ...]:
        """Names of the intermediate levels whose period elapses at `step`:
        a pure function of the step index, so a planned cycle's shape
        carries the per-level phases."""
        return tuple(name for name, period in self.inner_periods.items()
                     if (step + 1) % period == 0)

    def mode_for_step(self, step: int) -> Tuple[str, int]:
        outer, stale = super().mode_for_step(step)
        if outer in (Mode.BLOCKING, Mode.HARD_AVG):
            return outer, stale
        inner = self.inner_syncs_at(step)
        if not inner:
            return outer, stale
        mode = join_mode(outer, inner)
        # the history entry the base class just appended names the whole
        # per-level phase vector
        s, _, b, w = self.history[-1]
        self.history[-1] = (s, mode, b, w)
        return mode, stale

    def retune(self, level_costs: Dict[str, float], *,
               annotated: Optional[Dict[str, float]] = None,
               step: int = -1, rel_tol: float = 0.05) -> bool:
        """The N-level retune: the base class takes the outermost level
        (the effective network scale), then every measured intermediate
        level gets its period from the cost ratio

            B_l = clamp(round(b_max * t_l / t_outer), 1, b_max)

        the lowering rule of `topo/lower.py::derive_inner_periods` with
        measured seconds in place of annotated bandwidths (bandwidth is
        bytes over time, so the ratios are one quantity). Levels pinned with
        ``%period`` and levels missing from `level_costs` keep their period,
        so costs equal to the annotations give the lowered schedule: a
        no-op. A change of periods adds a `retune_periods` event (its value
        the number of levels that moved) and a `retune` instant. Returns
        True when anything changed; the caller must then drop its built
        cycles (`MacroCycleExecutor.invalidate`), as the planner's cycle
        shapes change with the periods."""
        changed = super().retune(level_costs, annotated=annotated, step=step,
                                 rel_tol=rel_tol)
        t_outer = level_costs.get("_outer")
        if not t_outer or t_outer <= 0:
            return changed
        b_max = max(1, self.cfg.b_max)
        new = dict(self.inner_periods)
        for name in self.inner_periods:
            t_l = level_costs.get(name)
            if name in self.pinned_periods or not t_l or t_l <= 0:
                continue
            new[name] = max(1, min(b_max, round(b_max * t_l / t_outer)))
        if new != self.inner_periods:
            old = dict(self.inner_periods)
            self.inner_periods = new
            self.events.append((step, "retune_periods",
                                float(sum(1 for n in new if new[n] != old[n]))))
            self._trace("retune", step=step, periods_from=old,
                        periods_to=dict(new), bw_changed=False)
            changed = True
        return changed

    def state_dict(self) -> dict:
        """The base state plus the effective per-level periods, which a
        retune changes (the reference's key, TrainState version 3)."""
        sd = super().state_dict()
        sd["inner_periods"] = dict(self.inner_periods)
        return sd

    def load_state_dict(self, sd: dict) -> None:
        super().load_state_dict(sd)
        # a state dict from before the periods were saved keeps the
        # statically lowered periods this controller was built with
        if "inner_periods" in sd:
            self.inner_periods = {str(k): int(v)
                                  for k, v in sd["inner_periods"].items()}
