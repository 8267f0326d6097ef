"""Declarative, deterministic fault plans (`repro/resilience/faults.py`,
copied whole: the reference module is pure Python, and the port imports
nothing of it, so one plan JSON reads the same in both packages).

A `FaultPlan` is a step-indexed list of `FaultEvent`s — the failure script a
resilience run replays. Determinism is the point: the same plan against the
same seed produces the same training trajectory, so fault-injection runs are
testable and benchmarkable like any other experiment (the "chaos testing as
a first-class scenario" the Hitchhiker's-guide line of work argues for).

Event kinds (all applied host-side, *before* the step they are indexed at):

  crash        replica `replica` drops out of the active set. Its row in
               the SPMD emulation is frozen; exchanges become
               membership-weighted over the survivors (core/daso.py).
  rejoin       replica `replica` comes back. Its row is re-seeded from the
               survivors' membership-weighted mean (params, optimizer
               state, in-flight buffer) before it re-enters the active set.
  straggle     replica `replica` slows down by `factor`× (>= 1). Numerics
               are unaffected (DASO already absorbs slow nodes via the
               staleness weighting); the supervisor charges the slowdown to
               the simulated clock.
  recover      replica `replica` returns to nominal speed.
  degrade_dcn  the outermost-level (cross-pod) network drops to `factor`×
               nominal bandwidth (0 < factor <= 1). The controller
               stretches B in response (schedule.py::notify_dcn_scale) and
               the simulated clock charges exchanges at the degraded rate.
  restore_dcn  DCN bandwidth back to nominal.

Replica-addressed kinds may name a *topology node* instead of a replica
index (`node` instead of `replica`): a "/"-joined path like ``"pod1"`` or
``"pod1/host0"`` into an N-level `repro_torch.topo.TopologySpec`. The event then
covers every replica in that subtree — crashing a pod takes all of its
hosts down in one scripted event. Node events are symbolic until
`FaultPlan.resolve(spec)` expands them against a concrete topology
(``launch/train.py --topology --fault-plan`` does this automatically);
`validate` rejects unresolved plans.

JSON wire format (FaultPlan.from_json / to_json):

    {"events": [{"step": 10, "kind": "crash", "replica": 3},
                {"step": 30, "kind": "rejoin", "replica": 3},
                {"step": 40, "kind": "straggle", "node": "pod1",
                 "factor": 2.0},
                {"step": 12, "kind": "degrade_dcn", "factor": 0.25}]}
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Tuple

KINDS = ("crash", "rejoin", "straggle", "recover",
         "degrade_dcn", "restore_dcn")
_REPLICA_KINDS = ("crash", "rejoin", "straggle", "recover")


@dataclass(frozen=True)
class FaultEvent:
    step: int
    kind: str
    replica: Optional[int] = None
    # topology-node path ("pod1", "pod1/host0", ...) — the symbolic
    # alternative to `replica`; expanded by FaultPlan.resolve(spec)
    node: Optional[str] = None
    factor: float = 1.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")
        if self.kind in _REPLICA_KINDS and \
                (self.replica is None) == (self.node is None):
            raise ValueError(f"{self.kind!r} event needs exactly one of a "
                             "replica index or a topology node path")
        if self.kind not in _REPLICA_KINDS and self.node is not None:
            raise ValueError(f"{self.kind!r} event does not address a "
                             "node (it is cluster-wide)")
        if self.kind == "straggle" and self.factor < 1.0:
            raise ValueError(f"straggle factor is a slowdown multiplier "
                             f">= 1, got {self.factor}")
        if self.kind == "degrade_dcn" and not 0.0 < self.factor <= 1.0:
            raise ValueError(f"degrade_dcn factor is a bandwidth fraction "
                             f"in (0, 1], got {self.factor}")


@dataclass(frozen=True)
class FaultPlan:
    events: Tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        object.__setattr__(
            self, "events",
            tuple(sorted(self.events,
                         key=lambda e: (e.step, e.kind,
                                        -1 if e.replica is None
                                        else e.replica, e.node or ""))))

    # -- construction / serialization --------------------------------------
    @classmethod
    def from_dicts(cls, dicts: List[Dict]) -> "FaultPlan":
        return cls(tuple(FaultEvent(**d) for d in dicts))

    @classmethod
    def from_json(cls, path_or_text: str) -> "FaultPlan":
        """Load from a JSON file path, or from a JSON string."""
        if os.path.exists(path_or_text):
            with open(path_or_text) as f:
                doc = json.load(f)
        else:
            doc = json.loads(path_or_text)
        return cls.from_dicts(doc["events"])

    def to_json(self) -> str:
        return json.dumps({"events": [
            {k: v for k, v in asdict(e).items() if v is not None}
            for e in self.events]}, indent=1)

    def resolve(self, spec) -> "FaultPlan":
        """Expand topology-node events against a concrete
        `repro_torch.topo.TopologySpec`: each node-addressed event becomes one
        per-replica event per replica in the node's subtree (same step /
        kind / factor). Replica-addressed events pass through; the result
        is fully concrete and `validate`-able. Crashing a node that
        contains an already-crashed replica is rejected by `validate`,
        exactly as the equivalent scripted per-replica crashes would
        be."""
        out: List[FaultEvent] = []
        for e in self.events:
            if e.node is None:
                out.append(e)
                continue
            for r in spec.replicas_of(e.node):
                out.append(FaultEvent(step=e.step, kind=e.kind, replica=r,
                                      factor=e.factor))
        return FaultPlan(tuple(out))

    # -- queries ------------------------------------------------------------
    def boundaries(self) -> List[int]:
        """Sorted unique steps with at least one event — a macro-cycle plan
        must never span one (the supervisor cuts cycles here, the
        'replanning on membership change' contract)."""
        return sorted({e.step for e in self.events})

    def events_at(self, step: int) -> List[FaultEvent]:
        return [e for e in self.events if e.step == step]

    def next_boundary_after(self, step: int) -> Optional[int]:
        later = [b for b in self.boundaries() if b > step]
        return min(later) if later else None

    def membership_at(self, step: int, n_replicas: int) -> Tuple[float, ...]:
        """Active mask in force while `step` runs (events at step k apply
        before step k)."""
        mask = [1.0] * n_replicas
        for e in self.events:
            if e.step > step:
                break
            if e.kind == "crash":
                mask[e.replica] = 0.0
            elif e.kind == "rejoin":
                mask[e.replica] = 1.0
        return tuple(mask)

    def dcn_scale_at(self, step: int) -> float:
        scale = 1.0
        for e in self.events:
            if e.step > step:
                break
            if e.kind == "degrade_dcn":
                scale = e.factor
            elif e.kind == "restore_dcn":
                scale = 1.0
        return scale

    def slowdowns_at(self, step: int, n_replicas: int) -> Tuple[float, ...]:
        slow = [1.0] * n_replicas
        for e in self.events:
            if e.step > step:
                break
            if e.kind == "straggle":
                slow[e.replica] = e.factor
            elif e.kind == "recover":
                slow[e.replica] = 1.0
        return tuple(slow)

    # -- validation ----------------------------------------------------------
    def validate(self, n_replicas: int,
                 alive0: Optional[List[bool]] = None) -> None:
        """Replay the plan symbolically and reject incoherent scripts:
        out-of-range replicas, crashing a dead replica, rejoining a live
        one, or leaving zero survivors at any point. `alive0` overrides
        the all-alive starting membership — a plan replayed from a resumed
        checkpoint (live regroup) starts from the membership the snapshot
        recorded, not from a fresh cluster."""
        alive = ([bool(a) for a in alive0] if alive0 is not None
                 else [True] * n_replicas)
        if len(alive) != n_replicas:
            raise ValueError(f"alive0 has {len(alive)} entries for "
                             f"{n_replicas} replicas")
        for e in self.events:
            if e.node is not None:
                raise ValueError(
                    f"event {e} addresses topology node {e.node!r}; call "
                    "plan.resolve(topology_spec) before validate/replay")
            if e.replica is not None and not 0 <= e.replica < n_replicas:
                raise ValueError(f"event {e} addresses replica "
                                 f"{e.replica} outside 0..{n_replicas - 1}")
            if e.kind == "crash":
                if not alive[e.replica]:
                    raise ValueError(f"step {e.step}: crash of replica "
                                     f"{e.replica}, already down")
                alive[e.replica] = False
                if not any(alive):
                    raise ValueError(f"step {e.step}: plan leaves no "
                                     "active replicas")
            elif e.kind == "rejoin":
                if alive[e.replica]:
                    raise ValueError(f"step {e.step}: rejoin of replica "
                                     f"{e.replica}, already active")
                alive[e.replica] = True
