"""Runtime topology probing (`repro/topo/probe.py`): measure what the links
deliver and feed it back into the lowered schedule.

A `TopologySpec` carries bandwidth annotations, and the lowering
(`topo/lower.py::derive_inner_periods`) freezes the per-level periods from
them. This module closes the loop with three probes that feed one hook:

  * the active probe (`active_probe`): one real `level_group_mean` per
    replica level on the caller's device, timed, at startup;
  * the passive probe (`fit_level_costs`): the per-level median of the
    sync spans a traced run already records (`obs/meters.py::
    level_cost_samples`), at no extra traffic;
  * the skew probe (`skew_permutation`): per-replica slowdowns sorted into
    a regrouping, so replicas of one speed share an inner group.

Their dicts and tuples go to `DasoController.retune` /
`HierDasoController.retune` and `DasoStrategy.set_group_permutation`; the
resilience supervisor runs them every `autotune_every` cycles, the
launcher under ``--autotune``.

The cost model is first order, ``t_l = bytes / bw_l``, so a cluster that
matches its annotations retunes to nothing: `annotated_level_costs` through
`derive_retuned_periods` gives the static lowering (doctested below).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

from repro_torch.topo.spec import TopologySpec

# key of the outermost level in cost dicts: the controllers have no spec,
# so the outer level travels under a fixed name
OUTER_KEY = "_outer"


def annotated_level_costs(spec: TopologySpec,
                          param_bytes: float = 4e6) -> Dict[str, float]:
    """Nominal seconds per sync of every replica level with groups of more
    than one replica, ``param_bytes / bw_l`` (the outermost under
    `OUTER_KEY`): the point `retune` measures against.

    >>> s = TopologySpec.parse("chip:4 x host:2@50e9 x pod:2@25e9")
    >>> c = annotated_level_costs(s, param_bytes=100e9)
    >>> c["host"], c["_outer"]
    (2.0, 4.0)
    """
    costs: Dict[str, float] = {}
    for lvl in spec.levels[1:-1]:
        if spec.group_size(lvl.name) == 1:
            continue  # elided from the schedule: nothing to retune
        costs[lvl.name] = param_bytes / lvl.bandwidth
    costs[OUTER_KEY] = param_bytes / spec.outer.bandwidth
    return costs


def measured_bandwidths(spec: TopologySpec, costs: Dict[str, float],
                        param_bytes: float = 4e6) -> Dict[str, float]:
    """Measured costs turned back into bytes/s by spec level name, the
    ``bandwidths`` that `derive_inner_periods` takes. Non-positive costs
    are dropped (a failed probe leaves the annotation in force).

    >>> s = TopologySpec.parse("chip:4 x host:2@50e9 x pod:2@25e9")
    >>> bw = measured_bandwidths(s, {"host": 2.0, "_outer": 4.0},
    ...                          param_bytes=100e9)
    >>> bw["host"], bw["pod"]
    (50000000000.0, 25000000000.0)
    """
    out: Dict[str, float] = {}
    for name, t in costs.items():
        if not t or t <= 0:
            continue
        out[spec.outer.name if name == OUTER_KEY else name] = param_bytes / t
    return out


def derive_retuned_periods(spec: TopologySpec, costs: Dict[str, float], *,
                           b_max: int = 4,
                           param_bytes: float = 4e6) -> Dict[str, int]:
    """The inner periods from measured costs: the static lowering's
    bandwidth-ratio rule with measurements in place of annotations.
    ``%period`` pins keep winning.

    Annotated costs give the static schedule:

    >>> from repro_torch.topo.lower import derive_inner_periods
    >>> s = TopologySpec.parse("chip:4 x host:2@50e9 x pod:2@25e9")
    >>> (derive_retuned_periods(s, annotated_level_costs(s))
    ...  == derive_inner_periods(s, b_max=4))
    True

    A host link measured at a quarter of its speed syncs less often:

    >>> c = annotated_level_costs(s)
    >>> c["host"] *= 4
    >>> derive_retuned_periods(s, c)
    {'host': 4}
    """
    from repro_torch.topo.lower import derive_inner_periods
    return derive_inner_periods(
        spec, b_max=b_max,
        bandwidths=measured_bandwidths(spec, costs, param_bytes=param_bytes))


@dataclass(frozen=True)
class ProbeResult:
    """One active-probe round: measured seconds per sync by level (keys as
    in `annotated_level_costs`), the sum of each level's output (a witness
    of the numbers: two probes of one device give the same sums), the
    rounds timed and the bytes of the probe's arena (every replica's row)."""
    costs: Dict[str, float]
    checksums: Dict[str, float]
    rounds: int
    param_bytes: float


def _wait(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def active_probe(spec: TopologySpec, *, n_values: int = 1 << 12,
                 rounds: int = 3, mask=None, device="cpu") -> ProbeResult:
    """Time one real `level_group_mean` per replica level on `device`.

    The arena holds ``n_values`` f32 values per replica (the reference's
    values), and each level runs the group mean its schedule runs (its
    group size, the membership `mask`, the chain of adds): once to warm up,
    then `rounds` times, each call between two waits for the device, and
    the least time is kept. The costs go to `HierDasoController.retune`
    against `annotated_level_costs(spec, result.param_bytes)`."""
    from repro_torch.core.daso import level_group_mean

    device = torch.device(device)
    r = spec.n_replicas
    arena = (torch.arange(r * n_values, dtype=torch.float32, device=device)
             .reshape(r, n_values) / float(r * n_values))
    tree = {"probe": arena}
    targets = [(lvl.name, spec.group_size(lvl.name)) for lvl in spec.levels[1:-1]
               if spec.group_size(lvl.name) > 1]
    targets.append((OUTER_KEY, r))
    rounds = max(1, rounds)
    costs: Dict[str, float] = {}
    checksums: Dict[str, float] = {}
    for name, g in targets:
        out = level_group_mean(tree, g, mask=mask)  # the warm-up
        checksums[name] = float(out["probe"].sum())
        best = float("inf")
        for _ in range(rounds):
            _wait(device)
            t0 = time.perf_counter()
            level_group_mean(tree, g, mask=mask)
            _wait(device)
            best = min(best, time.perf_counter() - t0)
        costs[name] = best
    return ProbeResult(costs=costs, checksums=checksums, rounds=rounds,
                       param_bytes=float(arena.numel() * 4))


def fit_level_costs(samples: Iterable[Tuple[str, float]]) -> Dict[str, float]:
    """The passive probe: each level's cost from ``(level name, seconds)``
    samples of the sync spans a traced run records. The per-level median,
    which one-off spikes (a build, a checkpoint) do not move.

    >>> fit_level_costs([("host", 2.0), ("host", 100.0), ("host", 2.5),
    ...                  ("_outer", 4.0)])
    {'host': 2.5, '_outer': 4.0}
    """
    by_level: Dict[str, list] = {}
    for name, s in samples:
        by_level.setdefault(name, []).append(float(s))
    out: Dict[str, float] = {}
    for name, xs in by_level.items():
        xs = sorted(xs)
        n = len(xs)
        out[name] = xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])
    return out


def skew_permutation(slowdowns: Sequence[float], *,
                     rel_tol: float = 0.1) -> Optional[Tuple[int, ...]]:
    """The regrouping by speed: slots in order of slowdown (stable, so
    replicas of one speed keep their order). Consecutive slots share an
    inner group (`DasoStrategy.set_group_permutation`), so a straggler's
    inner barrier holds back only its own group (`wasted_wait_s`).

    A skew within `rel_tol` (max / min - 1) gives None: the unpermuted
    path, so noise rebuilds nothing.

    >>> skew_permutation([1.0, 3.0, 1.0, 3.0])
    (0, 2, 1, 3)
    >>> skew_permutation([1.0, 1.02, 0.99, 1.0]) is None
    True
    """
    xs = [float(s) for s in slowdowns]
    if not xs or min(xs) <= 0:
        return None
    if max(xs) / min(xs) - 1.0 <= rel_tol:
        return None
    return tuple(sorted(range(len(xs)), key=lambda i: (xs[i], i)))


def wasted_wait_s(slowdowns: Sequence[float], mask, group_size: int,
                  perm: Optional[Tuple[int, ...]],
                  t_compute_s: float) -> float:
    """Per-step straggler wait an inner-group barrier wastes: every active
    replica waits for its group's slowest member, so the waste is
    ``sum_r (group_max_slowdown - own_slowdown) * t_compute``. The global
    makespan is gated by the worst straggler regardless; this is the slack
    a regrouping could win back.

    >>> wasted_wait_s([1.0, 3.0, 1.0, 3.0], None, 2, None, 1.0)
    4.0
    >>> wasted_wait_s([1.0, 3.0, 1.0, 3.0], None, 2, (0, 2, 1, 3), 1.0)
    0.0
    """
    n = len(slowdowns)
    order = list(perm) if perm is not None else list(range(n))
    total = 0.0
    for g0 in range(0, n, max(1, group_size)):
        members = order[g0:g0 + max(1, group_size)]
        active = [r for r in members if mask is None or mask[r]]
        if not active:
            continue
        worst = max(slowdowns[r] for r in active)
        total += sum(worst - slowdowns[r] for r in active)
    return total * t_compute_s
