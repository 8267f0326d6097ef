"""Straggler accounting of the topology probe (`repro/topo/probe.py`, its
pure-Python `wasted_wait_s`; the probe itself and the retune it feeds are
ROADMAP item 18)."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple


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
