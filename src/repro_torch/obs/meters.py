"""Per-level communication accounting: bytes-on-the-wire per sync level
(`repro/obs/meters.py`).

The controller already tallies *how many* steps synced each level
(`DasoController.level_sync_counts`); the wire-format accounting already
prices *one* exchange of a parameter tree (`compression.transfer_bytes`,
arena-consistent with the fused flat-buffer codecs). This module joins the
two into per-level `LevelMeter` readings — level name, sync count, group
size, wire tier, bytes per sync, total bytes — the readings a
self-tuning topology controller re-derives sync periods from (bytes/sync ÷
measured sync seconds = achieved bandwidth per level).

Two honesty checks keep the meters from drifting from reality:

  * `crosscheck_hlo` compares the priced bytes-per-sync against the
    collective operand bytes of a compiled program (the reference's
    launch/hlo_stats.collective_stats; the port's producer of those counts
    is ROADMAP item 21) — the meter is a *model* of the wire.
  * `outer_sync_split` separates blocking-phase from cycling-phase outer
    syncs, because the two cross at different wire tiers when
    `DasoConfig.wire_format` is unset (compress_blocking=bf16 default vs
    f32 non-blocking sends).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.core import compression
from repro_torch.core.schedule import Mode, split_mode, split_ov

#: outer-mode tokens that cross the wire while training blocks on them
#: (warm-up/cool-down full averages + the local-SGD hard average)
_BLOCKING_OUTER = (Mode.BLOCKING, Mode.HARD_AVG)
#: outer-mode tokens whose exchange crosses at the non-blocking wire tier
#: (paper send family, the overlap merge, and the baseline-family
#: exchanges of core/baselines.py — gossip partner copies, the EASGD center
#: pull, DOWNPOUR delta pushes — which all price their payload at
#: `wire_format_for(blocking=False)`)
_ASYNC_OUTER = (Mode.SEND, Mode.SEND_RECEIVE, Mode.OV_SYNC,
                Mode.GOSSIP, Mode.ELASTIC, Mode.PUSH)


@dataclass
class LevelMeter:
    """One sync level's communication reading over a run (or a window).

    `bytes_per_sync` is the payload one replica contributes to one group
    exchange at this level — the quantity a ring/tree all-reduce moves
    ~2x of per member, and the number the HLO cross-check compares
    against operand bytes. `measured_sync_s` is filled in from the trace
    by tools/trace_report.py, or live by the self-tuning loop — filled
    rows are exactly the passive-probe samples `topo/probe.py::
    fit_level_costs` fits a retune from (`level_cost_samples` below
    does the conversion); unfilled it is None
    and `implied_gbps` has nothing to divide."""
    level: str                     # "_outer" or an inner level name
    syncs: int                     # exchanges at this level in the window
    wire_format: str               # tier the payload crossed at
    group_size: int                # replicas averaged per exchange
    bytes_per_sync: int            # per-replica payload of one exchange
    variant: str = ""              # "" | "blocking" | "nonblocking"
    measured_sync_s: Optional[float] = field(default=None, compare=False)

    @property
    def total_bytes(self) -> int:
        return self.syncs * self.bytes_per_sync

    def implied_gbps(self) -> Optional[float]:
        """Achieved per-replica wire bandwidth in GB/s, once a measured
        sync time exists. None until trace_report (or the controller)
        fills `measured_sync_s`."""
        if not self.measured_sync_s or self.measured_sync_s <= 0:
            return None
        return self.bytes_per_sync / self.measured_sync_s / 1e9


def outer_sync_split(history: Sequence) -> Dict[str, int]:
    """Split the outer-level syncs of a controller `history` (entries
    ``(step, mode, b, w)``) into blocking vs non-blocking counts — the two
    families cross at different wire tiers under the default per-phase
    compression flags."""
    out = {"blocking": 0, "nonblocking": 0}
    for (_, mode, _, _) in history:
        base, _ = split_ov(split_mode(mode)[0])
        if base in _BLOCKING_OUTER:
            out["blocking"] += 1
        elif base in _ASYNC_OUTER:
            out["nonblocking"] += 1
    return out


def level_bytes_report(params, counts: Dict[str, int], cfg, *,
                       topo=None,
                       outer_split: Optional[Dict[str, int]] = None,
                       inner_wire: str = "f32") -> List[LevelMeter]:
    """Per-level meters for a run.

    `params` is the UNREPLICATED parameter template (one replica's tree of
    tensors — what one exchange actually ships); `counts` is
    `controller.level_sync_counts()`; `cfg` is the `DasoConfig` (wire
    tiers + int8 block); `topo` the `TopologySpec` when hierarchical
    (group sizes, and levels with zero syncs so the report always covers
    every sync level); `outer_split` from `outer_sync_split(history)`
    splits the outer row by wire tier when the two phases differ.

    Inner levels cross at `inner_wire` — `daso.level_group_mean` supports
    f32/bf16 and the hierarchy lowers to f32 by default."""
    int8_block = getattr(cfg, "int8_block", 256)

    def payload(wire: str) -> int:
        return compression.transfer_bytes(params, wire_format=wire,
                                          int8_block=int8_block)

    rows: List[LevelMeter] = []
    n_replicas = topo.n_replicas if topo is not None else 2

    # outer level: one row per wire tier actually used
    outer_total = counts.get("_outer", 0)
    wf_block = cfg.wire_format_for(blocking=True)
    wf_async = cfg.wire_format_for(blocking=False)
    if outer_split is not None and wf_block != wf_async:
        n_b = min(outer_split.get("blocking", 0), outer_total)
        n_a = outer_total - n_b
        rows.append(LevelMeter("_outer", n_b, wf_block, n_replicas,
                               payload(wf_block), variant="blocking"))
        rows.append(LevelMeter("_outer", n_a, wf_async, n_replicas,
                               payload(wf_async), variant="nonblocking"))
    else:
        # a forced cfg.wire_format (or no history to split) prices every
        # outer sync at the async tier == blocking tier
        rows.append(LevelMeter("_outer", outer_total, wf_async, n_replicas,
                               payload(wf_async)))

    inner_names = tuple(topo.inner_names()) if topo is not None else ()
    for name in inner_names:
        rows.append(LevelMeter(name, counts.get(name, 0), inner_wire,
                               topo.group_size(name), payload(inner_wire)))
    # inner levels the history saw but the spec no longer names (regroup
    # shrank the topology mid-run): still account them
    for name, n in counts.items():
        if name != "_outer" and name not in inner_names:
            rows.append(LevelMeter(name, n, inner_wire, 0,
                                   payload(inner_wire)))
    return rows


def level_cost_samples(rows: Sequence[LevelMeter]) -> List[tuple]:
    """Convert meter rows with a measured sync time into the
    ``(level, seconds)`` sample pairs `topo/probe.py::fit_level_costs`
    consumes — the passive-probe path: trace_report fills
    `measured_sync_s` from tracer sync spans, this turns the filled rows
    into retune input. Rows without a measurement are skipped.

    >>> rows = [LevelMeter("host", 4, "f32", 2, 100, measured_sync_s=2e-3),
    ...         LevelMeter("_outer", 1, "bf16", 4, 50)]
    >>> level_cost_samples(rows)
    [('host', 0.002)]
    """
    return [(r.level, float(r.measured_sync_s)) for r in rows
            if r.measured_sync_s is not None and r.measured_sync_s > 0]


def rows_as_counter(rows: Sequence[LevelMeter]) -> Dict[str, float]:
    """Flatten meters into the numeric dict a trace counter event carries
    (`Tracer.counter("comm_meters", ...)`)."""
    out: Dict[str, float] = {}
    for r in rows:
        key = r.level + (f".{r.variant}" if r.variant else "")
        out[f"{key}.syncs"] = float(r.syncs)
        out[f"{key}.bytes_per_sync"] = float(r.bytes_per_sync)
        out[f"{key}.total_bytes"] = float(r.total_bytes)
    return out


def crosscheck_hlo(rows: Sequence[LevelMeter], hlo_stats: Dict[str, dict],
                   axis_for_level: Optional[Dict[str, str]] = None, *,
                   tol: float = 0.05) -> List[dict]:
    """Compare meter payloads against the compiled program's collective
    operand bytes (the reference's `launch.hlo_stats.collective_stats`
    output, keys like ``"all-reduce@pod"``; ROADMAP item 21 ports its
    producer).

    `axis_for_level` maps a meter's level name to the mesh axis its
    exchange reduces over (``{"_outer": "pod", "host": "host"}``); when
    omitted, inner levels map to their own name and "_outer" to whichever
    collective axis no inner level claims. Returns one verdict per
    matched (level, axis): meter bytes-per-sync vs HLO bytes-per-op and
    whether they agree within `tol` relative error. Levels with no
    matching collective in the HLO (zero syncs this program, or fused
    away) are reported with ``hlo_bytes=None, ok=None`` rather than
    silently dropped."""
    per_axis: Dict[str, dict] = {}
    for key, st in hlo_stats.items():
        if key.startswith("_") or "@" not in key:
            continue
        axis = key.split("@", 1)[1]
        agg = per_axis.setdefault(axis, {"bytes": 0, "count": 0})
        agg["bytes"] += st.get("bytes", 0)
        agg["count"] += st.get("count", 0)

    if axis_for_level is None:
        inner = {r.level for r in rows if r.level != "_outer"}
        axis_for_level = {name: name for name in inner}
        unclaimed = [a for a in per_axis if a not in inner]
        if len(unclaimed) == 1:
            axis_for_level["_outer"] = unclaimed[0]

    # group variant rows: one compiled program carries one wire tier per
    # level, so a level with blocking+nonblocking meter rows is checked
    # against whichever variant the extracted program actually uses (the
    # best-matching one)
    by_level: Dict[str, List[LevelMeter]] = {}
    for r in rows:
        by_level.setdefault(r.level, []).append(r)

    verdicts: List[dict] = []
    for level, variants in by_level.items():
        axis = axis_for_level.get(level)
        st = per_axis.get(axis) if axis else None
        if not st or not st["count"]:
            verdicts.append({"level": level, "axis": axis, "variant": "",
                             "meter_bytes": variants[0].bytes_per_sync,
                             "hlo_bytes": None, "rel_err": None,
                             "ok": None})
            continue
        hlo_per_op = st["bytes"] / st["count"]
        best = min(variants,
                   key=lambda r: abs(hlo_per_op - r.bytes_per_sync))
        rel = (abs(hlo_per_op - best.bytes_per_sync)
               / max(best.bytes_per_sync, 1))
        verdicts.append({"level": level, "axis": axis,
                         "variant": best.variant,
                         "meter_bytes": best.bytes_per_sync,
                         "hlo_bytes": int(hlo_per_op),
                         "rel_err": rel, "ok": rel <= tol})
    return verdicts
