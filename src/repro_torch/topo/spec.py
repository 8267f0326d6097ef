"""Declarative N-level cluster topology (`repro/topo/spec.py`, copied whole:
the reference module is pure Python, and the port imports nothing of it).

A `TopologySpec` describes the bandwidth hierarchy of a cluster as an
ordered list of *levels*, innermost first: each level names one tier of the
interconnect (chip-to-chip NVLink, host-to-host rack network, pod-to-pod
DCN, ...), its fanout (how many child units one unit of the next level up
contains), and the bandwidth/latency of the links crossed when units at that
level talk to each other. DS-Sync (arXiv 2007.03298) and the Hitchhiker's
Guide survey (arXiv 1810.11787) both observe that real clusters have more
than the two tiers the original DASO paper models. The port lowers a spec
onto the DASO control plane (step variants, sync schedule;
`repro_torch.topo.lower`) and resolves fault plans' node paths against it
(`repro_torch.resilience.faults`), and the multi-process runtime places
its replica axis over processes, each owning whole subtrees
(`repro_torch.launch.mesh`, `launch/distributed.py`). The reference's
device mesh has no counterpart: the port has no device mesh to lower to.

Spec grammar (one level per segment, segments joined by ``x``/``×``/``,``,
innermost first)::

    level   := NAME ":" FANOUT ["@" BANDWIDTH ["/" LATENCY]] ["%" PERIOD]
    NAME    := lowercase identifier, unique per spec
    FANOUT  := int >= 1   (units of the previous level per unit of this one;
                           for the outermost level: total units)
    BANDWIDTH := float, bytes/s per link at this level
    LATENCY := float, seconds per message at this level
    PERIOD  := int >= 1, sync this level every PERIOD steps (B_l); for the
               outermost level this overrides b_max of the plateau schedule

Omitted bandwidth/latency default per depth (NVLink-ish innermost, DCN-ish
outermost — `DEFAULT_BANDWIDTHS` / `DEFAULT_LATENCIES`); an omitted period
is derived from the bandwidth ratios at lowering time
(`repro_torch.topo.lower.derive_inner_periods`).

Usage:

>>> spec = TopologySpec.parse("chip:4 x host:2 x pod:2")
>>> [lvl.name for lvl in spec.levels]
['chip', 'host', 'pod']
>>> spec.local_world, spec.n_replicas, spec.world
(4, 4, 16)
>>> spec.group_size("host"), spec.group_size("pod")
(2, 4)
>>> spec.replicas_of("pod1")
(2, 3)
>>> spec.replicas_of("pod1/host0")
(2,)
>>> TopologySpec.parse(spec.to_str()) == spec
True

The paper's original two-level layout is just the 2-level spec:

>>> two = TopologySpec.parse("chip:16 x pod:2")
>>> two.n_replicas, two.inner_names()
(2, ())
"""
from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

# Per-depth defaults, innermost first: NVLink-class chip interconnect, ICI /
# rack-network host links, DCN pod links; each level beyond the third is
# another order of magnitude slower (WAN-ish). Matched to the constants the
# reference's analytic cluster model uses (its benchmarks/comm_model.py and
# launch/mesh.py).
DEFAULT_BANDWIDTHS = (600e9, 50e9, 25e9)
DEFAULT_LATENCIES = (1e-6, 10e-6, 30e-6)

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")
_LEVEL_RE = re.compile(
    r"^(?P<name>[a-z][a-z0-9_]*):(?P<fanout>\d+)"
    r"(?:@(?P<bw>[0-9.eE+-]+)(?:/(?P<lat>[0-9.eE+-]+))?)?"
    r"(?:%(?P<period>\d+))?$")
# the ascii 'x' separator needs surrounding whitespace (level names may
# legally contain 'x' — "proxy:4 x pod:2"); '×' and ',' cannot appear in
# names, so they separate with or without spaces
_SEP_RE = re.compile(r"\s+x\s+|\s*[×,]\s*")


def default_bandwidth(i: int) -> float:
    """Default link bandwidth of level `i` (innermost = 0), bytes/s."""
    if i < len(DEFAULT_BANDWIDTHS):
        return DEFAULT_BANDWIDTHS[i]
    return DEFAULT_BANDWIDTHS[-1] / 10 ** (i - len(DEFAULT_BANDWIDTHS) + 1)


def default_latency(i: int) -> float:
    """Default per-message latency of level `i` (innermost = 0), seconds."""
    if i < len(DEFAULT_LATENCIES):
        return DEFAULT_LATENCIES[i]
    return DEFAULT_LATENCIES[-1] * 10 ** (i - len(DEFAULT_LATENCIES) + 1)


@dataclass(frozen=True)
class Level:
    """One tier of the bandwidth hierarchy.

    `fanout` counts units of the previous (inner) level per unit of this
    level; for the outermost level it is the total number of its units.
    `bandwidth`/`latency` describe the links crossed when this level's
    units exchange data (e.g. the host level's bandwidth is the
    host-to-host rack network). `period` is the explicit sync period B_l
    (None = derive from bandwidth ratios at lowering)."""
    name: str
    fanout: int
    bandwidth: float
    latency: float
    period: Optional[int] = None

    def __post_init__(self):
        if not _NAME_RE.match(self.name):
            raise ValueError(f"level name {self.name!r} must be a lowercase "
                             "identifier ([a-z][a-z0-9_]*)")
        if self.fanout < 1:
            raise ValueError(f"level {self.name!r}: fanout must be >= 1, "
                             f"got {self.fanout}")
        if self.bandwidth <= 0:
            raise ValueError(f"level {self.name!r}: bandwidth must be > 0, "
                             f"got {self.bandwidth}")
        if self.latency < 0:
            raise ValueError(f"level {self.name!r}: latency must be >= 0, "
                             f"got {self.latency}")
        if self.period is not None and self.period < 1:
            raise ValueError(f"level {self.name!r}: period must be >= 1, "
                             f"got {self.period}")

    def to_str(self) -> str:
        s = f"{self.name}:{self.fanout}@{self.bandwidth:g}/{self.latency:g}"
        if self.period is not None:
            s += f"%{self.period}"
        return s


@dataclass(frozen=True)
class TopologySpec:
    """An N-level cluster topology, levels innermost first.

    Level 0 is the intra-replica tier (the paper's GPUs-per-node: the
    `data` mesh axis that the loss-mean gradient all-reduce crosses every
    step). Levels 1..N-1 are the *replica levels*: their fanout product is
    the replica-axis size R, with inner levels varying fastest in the
    replica index (replica r of a ``chip x host x pod`` spec sits in
    ``pod r // f_host, host r % f_host``)."""
    levels: Tuple[Level, ...]

    def __post_init__(self):
        if len(self.levels) < 2:
            raise ValueError("a topology needs at least 2 levels (the "
                             "intra-replica tier plus one replica level); "
                             f"got {len(self.levels)}")
        names = [lvl.name for lvl in self.levels]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate level names in {names}")

    # -- derived structure ---------------------------------------------------
    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @property
    def local_world(self) -> int:
        """Fanout of level 0: workers inside one replica (paper
        GPUs-per-node)."""
        return self.levels[0].fanout

    @property
    def replica_levels(self) -> Tuple[Level, ...]:
        """Levels 1..N-1 — the tiers the replica axis spans."""
        return self.levels[1:]

    @property
    def n_replicas(self) -> int:
        """Replica-axis size R: product of the replica-level fanouts."""
        r = 1
        for lvl in self.replica_levels:
            r *= lvl.fanout
        return r

    @property
    def world(self) -> int:
        """Total workers (paper's P): product of every fanout."""
        return self.local_world * self.n_replicas

    @property
    def outer(self) -> Level:
        """The outermost (slowest) level — the one the plateau-driven DASO
        schedule drives asynchronously."""
        return self.levels[-1]

    def inner_names(self) -> Tuple[str, ...]:
        """Names of the intermediate replica levels (between level 0 and
        the outermost), innermost first — the levels that get synchronous
        per-level group syncs every B_l steps. Empty for a 2-level spec."""
        return tuple(lvl.name for lvl in self.levels[1:-1])

    def level(self, name: str) -> Level:
        for lvl in self.levels:
            if lvl.name == name:
                return lvl
        raise KeyError(f"no level named {name!r}; levels: "
                       f"{[lvl.name for lvl in self.levels]}")

    def level_index(self, name: str) -> int:
        for i, lvl in enumerate(self.levels):
            if lvl.name == name:
                return i
        raise KeyError(f"no level named {name!r}")

    def group_size(self, name: str) -> int:
        """Replica-group size of a sync at replica level `name`: the number
        of replicas one unit of that level contains
        (prod of replica-level fanouts up to and including it). Syncing the
        outermost level groups all R replicas — the legacy global
        exchange."""
        i = self.level_index(name)
        if i == 0:
            raise ValueError(f"level {name!r} is the intra-replica tier; "
                             "it syncs implicitly every step (the gradient "
                             "all-reduce), not as a replica group")
        g = 1
        for lvl in self.levels[1:i + 1]:
            g *= lvl.fanout
        return g

    def mesh_axis_names(self) -> Tuple[str, ...]:
        """Mesh axes of the lowered mesh, outermost level first (the
        conventional major-to-minor device order); plain names here: the
        port places processes by replica blocks (`launch/mesh.py`), not
        on a device mesh."""
        return tuple(lvl.name for lvl in reversed(self.levels))

    def mesh_shape(self) -> Tuple[int, ...]:
        return tuple(lvl.fanout for lvl in reversed(self.levels))

    # -- node addressing -----------------------------------------------------
    def replicas_of(self, node: str) -> Tuple[int, ...]:
        """Replica indices inside a topology node.

        `node` is a "/"-joined path of ``<level-name><index>`` segments,
        outermost level first, descending contiguously: ``"pod1"`` is every
        replica of pod 1, ``"pod1/host0"`` narrows to host 0 of pod 1.
        Level 0 units cannot be addressed (they live inside a replica).
        Fault plans use these paths to crash whole subtrees
        (resilience/faults.py::FaultPlan.resolve)."""
        segs = node.strip().split("/")
        lo, hi = 0, self.n_replicas
        expect = len(self.levels) - 1  # index into self.levels, walking in
        for seg in segs:
            # match against the actual level names (longest-name aware —
            # a level may itself end in a digit, e.g. "tier2" so that
            # "tier21" is tier2 unit 1), preferring the level expected
            # next in the outermost-first descent
            matches = [(i, int(seg[len(lvl.name):]))
                       for i, lvl in enumerate(self.levels)
                       if seg.startswith(lvl.name)
                       and seg[len(lvl.name):].isdigit()]
            if not matches:
                raise ValueError(
                    f"bad node segment {seg!r}; expected "
                    "<level-name><index> with a level name from "
                    f"{[lvl.name for lvl in self.levels]}")
            chosen = next(((i, idx) for i, idx in matches if i == expect),
                          matches[0])
            i, idx = chosen
            if i == 0:
                raise ValueError(f"segment {seg!r} addresses the "
                                 "intra-replica tier; the finest faultable "
                                 f"unit is {self.levels[1].name!r}")
            if i != expect:
                raise ValueError(
                    f"segment {seg!r} out of order: expected level "
                    f"{self.levels[expect].name!r} next (paths descend "
                    "outermost-first without skipping)")
            if not 0 <= idx < self.levels[i].fanout:
                raise ValueError(f"segment {seg!r}: index {idx} outside "
                                 f"0..{self.levels[i].fanout - 1}")
            span = (hi - lo) // self.levels[i].fanout
            lo, hi = lo + idx * span, lo + (idx + 1) * span
            expect = i - 1
        return tuple(range(lo, hi))

    # -- serialization -------------------------------------------------------
    @classmethod
    def parse(cls, text: str) -> "TopologySpec":
        """Parse the spec grammar (see module docstring)."""
        segs = [s for s in _SEP_RE.split(text.strip()) if s]
        if not segs:
            raise ValueError(f"empty topology spec {text!r}")
        levels = []
        for i, seg in enumerate(segs):
            m = _LEVEL_RE.match(seg)
            if not m:
                raise ValueError(
                    f"bad level segment {seg!r}; expected "
                    "name:fanout[@bandwidth[/latency]][%period]")
            # per-depth defaults; the OUTERMOST level is the cross-cluster
            # tier and defaults to (at least) the DCN class even in
            # shallow specs, matching the legacy ICI/DCN pair
            di = max(i, 2) if i == len(segs) - 1 else i
            bw = (float(m.group("bw")) if m.group("bw")
                  else default_bandwidth(di))
            lat = (float(m.group("lat")) if m.group("lat")
                   else default_latency(di))
            period = int(m.group("period")) if m.group("period") else None
            levels.append(Level(name=m.group("name"),
                                fanout=int(m.group("fanout")),
                                bandwidth=bw, latency=lat, period=period))
        return cls(tuple(levels))

    def to_str(self) -> str:
        """Canonical spec string; `parse` round-trips it exactly."""
        return " x ".join(lvl.to_str() for lvl in self.levels)

    def to_json(self) -> str:
        return json.dumps({"levels": [
            {k: v for k, v in
             (("name", lvl.name), ("fanout", lvl.fanout),
              ("bandwidth", lvl.bandwidth), ("latency", lvl.latency),
              ("period", lvl.period)) if v is not None}
            for lvl in self.levels]}, indent=1)

    @classmethod
    def from_json(cls, text: str) -> "TopologySpec":
        doc = json.loads(text)
        return cls(tuple(Level(**d) for d in doc["levels"]))

    @classmethod
    def load(cls, spec: str) -> "TopologySpec":
        """Resolve any user-facing spelling: a JSON file path, inline JSON
        (starts with '{'), or the spec grammar string. This is what
        ``launch/train.py --topology`` and `TrainLoopConfig.topology`
        accept."""
        if os.path.exists(spec):
            with open(spec) as f:
                return cls.from_json(f.read())
        if spec.lstrip().startswith("{"):
            return cls.from_json(spec)
        return cls.parse(spec)

    # -- legacy bridge -------------------------------------------------------
    @classmethod
    def two_level(cls, *, local_world: int, n_replicas: int,
                  inner_name: str = "chip",
                  outer_name: str = "pod") -> "TopologySpec":
        """The implicit pre-topology layout as an explicit spec: one
        intra-replica tier of `local_world` workers, one replica level of
        `n_replicas` units. Lowering this reproduces the legacy two-level
        DASO bit for bit (tests/test_torch_topology.py)."""
        return cls((Level(inner_name, local_world, default_bandwidth(0),
                          default_latency(0)),
                    Level(outer_name, n_replicas, default_bandwidth(2),
                          default_latency(2))))

    def inner_periods_explicit(self) -> Dict[str, int]:
        """Explicit `%period` overrides of the intermediate levels (the
        derived schedule fills the rest — repro_torch.topo.lower)."""
        return {lvl.name: lvl.period for lvl in self.levels[1:-1]
                if lvl.period is not None}
