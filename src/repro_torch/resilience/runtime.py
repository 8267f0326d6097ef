"""Live fault-tolerance runtime: the health plane of a supervised
multi-process run (`repro/resilience/runtime.py`, copied: the reference
module uses the standard library only, and the port imports nothing of it).

`resilience/supervisor.py` replays crashes on the simulated clock; this
module turns those semantics into a guarantee on the real process group
(`launch/distributed.py`): every worker of a supervised group runs a
`HealthMonitor`, and `launch/procs.py`'s supervisor mode reads what it
writes. Three mechanisms:

  * **heartbeats**: a daemon thread writes ``hb_{epoch}_{proc}.json`` into
    the shared run directory every `hb_interval` seconds: proc id, epoch,
    the last completed training step and a phase tag ("init" -> "train"
    -> "done"). The launcher uses them to fire `--kill proc:step` at a
    training step and to time detection and recovery.
  * **collective watchdog**: the same thread bounds progress. The training
    loop must complete a cycle (or announce a phase) every `watchdog_s`
    seconds, else the process writes a status marker and hard-exits with
    `EXIT_PEER_LOST`. With gloo a dead peer usually turns a survivor's
    collective into an error, which the launcher maps to the same exit
    (`launch/distributed.py::PeerLostError`); the watchdog is the backstop
    for a collective that hangs instead. One progress rule covers every
    blocking region (cycles, checkpoint gathers, the group's start), as
    they all sit between progress reports.
  * **regroup protocol**: on a detected death the launcher tears the epoch
    down and relaunches the survivors under a fresh coordinator epoch (new
    port, `DASO_EPOCH` + 1) with a ``regroup.json`` naming the dead
    replicas. The new epoch resumes from the newest intact TrainState
    (checkpoint/io.py's crash-safe loaders) and replays the death as a
    membership crash event at the resume step, which is why the regrouped
    run is bit for bit the simulated fault-plan oracle for the same crash.

Workers keep spanning every replica after a regroup (fewer processes, more
rows each): the step variants and the masked-ghost numbers are those of
the run before the crash, by the N-process == one-process contract.
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

# exit code a worker uses when ITS watchdog detects lost progress (a dead
# peer wedging a collective). Distinct from crash codes so the launcher can
# tell "I detected a peer loss" from "I am the root failure".
EXIT_PEER_LOST = 75

ENV_RUN_DIR = "DASO_RUN_DIR"
ENV_EPOCH = "DASO_EPOCH"
ENV_WATCHDOG_S = "DASO_WATCHDOG_S"
ENV_HB_INTERVAL = "DASO_HB_INTERVAL"
ENV_REGROUP_FILE = "DASO_REGROUP_FILE"

DEFAULT_WATCHDOG_S = 300.0   # must exceed the worst single blocking region
DEFAULT_HB_INTERVAL = 0.25   # (the first cycle, kernel builds included)


def heartbeat_path(run_dir: str, epoch: int, proc_id: int) -> str:
    return os.path.join(run_dir, f"hb_{epoch}_{proc_id}.json")


def status_path(run_dir: str, epoch: int, proc_id: int) -> str:
    return os.path.join(run_dir, f"status_{epoch}_{proc_id}.json")


@dataclass(frozen=True)
class HealthConfig:
    """Supervision parameters, exported by the launcher's supervisor mode
    (`launch/procs.py --kill / --supervise`) through the environment.
    `from_env` returns None in unsupervised runs — the health plane costs
    nothing unless a supervisor asked for it."""
    run_dir: str
    epoch: int = 0
    watchdog_s: float = DEFAULT_WATCHDOG_S
    hb_interval: float = DEFAULT_HB_INTERVAL
    regroup_file: Optional[str] = None

    @classmethod
    def from_env(cls) -> Optional["HealthConfig"]:
        run_dir = os.environ.get(ENV_RUN_DIR)
        if not run_dir:
            return None
        return cls(run_dir=run_dir,
                   epoch=int(os.environ.get(ENV_EPOCH, "0")),
                   watchdog_s=float(os.environ.get(
                       ENV_WATCHDOG_S, str(DEFAULT_WATCHDOG_S))),
                   hb_interval=float(os.environ.get(
                       ENV_HB_INTERVAL, str(DEFAULT_HB_INTERVAL))),
                   regroup_file=os.environ.get(ENV_REGROUP_FILE) or None)


class HealthMonitor:
    """Per-worker heartbeat writer + progress watchdog (one daemon thread).

    The training loop reports progress via `phase(name)` and
    `cycle_done(step)` (the executor calls the latter after every compiled
    cycle — core/executor.py::dispatch_planned_cycle). Each report pushes
    the watchdog deadline out by `watchdog_s`; if the deadline passes the
    thread writes a status marker and `os._exit(EXIT_PEER_LOST)` — an
    ordinary exception could never unwind a thread that is parked inside a
    gloo collective."""

    def __init__(self, cfg: HealthConfig, proc_id: int, *, tracer=None):
        self.cfg = cfg
        self.proc_id = proc_id
        # obs.trace sink: phase flips become "phase" instants in the run
        # trace, so launcher-observed detection timings line up with the
        # worker's own record (None = untraced, zero cost)
        self.tracer = tracer
        self._lock = threading.Lock()
        self._phase = "start"
        self._step = -1
        self._deadline = time.monotonic() + cfg.watchdog_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- progress reports (called from the training thread) ---------------
    def phase(self, name: str) -> None:
        with self._lock:
            self._phase = name
            self._deadline = time.monotonic() + self.cfg.watchdog_s
        self._write()  # phase flips are rare and the launcher times them
        if self.tracer is not None:
            self.tracer.instant("phase", cat="resilience", phase=name,
                                epoch=self.cfg.epoch)

    def cycle_done(self, step: int) -> None:
        with self._lock:
            self._step = step
            self._deadline = time.monotonic() + self.cfg.watchdog_s

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "HealthMonitor":
        os.makedirs(self.cfg.run_dir, exist_ok=True)
        self._write()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="daso-health")
        self._thread.start()
        return self

    def close(self) -> None:
        """Normal shutdown: disarm the watchdog, write a final beat."""
        self._stop.set()
        with self._lock:
            self._phase = "done"
        self._write()
        if self.tracer is not None:
            self.tracer.instant("phase", cat="resilience", phase="done",
                                epoch=self.cfg.epoch)
        if self._thread is not None:
            self._thread.join(timeout=2 * self.cfg.hb_interval + 1)

    # -- internals ---------------------------------------------------------
    def _write(self) -> None:
        with self._lock:
            doc = {"proc": self.proc_id, "epoch": self.cfg.epoch,
                   "phase": self._phase, "step": self._step,
                   "t": time.time()}
        path = heartbeat_path(self.cfg.run_dir, self.cfg.epoch,
                              self.proc_id)
        tmp = f"{path}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)  # readers never see a torn beat
        except OSError:
            pass  # a missed beat is survivable; a crashed writer is not

    def _run(self) -> None:
        while not self._stop.wait(self.cfg.hb_interval):
            self._write()
            with self._lock:
                expired = time.monotonic() > self._deadline
                phase, step = self._phase, self._step
            if expired:
                try:
                    with open(status_path(self.cfg.run_dir, self.cfg.epoch,
                                          self.proc_id), "w") as f:
                        json.dump({"proc": self.proc_id,
                                   "reason": "watchdog",
                                   "phase": phase, "step": step,
                                   "watchdog_s": self.cfg.watchdog_s,
                                   "t": time.time()}, f)
                except OSError:
                    pass
                os._exit(EXIT_PEER_LOST)


def read_heartbeat(run_dir: str, epoch: int, proc_id: int) -> Optional[dict]:
    """Launcher-side: latest beat of one worker, None before its first."""
    try:
        with open(heartbeat_path(run_dir, epoch, proc_id)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def snapshot_heartbeats(run_dir: str, epoch: int, n_procs: int) -> dict:
    """One fleet-wide heartbeat snapshot: proc id -> latest beat document
    (processes that have not beaten yet are omitted)."""
    out = {}
    for p in range(n_procs):
        doc = read_heartbeat(run_dir, epoch, p)
        if doc is not None:
            out[p] = doc
    return out


def heartbeat_skew(before: dict, after: dict, *,
                   min_dt_s: float = 0.0) -> dict:
    """Per-process relative slowdown from two heartbeat snapshots
    (`snapshot_heartbeats` taken a probe interval apart): each process's
    step-progress rate between the snapshots, normalized so the fastest
    process reads 1.0 — a process advancing at half the fastest rate reads
    2.0, the same unit as the fault plan's straggle factors. Processes
    without usable progress in both snapshots are omitted.

    This is the live-runtime skew source for the straggler-aware group
    reshuffle: the launcher maps process ids to the replicas they own and
    hands the slowdown vector to the reference's `topo/probe.py::skew_permutation`
    (ROADMAP item 18 in the port)
    (simulated runs use the fault plan's injected slowdowns directly —
    resilience/supervisor.py)."""
    rates = {}
    for p, b in before.items():
        a = after.get(p)
        if a is None:
            continue
        dt = float(a["t"]) - float(b["t"])
        ds = int(a["step"]) - int(b["step"])
        if dt <= min_dt_s or ds <= 0:
            continue
        rates[p] = ds / dt
    if not rates:
        return {}
    fastest = max(rates.values())
    return {p: fastest / r for p, r in rates.items()}


#: heartbeat wire format: required key -> type check. This IS the schema —
#: the launcher's kill/supervise triggers key off `phase`/`step`, and the
#: trace streams are written next to these files, so the two planes share
#: one compatibility stance: required keys are stable, extra keys are
#: always tolerated (tests/test_obs.py round-trips both directions).
HEARTBEAT_SCHEMA = {
    "proc": lambda v: isinstance(v, int) and v >= 0,
    "epoch": lambda v: isinstance(v, int) and v >= 0,
    "phase": lambda v: isinstance(v, str) and bool(v),
    "step": lambda v: isinstance(v, int),
    "t": lambda v: isinstance(v, (int, float)) and v >= 0,
}


def validate_heartbeat(doc) -> Optional[str]:
    """Schema check for one heartbeat document; error string or None.
    Unknown keys pass — forward compatibility is part of the contract."""
    if not isinstance(doc, dict):
        return f"heartbeat is {type(doc).__name__}, not an object"
    for key, ok in HEARTBEAT_SCHEMA.items():
        if key not in doc:
            return f"missing required key {key!r}"
        if not ok(doc[key]):
            return f"bad value for {key!r}: {doc[key]!r}"
    return None


# -- regroup protocol ---------------------------------------------------------

@dataclass(frozen=True)
class RegroupPlan:
    """What the launcher tells a regrouped epoch: which replicas died
    (root-cause processes' subtrees — collateral aborts keep their state),
    and whether the restarted ranks should rejoin (elastic mode). The
    crash/rejoin *step* is deliberately absent: it is defined as the resume
    step of the newest intact TrainState, which only the workers can
    determine (the supervisor cannot know which snapshot survived the
    crash intact)."""
    epoch: int
    dead_replicas: tuple
    rejoin: bool = False

    def to_json(self) -> str:
        return json.dumps({"epoch": self.epoch,
                           "dead_replicas": list(self.dead_replicas),
                           "rejoin": self.rejoin}, indent=1)


def save_regroup(path: str, plan: RegroupPlan) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(plan.to_json())
    os.replace(tmp, path)


def load_regroup(path: str) -> RegroupPlan:
    with open(path) as f:
        doc = json.load(f)
    return RegroupPlan(epoch=int(doc["epoch"]),
                       dead_replicas=tuple(int(r)
                                           for r in doc["dead_replicas"]),
                       rejoin=bool(doc.get("rejoin", False)))


def regroup_fault_events(resume_step: int,
                         membership: Optional[Sequence[float]],
                         dead_replicas: Sequence[int], *,
                         rejoin: bool = False) -> List:
    """Translate a RegroupPlan into membership fault events at the resume step.

    A crash is replayed only for replicas still ACTIVE in the resumed
    membership — a checkpoint taken after an earlier regroup already has
    the victim masked out, and re-crashing a dead replica is (rightly)
    rejected by FaultPlan.validate. With `rejoin`, every dead replica also
    rejoins at the same step: FaultPlan orders crash before rejoin at equal
    steps, so the restarted rank is re-seeded from the survivors' mean
    (resilience/membership.py) exactly as a simulated rejoin would be."""
    from repro_torch.resilience.faults import FaultEvent

    events: List[FaultEvent] = []
    for r in dead_replicas:
        active = membership is None or membership[r] > 0.0
        if active:
            events.append(FaultEvent(step=resume_step, kind="crash",
                                     replica=int(r)))
        if rejoin:
            events.append(FaultEvent(step=resume_step, kind="rejoin",
                                     replica=int(r)))
    return events
