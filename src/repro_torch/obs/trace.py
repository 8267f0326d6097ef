"""Low-overhead span/counter tracing: one JSONL stream per process
(`repro/obs/trace.py`, copied whole: the reference module uses the
standard library only, and the port imports nothing of it). A stream
written by either package reads the same in the other, and
tools/trace_report.py reads both.

Every event is already shaped like a Chrome trace-event (the `ph`/`ts`/
`dur`/`pid`/`tid` vocabulary of the trace-event format), so merging the
per-process streams of a multi-process run is pure line concatenation +
sort, and exporting to a Perfetto/chrome://tracing-loadable file is just
wrapping the lines in ``{"traceEvents": [...]}`` (tools/trace_report.py).

Design constraints, in order:

  * **cheap when off** — callers hold a tracer unconditionally; the shared
    `NULL_TRACER` makes every call a no-op (its `span` returns a reusable
    do-nothing context manager, no allocation per call).
  * **cheap when on** — events are appended to an in-memory list under a
    lock (the resilience heartbeat thread and the training thread both
    write) and flushed to disk every `flush_every` events; the tracer
    accounts its own cumulative cost in `overhead_s` so the tracing-
    overhead claim is self-measured, not inferred.
  * **merge-aligned timestamps** — `ts` is wall-clock microseconds
    (`time.time_ns() // 1000`): processes of one run share the host clock,
    so merged streams interleave correctly; `dur` comes from
    `perf_counter` so span lengths are monotonic-clock accurate.

Span taxonomy (the `cat` field; docs/observability.md has the full table):

  executor    compiled-cycle dispatch, compiles, overlap exchange legs,
              tail-fallback steps (core/executor.py)
  schedule    controller decision events: plateau-driven B/W changes,
              membership/DCN notifications, each with a `reason`
              (core/schedule.py)
  resilience  health-plane phase changes, fault events, regroup replay
              (resilience/supervisor.py; resilience/runtime.py, the
              live plane of launch/procs.py's supervised runs)
  checkpoint  TrainState saves (train/loop.py)
  meter       comm-accounting counter snapshots (obs/meters.py readings)
  meta        the run_metadata event: topology, wire format, parameter
              bytes — what tools/trace_report.py needs to price the model
              side of its drift table
"""
from __future__ import annotations

import glob as _glob
import json
import os
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional

# event phases we emit/accept: X = complete span (ts + dur), i = instant,
# C = counter, M = metadata (process_name etc.)
PHASES = ("X", "i", "C", "M")

#: the one metadata event every stream opens with — trace_report reads the
#: run configuration (topology, param bytes, wire format) out of its args
RUN_METADATA = "run_metadata"


def stream_path(base: str, proc_id: int, epoch: int = 0) -> str:
    """Per-process JSONL stream path for a run whose merged trace is
    `base`: ``{base}.e{epoch}p{proc}.jsonl`` — epoch-tagged so a supervised
    regroup (fresh coordinator epoch, same run dir) never overwrites the
    pre-crash epoch's stream."""
    return f"{base}.e{epoch}p{proc_id}.jsonl"


class _NullSpan:
    """Reusable no-op context manager (one shared instance, no per-call
    allocation)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """API-complete no-op tracer; the default everywhere a tracer can be
    threaded so call sites never branch."""
    enabled = False
    overhead_s = 0.0
    n_events = 0

    def span(self, name: str, cat: str = "executor", **args):
        return _NULL_SPAN

    def instant(self, name: str, cat: str = "executor", **args) -> None:
        pass

    def counter(self, name: str, values: Dict[str, float],
                cat: str = "meter") -> None:
        pass

    def metadata(self, **args) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


NULL_TRACER = NullTracer()


class _Span:
    """Context manager recording one complete ("X") event on exit."""
    __slots__ = ("tracer", "name", "cat", "args", "_ts_us", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._ts_us = time.time_ns() // 1000
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur_s = time.perf_counter() - self._t0
        self.tracer._emit({"name": self.name, "cat": self.cat, "ph": "X",
                           "ts": self._ts_us,
                           "dur": int(dur_s * 1e6),
                           "pid": self.tracer.proc_id, "tid": _tid(),
                           "args": self.args})
        return False


def _tid() -> int:
    return threading.get_ident() & 0xFFFF


class Tracer:
    """Buffered JSONL trace writer for ONE process of a run.

    `path` is this process's stream file (use `stream_path` in
    multi-process runs so the launcher can merge). Events accumulate in
    memory and hit the disk every `flush_every` events and on `close()`.
    The tracer measures its own cost: `overhead_s` is the cumulative wall
    time spent inside tracer calls (span bookkeeping + serialization +
    writes), emitted as a final `tracer_self` counter so the overhead
    claim is carried inside the trace itself."""
    enabled = True

    def __init__(self, path: str, *, proc_id: int = 0,
                 flush_every: int = 256):
        self.path = path
        self.proc_id = proc_id
        self.flush_every = flush_every
        self.overhead_s = 0.0
        self.n_events = 0
        self._buf: List[dict] = []
        self._lock = threading.Lock()
        self._closed = False
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        # truncate: one stream per (run, epoch, proc)
        with open(self.path, "w"):
            pass
        self._emit({"name": "process_name", "cat": "meta", "ph": "M",
                    "ts": time.time_ns() // 1000,
                    "pid": proc_id, "tid": _tid(),
                    "args": {"name": f"proc {proc_id}"}})

    # -- event API ---------------------------------------------------------
    def span(self, name: str, cat: str = "executor", **args) -> _Span:
        """Context manager: one complete event spanning the with-block."""
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "executor", **args) -> None:
        t0 = time.perf_counter()
        self._emit({"name": name, "cat": cat, "ph": "i", "s": "p",
                    "ts": time.time_ns() // 1000,
                    "pid": self.proc_id, "tid": _tid(), "args": args},
                   t0=t0)

    def counter(self, name: str, values: Dict[str, float],
                cat: str = "meter") -> None:
        t0 = time.perf_counter()
        self._emit({"name": name, "cat": cat, "ph": "C",
                    "ts": time.time_ns() // 1000,
                    "pid": self.proc_id, "tid": _tid(), "args": values},
                   t0=t0)

    def metadata(self, **args) -> None:
        """The run_metadata instant: emitted once per stream by the entry
        point (launch/train.py) with everything trace_report needs to
        reconstruct the run's model-side costs."""
        self.instant(RUN_METADATA, cat="meta", **args)

    # -- internals ---------------------------------------------------------
    def _emit(self, ev: dict, *, t0: Optional[float] = None) -> None:
        if t0 is None:
            t0 = time.perf_counter()
        with self._lock:
            if self._closed:
                return
            self._buf.append(ev)
            self.n_events += 1
            buf = None
            if len(self._buf) >= self.flush_every:
                buf, self._buf = self._buf, []
        if buf is not None:
            self._write(buf)
        self.overhead_s += time.perf_counter() - t0

    def _write(self, events: List[dict]) -> None:
        with open(self.path, "a") as f:
            for ev in events:
                f.write(json.dumps(ev, separators=(",", ":")))
                f.write("\n")

    def flush(self) -> None:
        with self._lock:
            buf, self._buf = self._buf, []
        if buf:
            self._write(buf)

    def close(self) -> None:
        """Final flush; appends the tracer's self-accounting counter so
        the overhead is auditable from the trace alone."""
        if self._closed:
            return
        self.counter("tracer_self",
                     {"events": self.n_events,
                      "overhead_us": self.overhead_s * 1e6},
                     cat="meta")
        with self._lock:
            self._closed = True
            buf, self._buf = self._buf, []
        self._write(buf)


# -- schema + merge (launcher/report side) ------------------------------------

def validate_event(ev) -> Optional[str]:
    """One trace event's schema check; returns an error string or None.

    The contract the CI trace-smoke lane enforces on merged run traces:
    required keys, known phase, numeric non-negative timestamps, complete
    events carry a numeric non-negative `dur`, args (when present) is an
    object. Extra keys are tolerated — the stream may grow fields without
    breaking old readers (same stance as the heartbeat wire format,
    resilience/runtime.py)."""
    if not isinstance(ev, dict):
        return f"event is {type(ev).__name__}, not an object"
    for key in ("name", "ph", "ts", "pid"):
        if key not in ev:
            return f"missing required key {key!r}"
    if not isinstance(ev["name"], str) or not ev["name"]:
        return f"name must be a non-empty string, got {ev['name']!r}"
    if ev["ph"] not in PHASES:
        return f"unknown phase {ev['ph']!r} (expected one of {PHASES})"
    if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
        return f"ts must be a non-negative number, got {ev['ts']!r}"
    if ev["ph"] == "X":
        if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
            return (f"complete event {ev['name']!r} needs a non-negative "
                    f"dur, got {ev.get('dur')!r}")
    if "args" in ev and not isinstance(ev["args"], dict):
        return f"args must be an object, got {type(ev['args']).__name__}"
    return None


def _read_stream(path: str) -> List[dict]:
    events = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i}: not JSON: {e}") from None
    return events


def merge_streams(base: str, *, keep_streams: bool = True,
                  log: Optional[Callable] = None) -> Optional[str]:
    """Merge every per-process stream of `base` (``{base}.e*p*.jsonl``)
    into the single run trace at `base`, sorted by timestamp. Returns the
    merged path, or None when no streams exist (run was not traced).
    Called by the process launcher (launch/procs.py) after the group
    exits — the only race-free merge point — and by single-process runs
    on themselves."""
    paths = sorted(_glob.glob(f"{_glob.escape(base)}.e*p*.jsonl"))
    if not paths:
        return None
    events: List[dict] = []
    for p in paths:
        events.extend(_read_stream(p))
    events.sort(key=lambda ev: ev.get("ts", 0))
    with open(base, "w") as f:
        for ev in events:
            f.write(json.dumps(ev, separators=(",", ":")))
            f.write("\n")
    if not keep_streams:
        for p in paths:
            os.remove(p)
    if log is not None:
        log(f"[trace] merged {len(paths)} stream(s), {len(events)} events "
            f"-> {base}")
    return base


def load_events(path: str) -> List[dict]:
    """Events of a merged run trace (or a single stream). When `path` does
    not exist but per-process streams do, they are merged in memory —
    tools/trace_report.py works on an un-merged run directory too."""
    if os.path.exists(path):
        return _read_stream(path)
    paths = sorted(_glob.glob(f"{_glob.escape(path)}.e*p*.jsonl"))
    if not paths:
        raise FileNotFoundError(f"no trace at {path} (and no "
                                f"{path}.e*p*.jsonl streams)")
    events: List[dict] = []
    for p in paths:
        events.extend(_read_stream(p))
    events.sort(key=lambda ev: ev.get("ts", 0))
    return events


def to_chrome(events: Iterable[dict]) -> dict:
    """Wrap merged events as a chrome://tracing / Perfetto-loadable
    trace-event JSON document."""
    return {"traceEvents": list(events), "displayTimeUnit": "ms"}
