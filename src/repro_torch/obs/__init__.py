"""Telemetry plane (`repro/obs/`).

`trace.py` is the span/counter API the port's layers write to — the
macro-cycle executor wraps each dispatched cycle, its overlap legs and its
checkpoint saves, the controller records decision events with reasons —
producing one JSONL trace stream per process in the reference's schema
(Chrome trace-event shaped), which tools/trace_report.py reads.

`meters.py` is the per-level communication accounting: bytes-on-the-wire
per sync level derived from the flat-buffer arena sizes, wire formats, and
the controller's `level_sync_counts`.
"""
from repro_torch.obs.trace import (NULL_TRACER, Tracer, load_events, merge_streams,
                                   stream_path, validate_event)
from repro_torch.obs.meters import (LevelMeter, crosscheck_hlo, level_bytes_report,
                                    outer_sync_split)

__all__ = [
    "NULL_TRACER", "Tracer", "load_events", "merge_streams", "stream_path",
    "validate_event", "LevelMeter", "crosscheck_hlo", "level_bytes_report",
    "outer_sync_split",
]
