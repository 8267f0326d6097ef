"""Multi-process runtime of the port (`repro/launch/distributed.py`) on
`torch.distributed`.

The single-process port runs DASO's R replicas as a leading tensor axis of
one process. This module adds the deployment shape the paper targets: N
processes (one per host in production; `launch/procs.py` spawns local ones
for development and tests), each owning a contiguous block of replica rows
(`launch/mesh.py::process_replica_slice`), so the outermost level's global
exchange crosses real process boundaries. Four pieces:

  * `DistributedConfig` / `initialize`: the process group's identity from
    flags or the ``DASO_COORDINATOR`` / ``DASO_NUM_PROCS`` /
    ``DASO_PROC_ID`` / ``DASO_DISPATCH`` environment that `launch/procs.py`
    exports, and `torch.distributed.init_process_group` on the gloo
    backend over a ``tcp://`` coordinator, retried with backoff on a
    transient connect race only;
  * `check_overlap_topology`: the topologies ``dispatch="overlap"`` can run;
  * `process_env`: the explicit environment of a spawned process (it and
    `DistributedConfig` live in the torch-free `launch/env.py`, so the
    process launcher starts its children without importing torch);
  * `ProcessPlacement`: the placement the train loop, both executors, the
    step variants (core/daso.py, core/baselines.py) and the resilience
    supervisor thread their tensors through. It keeps this process's rows
    of every carry leaf and batch, and `gather_rows` is the one transport
    of every cross-row operation: each process sends the wire payload of
    its own rows (f32, K3's bf16, K5's int8 values and scales), all gather
    in one gloo collective, and every process then runs the same chain of
    adds in replica order that the one-process path runs. No all-reduce,
    whose order the transport would fix.

The contract: an N-process run gives the one-process run of the same spec,
seed and fault plan bit for bit (the reference's own contract). Every
process runs the same deterministic host loop (seeded data, controller and
fault plan), every per-row operation (the local step, Eq. (1) through K2,
the codecs) sees the same row values in either layout, and every reduction
sees the same rows in the same order. No step variant draws random bits
(the int8 tier rounds to nearest, as the reference's step variants do), so
no row's encoding depends on the layout either.

Transport. gloo for every process group, on the CPU and on the card: on
the card a gather copies the payload into a pinned host buffer on the
stream that made it, all-gathers it over gloo and copies the other
processes' rows back. NCCL needs one card per rank, so it is left for a
machine with several cards, and nothing here switches transports. A failed
collective (a dead peer closes its sockets) raises `PeerLostError`, and a
supervised worker exits with `resilience.runtime.EXIT_PEER_LOST`.

Collectives are issued in the same order on every process, at most one in
flight per process group: the cross-replica loss and the metrics are
gathered once per cycle at its fetch, never inside a step, and under
``dispatch="overlap"`` the one collective that runs beside the local steps
is the exchange's, on a helper thread (core/executor.py), with every inner
sync process-local (`check_overlap_topology`).
"""
from __future__ import annotations

import datetime
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.launch.env import (DISPATCH_MODES, ENV_COORDINATOR,  # noqa: F401
                                   ENV_DISPATCH, ENV_NUM_PROCS, ENV_PROC_ID,
                                   DistributedConfig, process_env)
from repro_torch.launch.mesh import process_replica_slice, validate_process_topology
from repro_torch.tree import leaves, tree_map

# seconds a collective may wait for its peers before gloo raises: above the
# longest gather of a full-width exchange (seconds) with room for a slow
# first cycle, below the supervisor's default watchdog
PG_TIMEOUT_S = 240.0

_initialized = False
_config: Optional["DistributedConfig"] = None


# Failure signatures of a transient coordinator bind / connect race: the
# coordinator losing its port between `free_port()` and bind (a torn-down
# group's socket in TIME_WAIT, or another group), or clients racing a
# coordinator that is being restarted. The reference's signatures, then the
# ones c10d's TCP store gives for the same races. Anything else fails at
# once: a retry must never hide a real failure.
CONNECT_RACE_SIGNATURES = (
    "Address already in use",
    "ADDRESS_IN_USE",
    "Failed to bind",
    "Connection reset by peer",
    "coordinator service failed to start",
    "DEADLINE_EXCEEDED",
    "UNAVAILABLE",
    "EADDRINUSE",
    "address already in use",
    "failed to listen on any local network address",
)


def _is_connect_race(exc: BaseException) -> bool:
    return any(sig in str(exc) for sig in CONNECT_RACE_SIGNATURES)


def initialize(cfg: DistributedConfig, *, max_attempts: int = 5,
               backoff_s: float = 0.5, timeout_s: float = PG_TIMEOUT_S) -> None:
    """Join the process group (idempotent; a no-op for one process): gloo
    over ``tcp://<coordinator>``, each collective bounded by `timeout_s`.

    Failures matching `CONNECT_RACE_SIGNATURES` are retried up to
    `max_attempts` times with exponential backoff (0.5 s, 1 s, 2 s, ...):
    a regrouped epoch's workers may connect while the fresh coordinator is
    still coming up. Any other error raises on the first attempt."""
    global _initialized, _config
    if _initialized:
        return
    if cfg.num_processes <= 1:
        _config = cfg
        return
    for attempt in range(max_attempts):
        try:
            dist.init_process_group(
                "gloo", init_method=f"tcp://{cfg.coordinator}",
                world_size=cfg.num_processes, rank=cfg.process_id,
                timeout=datetime.timedelta(seconds=timeout_s))
            break
        except Exception as e:
            if attempt == max_attempts - 1 or not _is_connect_race(e):
                raise
            try:
                # a half-made group must go before the next attempt binds
                dist.destroy_process_group()
            except Exception:
                pass
            delay = backoff_s * (2 ** attempt)
            print(f"[distributed] initialize attempt {attempt + 1}/"
                  f"{max_attempts} hit a transient connect race ({e}); "
                  f"retrying in {delay:.1f}s")
            time.sleep(delay)
    _initialized = True
    _config = cfg


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _initialized, _config
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized, _config = False, None


def check_overlap_topology(spec, n_procs: int) -> None:
    """Fail fast when a topology cannot run under dispatch="overlap".

    The overlap cycle's compute may carry inner-level group syncs, which
    run while the exchange's gather is in flight. That is safe only when
    every inner group lies within one process: it then gathers nothing.
    Each process owns a contiguous block of R // n_procs replica rows, so
    an inner level of cumulative group size g is process-local iff g
    divides that block. Raises naming the level; dispatch="serial" is
    right for every topology."""
    if n_procs <= 1:
        return
    rows_per_proc, rem = divmod(spec.n_replicas, n_procs)
    if rem:
        return  # validate_process_topology already refuses this split
    for name in spec.inner_names():
        g = spec.group_size(name)
        if rows_per_proc % g != 0:
            raise ValueError(
                f"dispatch='overlap' needs process-local inner syncs, but "
                f"level {name!r} groups {g} replicas while each of the "
                f"{n_procs} processes holds only {rows_per_proc} "
                f"({spec.to_str()}): a {name!r} group sync would be a "
                f"cross-process gloo collective racing the in-flight "
                f"exchange. Use --dispatch serial for this topology, or "
                f"launch with a process count whose per-process replica "
                f"block is a multiple of {g}.")


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


class PeerLostError(RuntimeError):
    """A collective failed: a peer of the process group died or closed its
    sockets (gloo's error is the cause)."""


@dataclass
class GatherStats:
    """One kind of `ProcessPlacement.gather_rows` traffic, host clock. Each
    call's seconds run from its payload's copy to the host until the rows
    are back on the tensor's device, so on the card they are the D2H copy,
    gloo and the H2D copy."""
    calls: int = 0
    payload_bytes: int = 0      # this process's rows, summed over calls
    received_bytes: int = 0     # the other processes' rows
    seconds: float = 0.0
    d2h_s: float = 0.0
    comm_s: float = 0.0
    h2d_s: float = 0.0
    by_dtype: Dict[str, int] = field(default_factory=dict)  # payload bytes
    # the gathers an overlap cycle ran beside its local steps (on the
    # executor's helper thread, `ProcessPlacement.beside_compute`)
    beside_compute_calls: int = 0
    beside_compute_s: float = 0.0

    def as_dict(self) -> dict:
        return {"calls": self.calls, "payload_bytes": self.payload_bytes,
                "received_bytes": self.received_bytes, "seconds": self.seconds,
                "d2h_s": self.d2h_s, "comm_s": self.comm_s, "h2d_s": self.h2d_s,
                "by_dtype": dict(self.by_dtype),
                "beside_compute_calls": self.beside_compute_calls,
                "beside_compute_s": self.beside_compute_s}


def _ident(x: torch.Tensor):
    """What makes two leaves one tensor (as checkpoint/io.py's
    `_carry_layout` reads aliasing)."""
    return (x.device, x.untyped_storage().data_ptr(), x.storage_offset(),
            x.dtype, tuple(x.shape), x.stride())


def _bytes_of(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


# one flat all-gather into a (procs * nbytes) buffer: `all_gather_single`
# where torch has it, its older name otherwise
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class ProcessPlacement:
    """This process's share of one topology's replica axis.

    `rows` is the replica block this process owns; every carry leaf and
    batch leaf with a leading R axis is kept as those rows (`put_carry`,
    `place_batch`, `stage_cycle`). `gather_rows` brings the rows of every
    process together, in replica order, for the cross-row operations, and
    counts its calls, bytes and seconds by kind ("exchange": the step
    variants' syncs; "fetch": metrics, checkpoints and diagnostics).
    `fetch` gathers a whole tree to the host, and `row` broadcasts one
    replica's row from its owner. Every one of them is collective: every
    process calls it at the same point of its (deterministic) host loop.

    Without a process group this is the one-process placement: `rows` is
    every replica, `gather_rows` returns its input, and the numbers are
    those of the N-process run."""

    def __init__(self, spec, *, device="cpu"):
        self.spec = spec
        self.n_replicas = spec.n_replicas
        if dist.is_initialized():
            self.n_procs, self.proc = dist.get_world_size(), dist.get_rank()
        else:
            self.n_procs, self.proc = 1, 0
        validate_process_topology(spec, self.n_procs)
        self.rows = process_replica_slice(spec, self.n_procs, self.proc)
        self.device = torch.device(device)
        # the joined group's dispatch (`initialize`); serial without one
        self.dispatch = _config.dispatch if _config is not None else "serial"
        if self.dispatch == "overlap":
            check_overlap_topology(spec, self.n_procs)
        self.stats = {"exchange": GatherStats(), "fetch": GatherStats()}
        self._thread = threading.local()

    @contextmanager
    def beside_compute(self):
        """Gathers issued on this thread inside the block ran beside an
        overlap cycle's local steps (counted apart in the stats)."""
        self._thread.beside = True
        try:
            yield
        finally:
            self._thread.beside = False

    # -- identity ------------------------------------------------------------
    @property
    def is_coordinator(self) -> bool:
        return self.proc == 0

    @property
    def local_rows(self) -> int:
        return len(self.rows)

    def local_mask(self, mask):
        """This process's entries of a membership mask (None stays None)."""
        return None if mask is None else tuple(mask[self.rows.start:self.rows.stop])

    def holds_groups(self, group_size: int, perm=None) -> bool:
        """True when every group of `group_size` consecutive replicas lies
        inside one process, so a group sync gathers nothing: one process,
        or no regrouping and a block that the groups tile."""
        return self.n_procs == 1 or (perm is None and self.local_rows % group_size == 0)

    # -- placement -----------------------------------------------------------
    def _slice(self, x):
        if isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] == self.n_replicas:
            return x[self.rows.start:self.rows.stop]
        return x

    def put_carry(self, carry):
        """This process's rows of every leaf with a leading R axis (views,
        so leaves that are one tensor stay one tensor, and a row broadcast
        stays a broadcast), on the placement's device; anything else whole.
        A carry that is already placed passes through."""
        done = {}

        def one(x):
            if id(x) not in done:
                y = self._slice(x)
                if (isinstance(y, torch.Tensor) and y.device != self.device
                        and y.device.type != "meta"):
                    y = y.to(self.device)
                done[id(x)] = (x, y)
            return done[id(x)][1]

        return tree_map(one, carry)

    def place_batch(self, batch, *, lead: int = 0):
        """This process's rows of one step's batch (`lead=1` for a cycle's
        stacked batches, the replica axis second)."""
        def one(x):
            if x.dim() <= lead or x.shape[lead] != self.n_replicas:
                raise ValueError(
                    f"batch leaf shape {tuple(x.shape)} lacks the replica axis "
                    f"R={self.n_replicas} at dim {lead} (distributed runs use "
                    "replica-axis strategies)")
            return x.narrow(lead, self.rows.start, self.local_rows).contiguous()

        return tree_map(one, batch)

    def stage_cycle(self, per_step_batches, lrs):
        """A macro-cycle's batches stacked (L, R, ...) and placed (L, rows,
        ...), and its lrs as one f32 tensor (L,) on the batches' device."""
        stacked = tree_map(lambda *xs: torch.stack(xs), *per_step_batches)
        batches = self.place_batch(stacked, lead=1)
        del stacked
        dev = leaves(batches)[0].device
        return batches, torch.tensor(list(lrs), dtype=torch.float32, device=dev)

    # -- transport -----------------------------------------------------------
    def gather_rows(self, x, *, kind: str = "exchange"):
        """Every process's rows of `x` in replica order: `x` is a tensor
        with this process's `local_rows` leading rows, or a tuple of such
        tensors (K5's int8 values and scales), gathered in ONE collective.
        Returns the same structure with R leading rows on `x`'s device; one
        process returns `x` itself."""
        parts = list(x) if isinstance(x, tuple) else [x]
        for p in parts:
            if p.dim() < 1 or p.shape[0] != self.local_rows:
                raise ValueError(f"gather_rows: leading axis {tuple(p.shape)[:1]} "
                                 f"is not this process's {self.local_rows} rows")
        st = self.stats[kind]
        nbytes = [p.numel() * p.element_size() for p in parts]
        st.calls += 1
        st.payload_bytes += sum(nbytes)
        for p, n in zip(parts, nbytes):
            key = str(p.dtype).removeprefix("torch.")
            st.by_dtype[key] = st.by_dtype.get(key, 0) + n
        if self.n_procs == 1:
            return x
        t0 = time.perf_counter()
        dev = parts[0].device
        on_card = dev.type == "cuda"
        flat = [_bytes_of(p) for p in parts]
        total = sum(nbytes)
        if on_card:
            # the payload's copy to pinned memory, on the stream that made it
            send = torch.empty(total, dtype=torch.uint8, pin_memory=True)
            off = 0
            for f, n in zip(flat, nbytes):
                send[off:off + n].copy_(f, non_blocking=True)
                off += n
            torch.cuda.current_stream(dev).synchronize()
        else:
            send = flat[0] if len(flat) == 1 else torch.cat(flat)
        del flat
        t1 = time.perf_counter()
        recv = torch.empty(self.n_procs * total, dtype=torch.uint8, pin_memory=on_card)
        try:
            _all_gather_flat(recv, send)
        except RuntimeError as e:
            raise PeerLostError(f"process {self.proc}: a {kind} gather failed: {e}") from e
        del send
        t2 = time.perf_counter()
        rl, out, off = self.local_rows, [], 0
        for p, n in zip(parts, nbytes):
            full = torch.empty((self.n_replicas,) + tuple(p.shape[1:]), dtype=p.dtype,
                               device=dev)
            for q in range(self.n_procs):
                dst = full[q * rl:(q + 1) * rl]
                if q == self.proc:
                    dst.copy_(p)
                else:
                    src = recv[q * total + off:q * total + off + n]
                    _bytes_of(dst).copy_(src, non_blocking=on_card)
            off += n
            out.append(full)
        if on_card:
            torch.cuda.current_stream(dev).synchronize()
        t3 = time.perf_counter()
        st.received_bytes += total * (self.n_procs - 1)
        st.d2h_s += t1 - t0
        st.comm_s += t2 - t1
        st.h2d_s += t3 - t2
        st.seconds += t3 - t0
        if getattr(self._thread, "beside", False):
            st.beside_compute_calls += 1
            st.beside_compute_s += t3 - t0
        return tuple(out) if isinstance(x, tuple) else out[0]

    def gather_metrics(self, metrics: dict, keys) -> dict:
        """`metrics[k]` (L, local rows) for each k of `keys` -> (L, R), every
        process's rows in replica order, in one collective (kind "fetch").
        Rows come back contiguous, so a reduction over one step's replicas
        reads them as the in-step reduction of one process would."""
        keys = list(keys)
        parts = tuple(metrics[k].transpose(0, 1).contiguous() for k in keys)
        full = self.gather_rows(parts, kind="fetch")
        return {k: f.transpose(0, 1).contiguous() for k, f in zip(keys, full)}

    def fetch(self, tree):
        """The whole tree on the host, every leaf with this process's rows
        gathered back to R rows (kind "fetch"); leaves that are one tensor
        stay one tensor. Collective."""
        done = {}

        def one(x):
            if not isinstance(x, torch.Tensor):
                return x
            key = _ident(x)
            if key not in done:
                y = x
                if x.dim() >= 1 and x.shape[0] == self.local_rows:
                    y = self.gather_rows(x, kind="fetch")
                done[key] = y.cpu()
            return done[key]

        return tree_map(one, tree)

    def row(self, tree, index: int):
        """Replica `index`'s row of every leaf, broadcast from the process
        that owns it, on the placement's device. Collective."""
        owner = index // self.local_rows

        def one(x):
            if self.n_procs == 1:
                return x[index]
            st = self.stats["fetch"]
            st.calls += 1
            t0 = time.perf_counter()
            if owner == self.proc:
                y = x[index - self.rows.start]
                host = _bytes_of(y).cpu()
            else:
                y = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
                host = torch.empty(y.numel() * y.element_size(), dtype=torch.uint8)
            try:
                dist.broadcast(host, src=owner)
            except RuntimeError as e:
                raise PeerLostError(f"process {self.proc}: a row broadcast failed: "
                                    f"{e}") from e
            if owner != self.proc:
                _bytes_of(y).copy_(host)
                st.received_bytes += host.numel()
            else:
                st.payload_bytes += host.numel()
            st.seconds += time.perf_counter() - t0
            return y

        return tree_map(one, tree)

    def finalize_params(self, strategy, carry):
        """The run's final params: the strategy's finalize (the first active
        replica's row), broadcast from the process that owns it."""
        return strategy.finalize_params(carry)

    def report(self) -> dict:
        return {"procs": self.n_procs, "proc": self.proc,
                "rows": [self.rows.start, self.rows.stop],
                "dispatch": self.dispatch,
                **{k: v.as_dict() for k, v in self.stats.items()}}


def fingerprint(x: torch.Tensor, *, chunk: int = 1 << 24) -> str:
    """A 64-bit digest of a tensor's bytes, computed where the tensor lies:
    the sum of its words (integers of its element size) times 2i + 1 over
    word positions i, modulo 2^64. A change in any one word changes it."""
    words = x.contiguous().reshape(-1)
    words = words.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                        8: torch.int64}[words.element_size()])
    acc = torch.zeros((), dtype=torch.int64, device=x.device)
    for start in range(0, words.numel(), chunk):
        c = words[start:start + chunk].to(torch.int64)
        w = torch.arange(start, start + c.numel(), dtype=torch.int64, device=x.device)
        acc += (c * (2 * w + 1)).sum()
    return f"{int(acc) & 0xFFFFFFFFFFFFFFFF:016x}"


def row_digests(tree, placement=None) -> Dict[str, str]:
    """``{"<leaf>:<replica>": fingerprint}`` for every row of every leaf of
    `tree` (leaves in flatten order, each with a leading replica axis: a
    carry). A placed carry holds this process's rows, named by their
    replica index, so the union over the processes of a run can be held to
    the one-process run's digests."""
    start = placement.rows.start if placement is not None else 0
    out = {}
    for i, x in enumerate(leaves(tree)):
        if isinstance(x, torch.Tensor) and x.dim() >= 1:
            for j in range(x.shape[0]):
                out[f"{i}:{start + j}"] = fingerprint(x[j])
    return out
