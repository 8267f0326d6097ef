"""The identity and environment of a process of the multi-process runtime
(the pure half of `repro/launch/distributed.py`, re-exported by
`launch/distributed.py`): `DistributedConfig` and the explicit environment
`process_env` gives a spawned process. Standard library only, so the
process launcher (`launch/procs.py`) spawns its group without importing
torch."""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

ENV_COORDINATOR = "DASO_COORDINATOR"
ENV_NUM_PROCS = "DASO_NUM_PROCS"
ENV_PROC_ID = "DASO_PROC_ID"
ENV_DISPATCH = "DASO_DISPATCH"

DISPATCH_MODES = ("serial", "overlap")


@dataclass(frozen=True)
class DistributedConfig:
    """Who this process is in the group. `num_processes == 1` is the
    one-process run: the same code path, no process group.

    `dispatch` sets where the overlap exchange's gather runs:

      * "serial" (default): the exchange of an overlap cycle is waited for
        before the cycle's local steps start, so at most one collective is
        ever in flight. Right for every strategy and topology.
      * "overlap": the exchange (its gather included) runs on a helper
        thread while the cycle's local steps run. Safe only because the
        overlap cycle's compute issues no collective (its inner syncs are
        process-local, `check_overlap_topology`, and its metrics are
        gathered at the cycle's fetch); `launch/train.py` refuses it unless
        the strategy runs with overlap on."""
    coordinator: Optional[str] = None     # "host:port"
    num_processes: int = 1
    process_id: int = 0
    dispatch: str = "serial"

    def __post_init__(self):
        if self.dispatch not in DISPATCH_MODES:
            raise ValueError(f"unknown dispatch mode {self.dispatch!r}; "
                             f"expected one of {DISPATCH_MODES}")

    @classmethod
    def from_env(cls, *, coordinator: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None,
                 dispatch: Optional[str] = None) -> "DistributedConfig":
        """Explicit flag values, else the DASO_* variables `launch/procs.py`
        exports for its children."""
        coord = coordinator or os.environ.get(ENV_COORDINATOR)
        n = num_processes if num_processes is not None else int(
            os.environ.get(ENV_NUM_PROCS, "1"))
        pid = process_id if process_id is not None else int(
            os.environ.get(ENV_PROC_ID, "0"))
        disp = dispatch or os.environ.get(ENV_DISPATCH, "serial")
        if n > 1 and not coord:
            raise ValueError(
                f"{n} processes need a coordinator address "
                f"(--coordinator host:port or ${ENV_COORDINATOR})")
        if not 0 <= pid < n:
            raise ValueError(f"process_id {pid} outside 0..{n - 1}")
        return cls(coordinator=coord, num_processes=n, process_id=pid,
                   dispatch=disp)




# CPU threads (OMP / MKL) of every process a launcher starts
CPU_THREADS = 1


def process_env(procs: int, proc_id: int, coordinator: str, *,
                dispatch: Optional[str] = None, base: Optional[dict] = None) -> dict:
    """The environment of a spawned process, its runtime variables set
    explicitly, never inherited: the DASO_* identity that
    `DistributedConfig.from_env` reads, PYTHONPATH with this checkout's
    `src`, and the CPU thread count (`CPU_THREADS`), so a one-process and
    an N-process layout split their CPU matrix products alike."""
    env = dict(os.environ if base is None else base)
    env[ENV_COORDINATOR] = coordinator
    env[ENV_NUM_PROCS] = str(procs)
    env[ENV_PROC_ID] = str(proc_id)
    if dispatch is not None:
        env[ENV_DISPATCH] = dispatch
    env["OMP_NUM_THREADS"] = str(CPU_THREADS)
    env["MKL_NUM_THREADS"] = str(CPU_THREADS)
    env["PYTHONUNBUFFERED"] = "1"
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    return env
