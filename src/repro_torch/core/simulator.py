"""Per-step training loop (`repro/core/simulator.py`): N virtual nodes
as the leading replica axis on one device, one step dispatched at a time,
with the strategy's mode decision and loss feedback interleaved exactly as
on the reference's host loop. The macro-cycle executor (core/executor.py)
is held to its numbers bit for bit."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.schedule import DasoController


@dataclass
class SimResult:
    losses: List[float]
    metrics: List[Dict[str, float]]
    params: object
    sync_fraction: float
    controller: Optional[DasoController] = None
    divergence: List[float] = field(default_factory=list)
    # the macro-cycle path's ExecutorStats (core/executor.py)
    executor_stats: Optional[object] = None
    # host seconds per step, batch made before the clock starts; each ends
    # in the loss fetch, which waits for the device, so on a card this is
    # the step's time
    step_seconds: List[float] = field(default_factory=list)
    # the final carry, e.g. the daso strategy's (params_R, opt_R, inflight)
    # with every replica's row; `params` is the one model it finalizes to
    carry: object = None
    # the macro-cycle path: each cycle's shape and its host seconds, from
    # its staged batches to its metrics on the host
    cycles: List[Tuple[tuple, float]] = field(default_factory=list)

    @property
    def final_loss(self) -> float:
        k = max(1, len(self.losses) // 10)
        return float(np.mean(self.losses[-k:]))


def run_per_step_training(strategy, params0, data_fn: Callable,
                          lr_fn: Callable, n_steps: int, *,
                          track_divergence: bool = False, start_step: int = 0,
                          carry=None, ckpt_every: int = 0,
                          ckpt_cb: Optional[Callable] = None) -> SimResult:
    """One step variant per training step, modes decided step by step
    (`strategy.next_mode`), each loss fed back (`strategy.observe`).
    `track_divergence` samples the replica divergence after every step.

    `start_step` and a restored `carry` continue a run whose strategy's
    controller is already at that step; `ckpt_cb(completed_steps, carry,
    losses)` fires after every `ckpt_every`-th step (`train/loop.py` sets
    them for checkpoints and resume, as the reference's does)."""
    carry = strategy.init_carry(params0) if carry is None else carry
    losses, metrics_log, seconds, divs = [], [], [], []
    for step in range(start_step, n_steps):
        batch, lr = data_fn(step), lr_fn(step)
        t0 = time.perf_counter()
        mode, stale = strategy.next_mode(step)
        carry, m = strategy.step_fn(mode, stale)(carry, batch, lr)
        loss = float(m["loss"])
        losses.append(loss)
        metrics_log.append({k: float(v) for k, v in m.items() if v.dim() == 0})
        strategy.observe([loss])
        seconds.append(time.perf_counter() - t0)
        if track_divergence:
            d = strategy.divergence(carry)
            if d is not None:
                divs.append(d)
        if ckpt_every and ckpt_cb is not None and (step + 1) % ckpt_every == 0:
            ckpt_cb(step + 1, carry, losses)
    return SimResult(losses=losses, metrics=metrics_log,
                     params=strategy.finalize_params(carry),
                     sync_fraction=strategy.sync_fraction(),
                     controller=strategy.controller, divergence=divs,
                     step_seconds=seconds, carry=carry)
