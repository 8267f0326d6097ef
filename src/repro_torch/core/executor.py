"""Strategy registry (`repro/core/executor.py`): every training strategy
offers one interface to the training loop: its carry, a factory of step
variants ``step(carry, batch, lr) -> (carry, metrics)`` cached per
(mode, staleness), and a per-step mode decision. Registered here: `daso`
and `sync`. The compiled macro-cycle executor is a later port (ROADMAP
item 9); the per-step path (core/simulator.py) drives the strategies.
"""
from __future__ import annotations

import difflib
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.daso import (DasoConfig, daso_overlap_step, daso_train_step,
                                   dereplicate_params, replicate_params, sync_train_step)
from repro_torch.core.schedule import DasoController, split_mode, split_ov
from repro_torch.optim.optimizers import Optimizer

_REGISTRY: Dict[str, type] = {}


def register_strategy(name: str):
    """Class decorator: register a Strategy subclass under `name`."""
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_strategy(name: str) -> type:
    try:
        return _REGISTRY[name]
    except KeyError:
        hint = difflib.get_close_matches(name, _REGISTRY, n=1)
        suggest = f"; did you mean {hint[0]!r}?" if hint else ""
        raise KeyError(f"unknown strategy {name!r}; registered: "
                       f"{sorted(_REGISTRY)}{suggest}") from None


def list_strategies() -> List[str]:
    return sorted(_REGISTRY)


def make_strategy(name: str, loss_fn: Callable, optimizer: Optimizer,
                  cfg: Optional[DasoConfig] = None, **kw) -> "Strategy":
    return get_strategy(name)(loss_fn, optimizer, cfg, **kw)


class Strategy:
    """Carry lifecycle, cached step variants and the per-step schedule."""
    name = "?"

    def __init__(self, loss_fn: Callable, optimizer: Optimizer,
                 cfg: Optional[DasoConfig] = None, *,
                 controller: Optional[DasoController] = None):
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.cfg = cfg
        self.controller = controller or (DasoController(cfg) if cfg else None)
        self._steps: Dict[Tuple[str, int], Callable] = {}

    def init_carry(self, params0):
        raise NotImplementedError

    def finalize_params(self, carry):
        raise NotImplementedError

    def step_fn(self, mode: str, staleness: int) -> Callable:
        key = (mode, staleness)
        if key not in self._steps:
            self._steps[key] = self.build_step(mode, staleness)
        return self._steps[key]

    def build_step(self, mode: str, staleness: int) -> Callable:
        raise NotImplementedError

    def next_mode(self, step: int) -> Tuple[str, int]:
        """The (mode, staleness) of `step`; consumed once per step, in
        order."""
        raise NotImplementedError

    def observe(self, losses: List[float]) -> None:
        """Feed per-step losses (in step order) back to the scheduler."""
        if self.controller is not None:
            for loss in losses:
                self.controller.observe_loss(loss)

    def sync_fraction(self) -> float:
        return (self.controller.global_sync_fraction()
                if self.controller is not None else 1.0)

    @classmethod
    def make_controller(cls, cfg: Optional[DasoConfig], *, loss_window: int = 50):
        return (DasoController(cfg, loss_window=loss_window)
                if cfg is not None else None)


@register_strategy("daso")
class DasoStrategy(Strategy):
    """The paper's strategy: carry (params_R, opt_R, inflight) with the
    replica axis R leading every leaf, controller-scheduled step variants
    from core/daso.py. Under the overlap schedule the carry has a fourth
    slot, the pending snapshot: (params_R, opt_R, inflight, pending)."""

    def __init__(self, loss_fn, optimizer, cfg, **kw):
        if cfg is None:
            raise ValueError("the daso strategy needs a DasoConfig")
        super().__init__(loss_fn, optimizer, cfg, **kw)

    @property
    def overlap(self) -> bool:
        """True under the double-buffered overlap schedule (4-slot carry,
        OV_MODES tokens)."""
        return self.cfg.overlap != "off"

    def init_carry(self, params0):
        params = replicate_params(params0, self.cfg.n_replicas)
        opt_state = replicate_params(self.optimizer.init(params0),
                                     self.cfg.n_replicas)
        # the in-flight buffer is read only after a send has written it, the
        # pending snapshot only after an ov_start: both start as the params
        # themselves (no step writes into its inputs)
        if self.overlap:
            return (params, opt_state, params, params)
        return (params, opt_state, params)

    def finalize_params(self, carry):
        return dereplicate_params(carry[0], index=0)

    def build_step(self, mode, staleness):
        outer, inner = split_mode(mode)
        if inner:
            raise ValueError(f"mode carries inner-level syncs {inner!r} but "
                             f"strategy {self.name!r} has no topology")
        if self.overlap:
            base, extra = split_ov(outer)
            raw_ov = daso_overlap_step(self.loss_fn, self.optimizer, self.cfg, mode=base,
                                       staleness=staleness, extra_staleness=extra)

            def ostep(carry, batch, lr):
                params, opt_state, inflight, pending = carry
                params, opt_state, inflight, pending, m = raw_ov(
                    params, opt_state, inflight, pending, batch, lr)
                return (params, opt_state, inflight, pending), m

            return ostep
        raw = daso_train_step(self.loss_fn, self.optimizer, self.cfg, mode=outer,
                              staleness=staleness)

        def step(carry, batch, lr):
            params, opt_state, inflight = carry
            params, opt_state, inflight, m = raw(params, opt_state, inflight,
                                                 batch, lr)
            return (params, opt_state, inflight), m

        return step

    def next_mode(self, step):
        return self.controller.mode_for_step(step)


@register_strategy("sync")
class SyncStrategy(Strategy):
    """Horovod-analog baseline: flat data parallelism, no replica axis."""

    def init_carry(self, params0):
        return (params0, self.optimizer.init(params0))

    def finalize_params(self, carry):
        return carry[0]

    def build_step(self, mode, staleness):
        raw = sync_train_step(self.loss_fn, self.optimizer)

        def step(carry, batch, lr):
            params, opt_state = carry
            params, opt_state, m = raw(params, opt_state, batch, lr)
            return (params, opt_state), m

        return step

    def next_mode(self, step):
        return ("sync", 1)

    def observe(self, losses):
        pass

    def sync_fraction(self):
        return 1.0
