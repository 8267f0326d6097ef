"""`hier_daso`: the N-level topology strategy (`repro/topo/strategy.py`).

Registered in the same strategy registry as `daso` / `sync` / `local_sgd`
(core/executor.py), so both executors and the train loop drive it through
the common plan -> program interface. The only deltas from `DasoStrategy`:

  * the controller is a `HierDasoController`, so cycle shapes carry the
    per-level phase vector (mode tokens like ``"send+host"``: still plain
    strings, so the executor's shape-keyed program cache, the history and
    the checkpoint format are unchanged);
  * `_inner_syncs_of` resolves the token's inner-level names against the
    topology, so every step variant (`inner_syncs` of `daso_train_step` and
    its overlap counterparts) runs each syncing level's
    `level_group_mean`, one group reduction per arena over exactly that
    level's replica groups.

With a 2-level topology there are no intermediate levels and every token is
a legacy mode string; `repro_torch.topo.lower.build_topology_strategy`
returns the stock `DasoStrategy` for that case anyway.
"""
from __future__ import annotations

from repro_torch.core.executor import DasoStrategy, register_strategy
from repro_torch.core.schedule import HierDasoController
from repro_torch.topo.spec import TopologySpec


@register_strategy("hier_daso")
class HierDasoStrategy(DasoStrategy):
    """The paper's strategy on an explicit N-level topology: the outermost
    level keeps the plateau-driven asynchronous send / receive exchange,
    intermediate levels get synchronous group syncs every B_l steps, level
    0 stays the gradient all-reduce inside a replica."""

    def __init__(self, loss_fn, optimizer, cfg, *, topo: TopologySpec,
                 controller=None, **kw):
        if cfg is not None and cfg.n_replicas != topo.n_replicas:
            raise ValueError(
                f"DasoConfig.n_replicas={cfg.n_replicas} does not match "
                f"the topology's {topo.n_replicas}")
        if controller is None:
            from repro_torch.topo.lower import make_controller
            controller = make_controller(topo, cfg)
        if not isinstance(controller, HierDasoController) \
                and topo.n_levels > 2:
            raise ValueError("a >2-level topology needs a "
                             "HierDasoController (repro_torch.topo.lower."
                             "make_controller builds one)")
        super().__init__(loss_fn, optimizer, cfg, controller=controller,
                         **kw)
        self.topo = topo

    def _inner_syncs_of(self, inner):
        # the one topology-aware hook: every step-build path of the base
        # class (plain, overlap, overlap compute) routes through it
        return tuple((name, self.topo.group_size(name)) for name in inner)
