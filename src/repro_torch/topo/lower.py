"""Lowering a `TopologySpec` onto the DASO control plane
(`repro/topo/lower.py`).

A spec lowers to:

  (a) a `DasoConfig` whose replica axis is the product of the replica-level
      fanouts and whose Eq. (1) world size P is the full topology world;
  (b) a per-level sync schedule: fixed periods B_l for the intermediate
      levels (`derive_inner_periods`) driven by a `HierDasoController`,
      with the paper's plateau-adaptive B/W schedule driving the outermost
      level;
  (c) a registered strategy: `hier_daso` (topo/strategy.py), whose step
      variants run each syncing level's group mean.

The reference also lowers a spec to a JAX mesh with one axis per level;
the port instead gives each process a block of the spec's replica axis
(`launch/mesh.py`, `launch/distributed.py::ProcessPlacement`). The 2-level special case lowers to the
unmodified legacy objects (`DasoController`, `DasoStrategy`), so it gives
the legacy run bit for bit.

>>> from repro_torch.topo.spec import TopologySpec
>>> spec = TopologySpec.parse("chip:4 x host:2@50e9 x pod:2@25e9")
>>> derive_inner_periods(spec, b_max=4)
{'host': 2}
>>> daso_config_from(spec).n_replicas, daso_config_from(spec).global_world
(4, 16)
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch.core.daso import DasoConfig
from repro_torch.core.schedule import DasoController, HierDasoController
from repro_torch.topo.spec import TopologySpec


def derive_inner_periods(spec: TopologySpec, *, b_max: int = 4,
                         bandwidths: Optional[Dict[str, float]] = None
                         ) -> Dict[str, int]:
    """Per-level sync periods B_l for the intermediate replica levels,
    innermost first. An explicit ``%period`` on the level wins; otherwise
    B_l scales the outermost b_max by the bandwidth ratio — a level as fast
    as the outermost syncs as rarely (B_l = b_max), a level k× faster
    syncs k× more often (min 1):

        B_l = clamp(round(b_max * bw_outer / bw_l), 1, b_max)

    which is the match-the-schedule-to-the-topology rule DS-Sync argues
    for: bytes flow where the links can afford them.

    `bandwidths` overrides the spec's annotations with measurements (level
    name -> bytes/s, outermost included); levels it does not name keep
    their annotated value: `topo/probe.py::derive_retuned_periods` passes
    the probe's measurements this way.

    >>> from repro_torch.topo.spec import TopologySpec
    >>> s = TopologySpec.parse("chip:4 x host:2@50e9 x pod:2@25e9")
    >>> derive_inner_periods(s, b_max=4)
    {'host': 2}
    >>> derive_inner_periods(s, b_max=4, bandwidths={"host": 12.5e9})
    {'host': 4}
    """
    if b_max < 1:
        raise ValueError(f"b_max must be >= 1, got {b_max}")
    bw = bandwidths or {}
    bw_outer = bw.get(spec.outer.name, spec.outer.bandwidth)
    periods: Dict[str, int] = {}
    for lvl in spec.levels[1:-1]:
        if spec.group_size(lvl.name) == 1:
            # a degenerate level (all fanouts up to it are 1) has
            # single-replica groups — its sync is a no-op, so it is
            # elided from the schedule rather than built into steps
            continue
        if lvl.period is not None:
            periods[lvl.name] = lvl.period
        else:
            bw_l = bw.get(lvl.name, lvl.bandwidth)
            periods[lvl.name] = max(
                1, min(b_max, round(b_max * bw_outer / bw_l)))
    return periods


def daso_config_from(spec: TopologySpec, *, b_max: int = 4,
                     **overrides) -> DasoConfig:
    """`DasoConfig` for a topology: R from the replica-level fanouts, P
    (Eq. (1) world) = the full topology world, b_max from the outermost
    level's ``%period`` if pinned. Remaining DasoConfig fields pass through
    `overrides`."""
    if spec.outer.period is not None:
        b_max = spec.outer.period
    return DasoConfig(n_replicas=spec.n_replicas,
                      global_world=spec.world,
                      b_max=b_max, **overrides)


def make_controller(spec: TopologySpec, cfg: DasoConfig, *,
                    loss_window: int = 50):
    """The schedule layer of the lowering: the plain `DasoController` for a
    2-level spec (the legacy histories), a `HierDasoController` carrying
    the derived per-level periods otherwise."""
    if cfg.n_replicas != spec.n_replicas:
        raise ValueError(f"DasoConfig.n_replicas={cfg.n_replicas} does not "
                         f"match the topology's {spec.n_replicas}")
    if spec.n_levels == 2:
        return DasoController(cfg, loss_window=loss_window)
    return HierDasoController(cfg, loss_window=loss_window,
                              inner_periods=derive_inner_periods(
                                  spec, b_max=cfg.b_max),
                              pinned_periods=tuple(
                                  spec.inner_periods_explicit()))


def build_topology_strategy(loss_fn: Callable, optimizer, spec: TopologySpec,
                            cfg: Optional[DasoConfig] = None, *,
                            loss_window: int = 50, b_max: int = 4,
                            n_micro: int = 1, membership=None,
                            **cfg_overrides):
    """Lower a spec all the way to a registered Strategy instance.

    2-level specs return the stock `DasoStrategy` (the legacy path, bit for
    bit), stamped with the spec as `.topo`; deeper specs return a
    `HierDasoStrategy` whose step variants carry the per-level phase
    vector. `cfg` may be passed pre-built (it must agree with the spec);
    otherwise it is derived via `daso_config_from(spec, b_max=b_max,
    **cfg_overrides)`. `membership` (a 0/1 mask over the replicas) is the
    strategy's starting active set (elastic membership)."""
    from repro_torch.core.executor import DasoStrategy
    from repro_torch.topo.strategy import HierDasoStrategy

    cfg = cfg or daso_config_from(spec, b_max=b_max, **cfg_overrides)
    controller = make_controller(spec, cfg, loss_window=loss_window)
    if spec.n_levels == 2:
        strategy = DasoStrategy(loss_fn, optimizer, cfg,
                                controller=controller, n_micro=n_micro,
                                membership=membership)
        # the spec on the stock strategy too, so the resilience supervisor
        # resolves fault events that name topology nodes for either kind
        strategy.topo = spec
        return strategy
    return HierDasoStrategy(loss_fn, optimizer, cfg, topo=spec,
                            controller=controller, n_micro=n_micro,
                            membership=membership)
