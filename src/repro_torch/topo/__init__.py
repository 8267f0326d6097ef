"""Explicit N-level cluster topology (`repro/topo/`).

`TopologySpec` declares the bandwidth hierarchy (levels with name, fanout,
link bandwidth / latency, e.g. ``chip:4 x host:4 x pod:2``); `lower` turns
it into a `DasoConfig`, a per-level sync schedule and a registered training
strategy; `strategy` holds the `hier_daso` strategy, whose step variants
sync exactly the levels that tick each step.
"""
from repro_torch.topo.lower import (build_topology_strategy, daso_config_from,
                                    derive_inner_periods, make_controller)
from repro_torch.topo.spec import Level, TopologySpec
from repro_torch.topo.strategy import HierDasoStrategy

__all__ = ["Level", "TopologySpec", "HierDasoStrategy",
           "build_topology_strategy", "daso_config_from",
           "derive_inner_periods", "make_controller"]
