"""Process <-> topology partitioning of the multi-process runtime
(`repro/launch/mesh.py:48-145`): which replica rows, and which subtrees of
the topology, each of N processes owns.

The port has no device mesh. Level 0 of a topology is virtual (its fanout
is a number in Eq. (1)'s world P, not a device count), and a process owns a
contiguous block of the replica axis: rows ``[p * R / N, (p + 1) * R / N)``
of every carry leaf (`launch/distributed.py::ProcessPlacement`). So where
the reference checks that the devices divide over the processes, this
checks that the replicas do; every rule about topology units stays: no
process block may cut through a unit of any replica level.

Pure host-side functions (standard library only), so the partition
contract is testable without processes, and the process launcher
(`launch/procs.py`) uses them without importing torch.
"""
from __future__ import annotations


def replica_unit_sizes(spec):
    """Replicas per unit of each replica level, innermost first:
    ``{level_name: unit_size}``. A unit of the finest replica level is one
    replica; a unit of level l holds the product of the replica-level
    fanouts below it."""
    sizes, u = {}, 1
    for lvl in spec.replica_levels:
        sizes[lvl.name] = u
        u *= lvl.fanout
    return sizes


def validate_process_topology(spec, num_processes: int) -> int:
    """Check that `num_processes` processes can carve the topology into
    equal per-process subtrees. Returns the replica rows each process owns
    (``spec.n_replicas // num_processes``).

    Raises ValueError with the reason when the split is impossible: the
    replicas not dividing evenly, or a process block cutting through a
    topology level's units."""
    if num_processes < 1:
        raise ValueError(f"num_processes must be >= 1, got {num_processes}")
    if spec.n_replicas % num_processes:
        raise ValueError(
            f"topology replicas {spec.n_replicas} ({spec.to_str()}) do not "
            f"divide over {num_processes} processes: a process owns whole "
            f"replica rows")
    block = spec.n_replicas // num_processes
    for name, u in replica_unit_sizes(spec).items():
        if block % u and u % block:
            raise ValueError(
                f"process blocks of {block} replicas cut through "
                f"{name!r} units of {u} replicas: {num_processes} processes "
                f"cannot own whole subtrees of {spec.to_str()!r}")
    return block


def process_replica_slice(spec, num_processes: int, process_id: int) -> range:
    """Replica indices owned by `process_id`: a contiguous block, inner
    levels varying fastest in the replica index."""
    validate_process_topology(spec, num_processes)
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside "
                         f"0..{num_processes - 1}")
    block = spec.n_replicas // num_processes
    return range(process_id * block, (process_id + 1) * block)


def _node_path(spec, level_index: int, replica: int) -> str:
    """Node path ("pod1/host0") of the level-`level_index` unit holding
    `replica`, outermost first, as `TopologySpec.replicas_of` reads it."""
    sizes = replica_unit_sizes(spec)
    segs = []
    for i in range(len(spec.levels) - 1, level_index - 1, -1):
        lvl = spec.levels[i]
        u = sizes[lvl.name]
        idx = (replica // u) % lvl.fanout if i < len(spec.levels) - 1 \
            else replica // u
        segs.append(f"{lvl.name}{idx}")
    return "/".join(segs)


def process_node_paths(spec, num_processes: int, process_id: int):
    """The largest topology subtrees owned by `process_id`, as node paths
    (`TopologySpec.replicas_of` round-trips them). With processes mapped one
    to one onto the units of some level this is one path, the process's
    subtree; coarser splits own several sibling subtrees."""
    rng = process_replica_slice(spec, num_processes, process_id)
    block = len(rng)
    best_i, best_u = 1, 1
    for i, lvl in enumerate(spec.levels[1:], start=1):
        u = replica_unit_sizes(spec)[lvl.name]
        if block % u == 0 and u >= best_u:
            best_i, best_u = i, u
    return tuple(_node_path(spec, best_i, r)
                 for r in range(rng.start, rng.stop, best_u))


def device_node_path(spec, device_index: int) -> str:
    """Topology path of one member of the world P: the finest replica-level
    node it sits in, plus its rank inside that replica's level-0 tier
    (``"pod1/host0:chip2"``)."""
    if not 0 <= device_index < spec.world:
        raise ValueError(f"device {device_index} outside the topology "
                         f"world 0..{spec.world - 1}")
    replica, local = divmod(device_index, spec.local_world)
    return (f"{_node_path(spec, 1, replica)}:"
            f"{spec.levels[0].name}{local}")
