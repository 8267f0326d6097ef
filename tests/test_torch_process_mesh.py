"""The port's process <-> topology partition (repro_torch/launch/mesh.py)
and the pure parts of its runtime (repro_torch/launch/distributed.py) held
against the JAX package's on the same specs: the replica block each process
owns, its subtrees' node paths, the refusals, the overlap-topology check
and `DistributedConfig.from_env`. Pure host-side functions: no processes.

The port's processes own replica rows, not devices (its level 0 is virtual),
so where the reference returns the devices per process the port returns the
rows per process: the reference's count over `spec.local_world`."""
import pytest

from repro.launch import distributed as ref_dist
from repro.launch import mesh as ref_mesh
from repro.topo import TopologySpec as RefSpec
from repro_torch.launch import distributed as port_dist
from repro_torch.launch import mesh as port_mesh
from repro_torch.topo import TopologySpec

SPECS = ["chip:4 x pod:2", "chip:2 x host:2 x pod:2", "chip:1 x host:2 x pod:2",
         "chip:1 x host:3 x pod:2", "chip:4 x host:2@50e9 x pod:2@25e9",
         "chip:1 x host:2 x pod:4", "chip:2 x rack:2 x host:2 x pod:2",
         "chip:4 x pod:3", "chip:1 x host:2 x pod:3"]
PROCS = [1, 2, 3, 4, 6, 8]


def both(spec_str):
    return TopologySpec.load(spec_str), RefSpec.load(spec_str)


def outcome(fn, *args):
    """("ok", value) or ("error", ValueError)."""
    try:
        return "ok", fn(*args)
    except ValueError:
        return "error", None


@pytest.mark.parametrize("spec_str", SPECS)
def test_replica_unit_sizes_match_the_reference(spec_str):
    port, ref = both(spec_str)
    assert port_mesh.replica_unit_sizes(port) == ref_mesh.replica_unit_sizes(ref)


@pytest.mark.parametrize("spec_str", SPECS)
def test_partition_matches_the_reference(spec_str):
    """Every process count: both accept or both refuse; accepted, the rows
    per process are the reference's devices over local_world, and every
    process's replica slice and node paths are the reference's."""
    port, ref = both(spec_str)
    for n in PROCS:
        got = outcome(port_mesh.validate_process_topology, port, n)
        want = outcome(ref_mesh.validate_process_topology, ref, n)
        # the reference also refuses a split that cuts a replica's devices,
        # which the port's row blocks cannot do; on these specs such a
        # split never divides the replicas either
        assert got[0] == want[0], (spec_str, n, got, want)
        if got[0] == "error":
            continue
        assert got[1] == want[1] // ref.local_world
        for pid in range(n):
            assert port_mesh.process_replica_slice(port, n, pid) == \
                ref_mesh.process_replica_slice(ref, n, pid)
            assert port_mesh.process_node_paths(port, n, pid) == \
                ref_mesh.process_node_paths(ref, n, pid)


@pytest.mark.parametrize("spec_str", SPECS)
def test_device_node_paths_match_the_reference(spec_str):
    port, ref = both(spec_str)
    for d in range(port.world):
        assert port_mesh.device_node_path(port, d) == ref_mesh.device_node_path(ref, d)
    for fn, s in ((port_mesh.device_node_path, port), (ref_mesh.device_node_path, ref)):
        with pytest.raises(ValueError, match="outside"):
            fn(s, s.world)


@pytest.mark.parametrize("spec_str,n,match", [
    ("chip:4 x pod:3", 5, "divide"),             # 3 replicas over 5 processes
    ("chip:4 x pod:2", 8, "divide"),             # more processes than replicas
    ("chip:1 x host:3 x pod:2", 3, "cut through"),  # blocks of 2 cut pods of 3
    ("chip:1 x pod:2", 0, ">= 1"),
])
def test_refusals(spec_str, n, match):
    port, ref = both(spec_str)
    with pytest.raises(ValueError, match=match):
        port_mesh.validate_process_topology(port, n)
    with pytest.raises(ValueError):
        ref_mesh.validate_process_topology(ref, n)


def test_process_id_out_of_range():
    port, ref = both("chip:1 x pod:2")
    with pytest.raises(ValueError, match="process_id"):
        port_mesh.process_replica_slice(port, 2, 2)
    with pytest.raises(ValueError, match="process_id"):
        ref_mesh.process_replica_slice(ref, 2, 2)


def test_paths_round_trip_through_replicas_of():
    s = TopologySpec.load("chip:2 x host:2 x pod:2")
    for n in (1, 2, 4):
        for pid in range(n):
            got = []
            for path in port_mesh.process_node_paths(s, n, pid):
                got.extend(s.replicas_of(path))
            assert sorted(got) == list(port_mesh.process_replica_slice(s, n, pid))


@pytest.mark.parametrize("spec_str", SPECS)
def test_check_overlap_topology_matches_the_reference(spec_str):
    port, ref = both(spec_str)
    for n in PROCS:
        got = outcome(port_dist.check_overlap_topology, port, n)[0]
        want = outcome(ref_dist.check_overlap_topology, ref, n)[0]
        assert got == want, (spec_str, n)


def test_check_overlap_topology_names_the_level():
    spec = TopologySpec.load("chip:1 x host:2 x pod:2")
    port_dist.check_overlap_topology(spec, 2)       # host pairs inside a process
    with pytest.raises(ValueError, match="'host'"):
        port_dist.check_overlap_topology(spec, 4)   # host pairs across processes


ENV_CASES = [
    ({}, {}),
    ({"DASO_COORDINATOR": "127.0.0.1:1234", "DASO_NUM_PROCS": "2",
      "DASO_PROC_ID": "1", "DASO_DISPATCH": "overlap"}, {}),
    ({"DASO_COORDINATOR": "127.0.0.1:1234", "DASO_NUM_PROCS": "4"},
     {"process_id": 3, "dispatch": "serial"}),
    ({}, {"coordinator": "h:1", "num_processes": 2, "process_id": 0}),
    ({"DASO_NUM_PROCS": "2"}, {}),                       # no coordinator
    ({"DASO_COORDINATOR": "h:1", "DASO_NUM_PROCS": "2",
      "DASO_PROC_ID": "2"}, {}),                         # id out of range
    ({}, {"dispatch": "async"}),                         # unknown dispatch
]


@pytest.mark.parametrize("env,kw", ENV_CASES)
def test_distributed_config_from_env_matches_the_reference(monkeypatch, env, kw):
    for k in ("DASO_COORDINATOR", "DASO_NUM_PROCS", "DASO_PROC_ID", "DASO_DISPATCH"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def build(mod):
        try:
            c = mod.DistributedConfig.from_env(**kw)
            return (c.coordinator, c.num_processes, c.process_id, c.dispatch)
        except ValueError as e:
            return ("error", type(e).__name__)

    assert build(port_dist) == build(ref_dist)


def test_process_env_sets_identity_and_threads():
    env = port_dist.process_env(2, 1, "127.0.0.1:5", dispatch="overlap",
                                base={"PYTHONPATH": "x", "OMP_NUM_THREADS": "64"})
    assert env["DASO_COORDINATOR"] == "127.0.0.1:5"
    assert (env["DASO_NUM_PROCS"], env["DASO_PROC_ID"], env["DASO_DISPATCH"]) == \
        ("2", "1", "overlap")
    assert env["OMP_NUM_THREADS"] == env["MKL_NUM_THREADS"] == "1"   # never inherited
    src, rest = env["PYTHONPATH"].split(":", 1)
    assert src.endswith("src") and rest == "x"
