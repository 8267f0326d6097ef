"""The multi-process runtime's contract, end to end through the process
launcher (`python -m repro_torch.launch.procs`): an N-process run of the
port's training launcher gives the one-process run of the same arguments
bit for bit: the per-step losses, the final checkpoint (process 0 writes
it) and every replica row of the final carry (each process's
`--proc-report` digests of its own rows). The reference's own contract
(`src/repro/launch/distributed.py:20-26`); its JAX twin
(tests/test_multiprocess.py) is the oracle only where it holds, so here the
oracle is the port's one-process run, itself held to the JAX package's
single-device path by tests/test_torch_train.py.

Real processes on gloo over localhost, at `--tiny` size on the CPU. The
launcher runs in this process (`procs.main`); one refusal goes through
`python -m` itself (tests/test_torch_distributed.py checks the refusals in
one process). The per-step, fault-plan, four-process and EASGD /
DOWNPOUR legs are @slow, as the reference marks its own
(tests/test_multiprocess.py:97-172, tests/test_strategies.py:348)."""
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.launch import procs as launcher

TOPOLOGY = "chip:4 x host:2@50e9 x pod:2@25e9"   # R = 4, P = 16, host pairs
BASE = ["--tiny", "--device", "cpu", "--per-node-batch", "2", "--seq-len", "16",
        "--b-max", "4", "--seed", "0"]


def run_group(tmp_path, name, procs, args, *, timeout=120):
    """One launch; returns its output directory."""
    out = tmp_path / name
    code = launcher.main(["--procs", str(procs), "--timeout", str(timeout), "--"]
                         + BASE + args + ["--ckpt", str(out / "ck"),
                                          "--metrics-out", str(out / "m.json"),
                                          "--proc-report", str(out / "rep")])
    assert code == 0, f"{name}: the {procs}-process group exited {code}"
    return out


def digests(out):
    rows = {}
    for path in sorted(glob.glob(str(out / "rep.p*.json"))):
        with open(path) as f:
            rep = json.load(f)
        assert not set(rows) & set(rep["carry_digest"])  # each row owned once
        rows.update(rep["carry_digest"])
    return rows


def reports(out):
    return [json.load(open(p)) for p in sorted(glob.glob(str(out / "rep.p*.json")))]


def assert_same_run(a, b):
    ma, mb = (json.loads((d / "m.json").read_text()) for d in (a, b))
    assert ma["losses"] == mb["losses"] and len(ma["losses"]) > 0
    assert ma["final_loss"] == mb["final_loss"]
    fa, fb = (np.load(d / "ck" / "arrays.npz") for d in (a, b))
    assert sorted(fa.files) == sorted(fb.files)
    for k in fa.files:
        if k != "__save_id__":  # unique per save by design
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    da, db = digests(a), digests(b)
    assert da and da == db


def contract(tmp_path, args, procs=2):
    one = run_group(tmp_path, "p1", 1, args)
    many = run_group(tmp_path, f"p{procs}", procs, args)
    assert_same_run(one, many)
    return reports(one), reports(many)


def test_two_process_macro_bit_exact(tmp_path):
    """DASO on the macro executor: the host syncs stay inside a process, the
    pod-level exchange crosses the process boundary."""
    _, many = contract(tmp_path, ["--topology", TOPOLOGY, "--steps", "16"])
    for rep in many:
        ex = rep["placement"]["exchange"]
        # every outer exchange gathered (one f32 arena each), no inner sync did
        assert ex["calls"] > 0 and ex["received_bytes"] == ex["payload_bytes"]
        assert rep["placement"]["procs"] == 2


def test_two_process_int8_overlap_dispatch_bit_exact(tmp_path):
    """int8 wire, one-cycle overlap, the exchange's gather on a helper
    thread beside the cycle's local steps (--dispatch overlap)."""
    _, many = contract(tmp_path, ["--topology", TOPOLOGY, "--steps", "16",
                                  "--wire-format", "int8", "--overlap", "one_cycle",
                                  "--dispatch", "overlap"])
    for rep in many:
        assert rep["executor_stats"]["overlap_cycles"] > 0
        assert set(rep["placement"]["exchange"]["by_dtype"]) == {"int8", "float32"}


def test_two_process_gossip_bit_exact(tmp_path):
    """Twin of the reference's test_two_process_gossip_bit_exact: no
    reduction, each process takes its rows' partners from the gathered
    int8 payload."""
    contract(tmp_path, ["--strategy", "gossip", "--wire-format", "int8",
                        "--topology", "chip:4 x pod:4", "--steps", "12"])


def _python_m_launch(procs, args, timeout=60):
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.procs", "--procs",
                           str(procs), "--timeout", str(timeout), "--"] + BASE + args,
                          capture_output=True, text=True, timeout=timeout + 30, env=env)


def test_dispatch_overlap_without_overlap_mode_fails_fast():
    r = _python_m_launch(2, ["--topology", TOPOLOGY, "--steps", "4",
                             "--dispatch", "overlap"])
    assert r.returncode != 0
    assert "requires --overlap one_cycle" in r.stderr + r.stdout


@pytest.mark.slow
def test_two_process_per_step_bit_exact(tmp_path):
    contract(tmp_path, ["--topology", TOPOLOGY, "--steps", "16",
                        "--executor", "per_step"])


@pytest.mark.slow
def test_two_process_fault_plan_bit_exact(tmp_path):
    plan = json.dumps({"events": [{"step": 4, "kind": "crash", "replica": 3},
                                  {"step": 9, "kind": "rejoin", "replica": 3}]})
    contract(tmp_path, ["--topology", TOPOLOGY, "--steps", "16", "--fault-plan", plan])


@pytest.mark.slow
def test_four_process_bit_exact(tmp_path):
    """One replica per process: the host syncs cross processes too."""
    contract(tmp_path, ["--topology", TOPOLOGY, "--steps", "16"], procs=4)


@pytest.mark.slow
@pytest.mark.parametrize("strategy", ["easgd", "downpour"])
def test_two_process_baseline_bit_exact(tmp_path, strategy):
    contract(tmp_path, ["--strategy", strategy, "--wire-format", "bf16",
                        "--topology", "chip:4 x pod:4", "--steps", "12"])
