"""The live fault plane of the port's multi-process runtime
(repro_torch/resilience/runtime.py and the supervisor mode of
`python -m repro_torch.launch.procs`), against the JAX package's on the
same inputs where the function is pure, and against the port's own
simulated fault-plan oracle where it is not:

  * `regroup_fault_events`, `RegroupPlan` (either package reads the
    other's file), `viable_procs`, the heartbeat files and their schema,
    `heartbeat_skew` and `HealthConfig.from_env`;
  * the watchdog hard-exits a wedged process with `EXIT_PEER_LOST`;
  * one supervised run with process 1 SIGKILLed at step 6: the survivor
    regroups onto one process over every replica, resumes from the newest
    intact TrainState and replays the death, and its losses and final
    checkpoint are those of a one-process run of the same crash as a fault
    plan, bit for bit (twin of the reference's
    test_live_kill_regroup_matches_simulated_oracle, which fails in this
    environment on its distributed path). The elastic rejoin and the
    four-process kill are @slow, as the reference marks them."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from repro.resilience import faults as jfaults
from repro.resilience import runtime as jrt
from repro.topo import TopologySpec as JaxTopologySpec
from repro_torch.launch import procs as launcher
from repro_torch.resilience import FaultPlan
from repro_torch.resilience import runtime as rt
from repro_torch.topo import TopologySpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOPOLOGY = "chip:4 x host:2@50e9 x pod:2@25e9"   # R = 4: one pod per process
WATCHDOG_S = 60.0
BASE = ["--tiny", "--device", "cpu", "--per-node-batch", "2", "--seq-len", "16",
        "--b-max", "4", "--seed", "0"]


def _events(evs):
    return [(e.step, e.kind, e.replica) for e in evs]


@pytest.mark.parametrize("step,membership,dead,rejoin", [
    (10, None, [2, 3], False),
    (10, [1.0, 1.0, 0.0, 1.0], [2, 3], False),
    (10, [1.0, 1.0, 0.0, 1.0], [2, 3], True),
    (7, [0.0, 1.0, 1.0, 1.0], [0], True),
])
def test_regroup_fault_events_match_the_reference(step, membership, dead, rejoin):
    got = rt.regroup_fault_events(step, membership, dead, rejoin=rejoin)
    want = jrt.regroup_fault_events(step, membership, dead, rejoin=rejoin)
    assert _events(got) == _events(want)
    alive = None if membership is None else [m > 0 for m in membership]
    assert _events(FaultPlan(tuple(got)).events) == \
        _events(jfaults.FaultPlan(tuple(want)).events)
    FaultPlan(tuple(got)).validate(4, alive0=alive)


def test_regroup_plan_round_trips_across_packages(tmp_path):
    a, b = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    rt.save_regroup(a, rt.RegroupPlan(epoch=2, dead_replicas=(1, 3), rejoin=True))
    jrt.save_regroup(b, jrt.RegroupPlan(epoch=1, dead_replicas=(2,), rejoin=False))
    assert jrt.load_regroup(a) == jrt.RegroupPlan(epoch=2, dead_replicas=(1, 3), rejoin=True)
    assert rt.load_regroup(b) == rt.RegroupPlan(epoch=1, dead_replicas=(2,), rejoin=False)
    assert rt.load_regroup(a) == rt.RegroupPlan(epoch=2, dead_replicas=(1, 3), rejoin=True)


@pytest.mark.parametrize("spec_str", ["chip:1 x host:2 x pod:2", TOPOLOGY,
                                      "chip:1 x host:3 x pod:2", "chip:2 x pod:6"])
def test_viable_procs_matches_the_reference(spec_str):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import launch_procs as ref_launcher

    port, ref = TopologySpec.load(spec_str), JaxTopologySpec.load(spec_str)
    for k in range(1, port.n_replicas + 1):
        assert launcher.viable_procs(port, k) == ref_launcher.viable_procs(ref, k), k


def test_heartbeat_roundtrip_and_schema(tmp_path):
    cfg = rt.HealthConfig(run_dir=str(tmp_path), epoch=3, watchdog_s=60.0,
                          hb_interval=0.05)
    mon = rt.HealthMonitor(cfg, proc_id=1).start()
    try:
        mon.phase("train")
        mon.cycle_done(7)
        deadline, hb = time.time() + 5.0, None
        while time.time() < deadline:
            hb = rt.read_heartbeat(str(tmp_path), 3, 1)
            if hb and hb["step"] == 7:
                break
            time.sleep(0.05)
        assert hb is not None and (hb["proc"], hb["epoch"], hb["phase"], hb["step"]) == \
            (1, 3, "train", 7)
        # the reference reads the port's beats, and both schemas accept them
        assert jrt.read_heartbeat(str(tmp_path), 3, 1)["step"] == 7
        assert rt.validate_heartbeat(hb) is None and jrt.validate_heartbeat(hb) is None
    finally:
        mon.close()
    assert rt.read_heartbeat(str(tmp_path), 3, 1)["phase"] == "done"
    assert rt.read_heartbeat(str(tmp_path), 3, 0) is None
    assert rt.read_heartbeat(str(tmp_path), 2, 1) is None
    for bad in ({}, {"proc": -1, "epoch": 0, "phase": "x", "step": 0, "t": 0}, []):
        assert (rt.validate_heartbeat(bad) is None) == (jrt.validate_heartbeat(bad) is None)


def test_heartbeat_skew_matches_the_reference():
    before = {0: {"t": 10.0, "step": 4}, 1: {"t": 10.0, "step": 4}, 2: {"t": 10.0, "step": 4}}
    after = {0: {"t": 12.0, "step": 12}, 1: {"t": 12.0, "step": 8}, 2: {"t": 12.0, "step": 4}}
    assert rt.heartbeat_skew(before, after) == jrt.heartbeat_skew(before, after)
    assert rt.heartbeat_skew(before, after)[1] == 2.0


def test_health_config_from_env_matches_the_reference(monkeypatch):
    for k in ("DASO_RUN_DIR", "DASO_EPOCH", "DASO_WATCHDOG_S", "DASO_HB_INTERVAL",
              "DASO_REGROUP_FILE"):
        monkeypatch.delenv(k, raising=False)
    assert rt.HealthConfig.from_env() is None and jrt.HealthConfig.from_env() is None
    monkeypatch.setenv("DASO_RUN_DIR", "/tmp/run")
    monkeypatch.setenv("DASO_EPOCH", "2")
    monkeypatch.setenv("DASO_WATCHDOG_S", "45")
    monkeypatch.setenv("DASO_REGROUP_FILE", "/tmp/run/regroup_2.json")
    got, want = rt.HealthConfig.from_env(), jrt.HealthConfig.from_env()
    assert (got.run_dir, got.epoch, got.watchdog_s, got.hb_interval, got.regroup_file) == \
        (want.run_dir, want.epoch, want.watchdog_s, want.hb_interval, want.regroup_file)
    assert rt.EXIT_PEER_LOST == jrt.EXIT_PEER_LOST


def test_watchdog_hard_exits_wedged_process(tmp_path):
    """A worker that stops making progress (parked in a dead collective)
    hard-exits with EXIT_PEER_LOST within the watchdog budget."""
    script = f"""
import time
from repro_torch.resilience.runtime import HealthConfig, HealthMonitor
cfg = HealthConfig(run_dir={str(tmp_path)!r}, watchdog_s=0.6, hb_interval=0.1)
mon = HealthMonitor(cfg, proc_id=0).start()
mon.phase("train")
time.sleep(30)   # no progress report again: the watchdog must fire
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       timeout=25, env=env)
    assert r.returncode == rt.EXIT_PEER_LOST, (r.returncode, r.stderr)
    assert time.monotonic() - t0 < 20.0
    status = json.load(open(tmp_path / "status_0_0.json"))
    assert status["reason"] == "watchdog" and status["phase"] == "train"


# -- a real process death ------------------------------------------------------

def supervised(tmp_path, procs, train_args, *, kill, elastic=False, timeout=200):
    report = tmp_path / "report.json"
    argv = ["--procs", str(procs), "--timeout", str(timeout), "--watchdog",
            str(WATCHDOG_S), "--run-dir", str(tmp_path / "live"), "--report",
            str(report), "--kill", kill] + (["--elastic-rejoin"] if elastic else [])
    code = launcher.main(argv + ["--"] + BASE + train_args)
    return code, json.loads(report.read_text())


def oracle(tmp_path, steps, events):
    """The one-process run with the death scripted as a fault plan."""
    plan = tmp_path / "oracle_plan.json"
    plan.write_text(json.dumps({"events": events}))
    out = tmp_path / "oracle"
    code = launcher.main(["--procs", "1", "--timeout", "120", "--"] + BASE + [
        "--topology", TOPOLOGY, "--steps", str(steps), "--fault-plan", str(plan),
        "--ckpt", str(out / "ck"), "--ckpt-every", "1", "--metrics-out",
        str(out / "m.json")])
    assert code == 0
    return out


def assert_same(live_dir, live_metrics, oracle_dir):
    fa, fb = np.load(live_dir / "arrays.npz"), np.load(oracle_dir / "ck" / "arrays.npz")
    assert sorted(fa.files) == sorted(fb.files)
    for k in fa.files:
        if k != "__save_id__":
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    want = json.loads((oracle_dir / "m.json").read_text())
    assert live_metrics["losses"] == want["losses"]
    assert live_metrics["final_loss"] == want["final_loss"]


def test_live_kill_regroup_matches_simulated_oracle(tmp_path):
    steps = 24
    ck, metrics = tmp_path / "ckpt_live", tmp_path / "metrics_live.json"
    code, rep = supervised(tmp_path, 2, ["--topology", TOPOLOGY, "--steps", str(steps),
                                         "--ckpt", str(ck), "--ckpt-every", "1",
                                         "--metrics-out", str(metrics)], kill="1:6")
    assert code == 0 and rep["ok"] and rep["kill"]["proc"] == 1
    assert 0.0 <= rep["timings"]["detect_s"] < WATCHDOG_S
    assert rep["timings"]["regroup_s"] > 0.0 and rep["timings"]["resume_s"] > 0.0
    assert [e["outcome"] for e in rep["epochs"]] == ["failed", "ok"]
    assert [e["procs"] for e in rep["epochs"]] == [2, 1]
    assert rep["dead_replicas"] == [2, 3]      # process 1 of 2 owns pod 1
    live = json.loads(metrics.read_text())
    meta = live["resilience"]["live"]
    assert meta["epoch"] == 1 and meta["dead_replicas"] == [2, 3]
    crash = meta["crash_step"]
    # the newest intact TrainState: the kill fires once process 1's beat
    # (written every 0.25 s) shows step 6, so a fast host may be a cycle or
    # two past it; the regrouped epoch still has steps to replay
    assert 0 < crash < steps
    out = oracle(tmp_path, steps, [{"step": crash, "kind": "crash", "replica": r}
                                   for r in meta["dead_replicas"]])
    assert_same(ck, live, out)


@pytest.mark.slow
def test_live_elastic_rejoin(tmp_path):
    steps = 24
    ck, metrics = tmp_path / "ckpt_live", tmp_path / "metrics_live.json"
    code, rep = supervised(tmp_path, 2, ["--topology", TOPOLOGY, "--steps", str(steps),
                                         "--ckpt", str(ck), "--ckpt-every", "1",
                                         "--metrics-out", str(metrics)], kill="1:6",
                           elastic=True)
    assert code == 0 and [e["procs"] for e in rep["epochs"]] == [2, 2]
    live = json.loads(metrics.read_text())
    meta = live["resilience"]["live"]
    assert meta["rejoin"]
    crash = meta["crash_step"]
    events = [{"step": crash, "kind": k, "replica": r}
              for k in ("crash", "rejoin") for r in meta["dead_replicas"]]
    assert_same(ck, live, oracle(tmp_path, steps, events))


@pytest.mark.slow
def test_live_kill_four_procs_matches_oracle(tmp_path):
    """One replica per process; the survivors regroup onto 2 processes (3
    does not divide 4 replicas)."""
    steps = 24
    ck, metrics = tmp_path / "ckpt_live", tmp_path / "metrics_live.json"
    code, rep = supervised(tmp_path, 4, ["--topology", TOPOLOGY, "--steps", str(steps),
                                         "--ckpt", str(ck), "--ckpt-every", "1",
                                         "--metrics-out", str(metrics)], kill="2:6")
    assert code == 0 and [e["procs"] for e in rep["epochs"]] == [4, 2]
    assert rep["dead_replicas"] == [2]
    live = json.loads(metrics.read_text())
    crash = live["resilience"]["live"]["crash_step"]
    assert_same(ck, live, oracle(tmp_path, steps,
                                 [{"step": crash, "kind": "crash", "replica": 2}]))
