"""Spawn N local processes of one torch.distributed group (the port's twin
of the reference's `tools/launch_procs.py`).

The development and test harness of the multi-process runtime
(`launch/distributed.py`): each child is one "host" of the topology,
owning a block of its replica rows, joined through a gloo coordinator on a
free localhost port. Children get an explicitly built environment
(`env.process_env`): the ``DASO_COORDINATOR`` / ``DASO_NUM_PROCS`` /
``DASO_PROC_ID`` identity that `DistributedConfig.from_env` reads, this
checkout's `src` on PYTHONPATH and one CPU thread each, so a one-process
and an N-process run split their CPU work alike.

Everything after ``--`` goes to the target module verbatim
(``repro_torch.launch.train`` by default, with ``--distributed`` appended
when missing). On a card every child takes ``cuda:{proc % device
count}``; with one card the processes share it.

  # two processes, one pod each: the pod-level exchange crosses processes
  python -m repro_torch.launch.procs --procs 2 -- --tiny --device cpu \\
      --topology "chip:4 x host:2@50e9 x pod:2@25e9" --steps 16 \\
      --ckpt /tmp/ck2 --metrics-out /tmp/m2.json
  # the same run in one process: the oracle the two-process run gives bit
  # for bit
  python -m repro_torch.launch.procs --procs 1 -- ...the same arguments...
  # every launcher flag passes through, e.g. the per-leaf exchange (one
  # gather per leaf, the same numbers) or a fault plan under --autotune
  python -m repro_torch.launch.procs --procs 2 -- ...the same arguments... \
      --exchange-impl per_leaf

Exit status: 0 iff every child exited 0. The first failure ends the rest
of the group (a peer waiting in a collective would otherwise wait for its
timeout); `--timeout` bounds the whole group (exit 124).

Supervisor mode (``--supervise``, implied by ``--kill``) adds the live
fault plane (`resilience/runtime.py`): children write heartbeats into a
shared run directory, ``--kill proc:step`` SIGKILLs one child once its
heartbeat reaches that training step, and a detected death triggers a
regroup instead of a group failure: the survivors are torn down and
relaunched under a fresh coordinator epoch (new port, fewer processes,
more rows each), resuming from the newest intact checkpoint with the death
replayed as a membership crash event. ``--elastic-rejoin`` restarts the
full process count instead, the reborn ranks rejoining through the reseed
path. ``--report`` writes the detection, regroup and resume timings.

  # kill process 1 at step 6; the survivor regroups and finishes
  python -m repro_torch.launch.procs --procs 2 --kill 1:6 --report /tmp/r.json \\
      -- --tiny --device cpu --topology "chip:4 x host:2@50e9 x pod:2@25e9" \\
      --steps 14 --ckpt /tmp/ck --ckpt-every 1 --metrics-out /tmp/m.json
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

# standard library only at import: a plain launch spawns its group without
# importing torch (the supervisor mode imports the topology and the health
# plane)
from repro_torch.launch.env import process_env
from repro_torch.launch.mesh import process_replica_slice, validate_process_topology

TRAIN_MODULE = "repro_torch.launch.train"


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_flag_value(child_args, flag: str):
    """Value of `--flag VALUE` / `--flag=VALUE` in the child args, or None.
    The last one wins, as in argparse."""
    val = None
    for i, a in enumerate(child_args):
        if a == flag:
            if i + 1 >= len(child_args):
                raise SystemExit(f"{flag} given without a value")
            val = child_args[i + 1]
        elif a.startswith(flag + "="):
            val = a.split("=", 1)[1]
    return val


def topology_spec(child_args):
    """The child run's TopologySpec, or None without --topology."""
    spec_arg = child_flag_value(child_args, "--topology")
    if spec_arg is None:
        return None
    from repro_torch.topo import TopologySpec
    return TopologySpec.load(spec_arg)


def merge_trace(child_args) -> None:
    """Merge the per-process trace streams of a --trace-out run into the
    one run trace at that path, after the group has exited (no worker can
    still append; a crashed worker's partial stream merges as it is)."""
    base = child_flag_value(child_args, "--trace-out")
    if base is None:
        return
    from repro_torch.obs.trace import merge_streams

    def say(m):
        print(f"[procs] {m}", file=sys.stderr)

    try:
        if merge_streams(base, log=say) is None:
            say(f"no trace streams found at {base}.e*p*.jsonl")
    except (OSError, ValueError) as e:
        say(f"trace merge failed: {e}")


def viable_procs(spec, max_procs: int) -> int:
    """The largest process count <= max_procs the topology can regroup
    onto: the replicas divide and every process owns whole subtrees
    (`mesh.validate_process_topology`). The regrouped epoch spans every
    replica with fewer processes, more rows each."""
    for k in range(max_procs, 0, -1):
        try:
            validate_process_topology(spec, k)
            return k
        except ValueError:
            continue
    raise SystemExit(f"topology {spec.to_str()} has no viable process "
                     f"count <= {max_procs}")


def child_env(procs: int, pid: int, port: int, extra: dict | None = None) -> dict:
    """A child's environment: `env.process_env` (identity,
    PYTHONPATH, thread count), plus the supervision variables (DASO_RUN_DIR
    and the rest) in supervisor mode."""
    env = process_env(procs, pid, f"127.0.0.1:{port}")
    if extra:
        env.update(extra)
    return env


def _with_distributed(module: str, child_args) -> list:
    child_args = list(child_args)
    if module == TRAIN_MODULE and "--distributed" not in child_args:
        child_args.append("--distributed")
    return child_args


def _pump(proc: subprocess.Popen, tag: str, sink) -> None:
    for line in proc.stdout:
        sink.write(f"[{tag}] {line}")
        sink.flush()


def _spawn_group(procs, child_args, module, port, extra_env, sink):
    cmd = [sys.executable, "-m", module] + list(child_args)
    children, pumps = [], []
    for pid in range(procs):
        p = subprocess.Popen(
            cmd, env=child_env(procs, pid, port, extra_env(pid)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        t = threading.Thread(target=_pump, args=(p, f"p{pid}", sink), daemon=True)
        t.start()
        children.append(p)
        pumps.append(t)
    return children, pumps


def _teardown(children, *, grace: float = 10.0) -> None:
    for p in children:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + grace
    for p in children:
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch(procs: int, child_args, *, module: str = TRAIN_MODULE,
           port: int | None = None, timeout: float = 1800.0, quiet: bool = False) -> int:
    """Run the process group to its end; returns the worst exit code."""
    child_args = _with_distributed(module, child_args)
    port = port or free_port()
    sink = open(os.devnull, "w") if quiet else sys.stderr
    children, pumps = _spawn_group(procs, child_args, module, port, lambda pid: None,
                                   sink)
    deadline = time.monotonic() + timeout
    codes = [None] * procs
    try:
        while any(c is None for c in codes):
            for i, p in enumerate(children):
                if codes[i] is None:
                    codes[i] = p.poll()
            bad = [i for i, c in enumerate(codes) if c not in (None, 0)]
            if bad or time.monotonic() > deadline:
                if not bad:
                    print(f"[procs] timeout after {timeout:.0f}s", file=sys.stderr)
                    codes = [c if c is not None else 124 for c in codes]
                else:
                    print(f"[procs] process {bad[0]} exited {codes[bad[0]]}; "
                          f"terminating the group", file=sys.stderr)
                for p in children:
                    if p.poll() is None:
                        p.send_signal(signal.SIGTERM)
                break
            time.sleep(0.05)
        for p in children:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    finally:
        for t in pumps:
            t.join(timeout=5)
        if quiet:
            sink.close()
    # a child still running at the deadline keeps its timeout code (124)
    # even if SIGTERM let it exit 0: a timed-out group never reports success
    codes = [c if c == 124 else p.returncode for c, p in zip(codes, children)]
    merge_trace(child_args)
    return max(abs(c) for c in codes)


# -- supervisor mode: live fault injection and regroup -------------------------

def parse_kill(s: str):
    """--kill "proc:step" -> (proc, step)."""
    try:
        proc, step = s.split(":")
        return int(proc), int(step)
    except ValueError:
        raise SystemExit(f"--kill expects PROC:STEP (e.g. 1:6), got {s!r}")


def _monitor_epoch(children, *, run_dir, epoch, deadline, kill, watchdog_s,
                   exit_peer_lost, read_hb):
    """Poll one epoch's group to its end or its first failure. Returns a
    dict: outcome "ok" | "failed" | "timeout", per-child codes, the root
    failure (proc id, mechanism, time), the kill's time if it fired, and
    t_train (the first heartbeat in phase "train", which recovery is timed
    to)."""
    n = len(children)
    codes = [None] * n
    out = {"outcome": None, "codes": codes, "root": None,
           "t_kill": None, "t_train": None}
    kill_pending = kill is not None
    # a worker silent this long past the watchdog has a wedged watchdog too
    stall_s = watchdog_s + 60.0
    spawn_t = time.monotonic()
    last_beat = [spawn_t] * n       # when a fresh beat was last seen
    seen_t = [None] * n             # the beat's own wall-clock stamp
    last_step = [-1] * n

    def fail(root, mechanism, code=None):
        out["outcome"] = "failed"
        out["root"] = {"proc": root, "mechanism": mechanism, "code": code,
                       "t": time.monotonic(), "step": last_step[root]}

    while True:
        for i, p in enumerate(children):
            if codes[i] is None:
                codes[i] = p.poll()
        for i in range(n):
            hb = read_hb(run_dir, epoch, i)
            if hb is not None:
                if hb.get("t") != seen_t[i]:
                    seen_t[i] = hb.get("t")
                    last_beat[i] = time.monotonic()
                last_step[i] = int(hb.get("step", -1))
                if out["t_train"] is None and hb.get("phase") == "train":
                    out["t_train"] = time.monotonic()
        if kill_pending and codes[kill[0]] is None and last_step[kill[0]] >= kill[1]:
            children[kill[0]].send_signal(signal.SIGKILL)
            out["t_kill"] = time.monotonic()
            kill_pending = False
        bad = [i for i, c in enumerate(codes) if c not in (None, 0)]
        if bad:
            # a child that exits EXIT_PEER_LOST detected a peer's loss (gloo's
            # error or its watchdog): the root is a child that failed
            # otherwise, else whoever stopped making progress first
            roots = [i for i in bad if codes[i] != exit_peer_lost]
            if roots or n == 1:
                root = (roots or bad)[0]
                fail(root, "exit", codes[root])
            else:
                suspects = [i for i in range(n) if codes[i] != exit_peer_lost] or list(range(n))
                root = min(suspects, key=lambda i: last_beat[i])
                fail(root, "peer_lost", codes[bad[0]])
            return out
        alive = [i for i, c in enumerate(codes) if c is None]
        if not alive:
            out["outcome"] = "ok"
            return out
        now = time.monotonic()
        for i in alive:
            if now - last_beat[i] > stall_s:
                children[i].kill()
                fail(i, "stall")
                return out
        if now > deadline:
            out["outcome"] = "timeout"
            return out
        time.sleep(0.05)


def supervise(procs: int, child_args, *, module: str = TRAIN_MODULE,
              timeout: float = 1800.0, quiet: bool = False,
              kill: tuple | None = None, watchdog_s: float | None = None,
              hb_interval: float = 0.25, max_regroups: int = 2,
              elastic: bool = False, run_dir: str | None = None,
              report_path: str | None = None) -> int:
    """Run the group under live-fault supervision: heartbeat-triggered
    SIGKILL injection (`kill=(proc, step)`), bounded failure detection and
    regroup-restart of the survivors under fresh coordinator epochs
    (resuming from the newest intact checkpoint, the death replayed as a
    membership crash event: resilience/runtime.py has the protocol).
    Returns 0 iff the final epoch completed cleanly."""
    from repro_torch.resilience import runtime as rt

    child_args = _with_distributed(module, child_args)
    spec = topology_spec(child_args)
    if spec is None:
        raise SystemExit("supervisor mode needs --topology in the child args (a "
                         "dead process's replicas are derived from the topology)")
    if child_flag_value(child_args, "--ckpt") is None or \
            child_flag_value(child_args, "--ckpt-every") is None:
        raise SystemExit("supervisor mode needs --ckpt DIR --ckpt-every N in the "
                         "child args: a regrouped epoch resumes from the newest "
                         "intact checkpoint")
    if child_flag_value(child_args, "--overlap") not in (None, "off"):
        raise SystemExit("supervisor mode needs --overlap off: recovery replays "
                         "membership fault events, which the overlap schedule "
                         "refuses")
    watchdog_s = watchdog_s if watchdog_s is not None else rt.DEFAULT_WATCHDOG_S
    run_dir = run_dir or tempfile.mkdtemp(prefix="daso-live-")
    os.makedirs(run_dir, exist_ok=True)
    sink = open(os.devnull, "w") if quiet else sys.stderr
    deadline = time.monotonic() + timeout

    report = {"ok": False, "exit_code": 1, "procs": procs, "watchdog_s": watchdog_s,
              "run_dir": run_dir, "elastic": elastic, "kill": None, "epochs": [],
              "dead_replicas": [], "timings": {}}
    if kill is not None:
        report["kill"] = {"proc": kill[0], "step": kill[1]}

    def finish(code: int) -> int:
        # a regrouped run leaves one stream per (epoch, proc); the merge
        # puts them all on one timeline
        merge_trace(child_args)
        report["exit_code"] = code
        report["ok"] = code == 0
        if report_path:
            with open(report_path, "w") as f:
                json.dump(report, f, indent=1)
        if quiet:
            sink.close()
        return code

    epoch, regroups = 0, 0
    dead: list[int] = []
    n = procs
    t0 = time.monotonic()
    t_detect = t_kill = None
    children = []
    try:
        while True:
            port = free_port()
            extra = {rt.ENV_RUN_DIR: run_dir, rt.ENV_EPOCH: str(epoch),
                     rt.ENV_WATCHDOG_S: str(watchdog_s),
                     rt.ENV_HB_INTERVAL: str(hb_interval)}
            if epoch > 0:
                rg_path = os.path.join(run_dir, f"regroup_{epoch}.json")
                rt.save_regroup(rg_path, rt.RegroupPlan(
                    epoch=epoch, dead_replicas=tuple(dead), rejoin=elastic))
                extra[rt.ENV_REGROUP_FILE] = rg_path
            t_spawn = time.monotonic()
            children, pumps = _spawn_group(n, child_args, module, port,
                                           lambda pid: extra, sink)
            mon = _monitor_epoch(
                children, run_dir=run_dir, epoch=epoch, deadline=deadline,
                kill=kill if epoch == 0 else None, watchdog_s=watchdog_s,
                exit_peer_lost=rt.EXIT_PEER_LOST, read_hb=rt.read_heartbeat)
            _teardown(children)
            for t in pumps:
                t.join(timeout=5)
            codes = [p.returncode for p in children]
            rec = {"epoch": epoch, "procs": n, "codes": codes, "outcome": mon["outcome"]}
            if mon["t_kill"] is not None:
                t_kill = mon["t_kill"]
                report["kill"]["t_after_start_s"] = t_kill - t0
            if epoch > 0:
                rec["regroup_s"] = t_spawn - t_detect
                if mon["t_train"] is not None:
                    rec["resume_s"] = mon["t_train"] - t_spawn
            report["epochs"].append(rec)

            if mon["outcome"] == "ok":
                if epoch > 0:
                    report["timings"] = {
                        "detect_s": t_detect - t_kill if t_kill is not None else None,
                        "regroup_s": report["epochs"][-1].get("regroup_s"),
                        "resume_s": report["epochs"][-1].get("resume_s"),
                        "total_s": time.monotonic() - t0}
                return finish(0)
            if mon["outcome"] == "timeout":
                print(f"[procs] supervised run timed out after {timeout:.0f}s "
                      f"(epoch {epoch})", file=sys.stderr)
                return finish(124)
            root = mon["root"]
            t_detect = root["t"]
            rec["detect"] = {"proc": root["proc"], "mechanism": root["mechanism"],
                             "code": root["code"],
                             "detect_s": t_detect - t_kill if t_kill is not None else None}
            lost = list(process_replica_slice(spec, n, root["proc"]))
            print(f"[procs] epoch {epoch}: process {root['proc']} lost "
                  f"({root['mechanism']}, code={root['code']}) -> replicas {lost} dead"
                  + (f", detected {rec['detect']['detect_s']:.2f}s after kill"
                     if rec["detect"]["detect_s"] is not None else ""), file=sys.stderr)
            if regroups >= max_regroups:
                print(f"[procs] giving up after {regroups} regroups", file=sys.stderr)
                return finish(max(abs(c or 1) for c in codes))
            # elastic epochs rejoin their dead at the resume step, so each
            # failure stands alone; plain regroups add to the dead set (the
            # worker drops crashes its checkpoint's membership already has)
            dead = sorted(set(lost) if elastic else set(dead) | set(lost))
            report["dead_replicas"] = dead
            n = procs if elastic else viable_procs(spec, n - 1)
            regroups += 1
            epoch += 1
            print(f"[procs] regroup {regroups}: epoch {epoch} with {n} process(es) "
                  f"over all {spec.n_replicas} replicas "
                  f"({spec.n_replicas // n} rows each)"
                  + (", elastic rejoin" if elastic else ""), file=sys.stderr)
    finally:
        _teardown(children, grace=2.0)  # no child outlives the supervisor


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.procs",
        description="spawn N local processes of one torch.distributed group "
                    "(arguments after -- go to the target module)")
    ap.add_argument("--procs", type=int, required=True)
    ap.add_argument("--module", default=TRAIN_MODULE,
                    help="python module every process runs (--distributed is "
                         "appended for the default)")
    ap.add_argument("--port", type=int, default=None,
                    help="coordinator port (default: a free one)")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds before the whole group is killed (exit 124)")
    ap.add_argument("--quiet", action="store_true",
                    help="drop the children's output (the exit status stays)")
    ap.add_argument("--supervise", action="store_true",
                    help="run under the live fault plane: heartbeats, bounded "
                         "detection and regroup of the survivors on a process "
                         "death (implied by --kill)")
    ap.add_argument("--kill", default=None, metavar="PROC:STEP",
                    help="SIGKILL child PROC once its heartbeat reaches training "
                         "step STEP (implies --supervise)")
    ap.add_argument("--watchdog", type=float, default=None,
                    help="per-worker progress watchdog, seconds (default "
                         "resilience.runtime's; must exceed the slowest cycle)")
    ap.add_argument("--max-regroups", type=int, default=2)
    ap.add_argument("--elastic-rejoin", action="store_true",
                    help="regroup with the original process count: the restarted "
                         "ranks rejoin and are reseeded from the survivors' mean")
    ap.add_argument("--run-dir", default=None,
                    help="shared heartbeat / regroup directory (default: a new "
                         "temporary one)")
    ap.add_argument("--report", default=None, metavar="JSON",
                    help="write the supervision report (detect / regroup / resume "
                         "timings, each epoch's outcome) here")
    ap.add_argument("child_args", nargs=argparse.REMAINDER,
                    help="-- then the target module's arguments")
    args = ap.parse_args(argv)
    rest = args.child_args
    if rest and rest[0] == "--":
        rest = rest[1:]
    if args.supervise or args.kill is not None:
        return supervise(args.procs, rest, module=args.module, timeout=args.timeout,
                         quiet=args.quiet,
                         kill=parse_kill(args.kill) if args.kill else None,
                         watchdog_s=args.watchdog, max_regroups=args.max_regroups,
                         elastic=args.elastic_rejoin, run_dir=args.run_dir,
                         report_path=args.report)
    return launch(args.procs, rest, module=args.module, port=args.port,
                  timeout=args.timeout, quiet=args.quiet)


if __name__ == "__main__":
    sys.exit(main())
