"""Training launcher of the port (`repro/launch/train.py`, its
single-process flags): DASO (R virtual nodes as the replica axis on one
device), the local-SGD ablation, the gossip / EASGD / DOWNPOUR baselines
or the sync baseline, on CUDA unless `--device cpu`. It runs the macro-cycle executor (core/executor.py) by
default, one dispatch per controller cycle; `--executor per_step` runs one
step per dispatch.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --strategy daso --steps 300 --nodes 4 --b-max 4 [--tiny | --full] \\
      [--executor macro|per_step] [--max-cycle-len 32] [--device cpu]

  # the beyond-paper exchange: int8 on the wire, merged one cycle stale,
  # each exchange on its own CUDA stream while the cycle's local steps run
  PYTHONPATH=src python -m repro_torch.launch.train --tiny --device cpu \\
      --wire-format int8 --overlap one_cycle [--overlap-serial-exchange]

  # checkpoints: a TrainState every 20 steps in DIR/step_XXXXXXXX/, the
  # final params in DIR; then resume one of them (the same numbers as the
  # uninterrupted run, bit for bit)
  PYTHONPATH=src python -m repro_torch.launch.train --tiny --steps 60 \\
      --ckpt DIR --ckpt-every 20
  PYTHONPATH=src python -m repro_torch.launch.train --tiny --steps 60 \\
      --ckpt DIR --resume DIR/step_00000020

  # an N-level topology: 4 replicas in 2 hosts of 2 pods, P = 16; the
  # host level averages its pairs every B_host = 2 steps (50 / 25 GB/s),
  # the pod level runs the paper's schedule; prints the topology line
  PYTHONPATH=src python -m repro_torch.launch.train --tiny --device cpu \
      --topology "chip:4 x host:2@50e9 x pod:2@25e9" --steps 40

  # a baseline: gossip averages pairs of replicas every B steps (easgd,
  # downpour: the elastic center and the parameter server's pushes)
  PYTHONPATH=src python -m repro_torch.launch.train --tiny --device cpu \
      --strategy gossip --wire-format int8 --steps 40

  # a fault plan (resilience/faults.py JSON, a file or inline) replayed by
  # the resilience supervisor on the simulated clock: replica 2 crashes at
  # step 10 and rejoins at step 22; prints one line per event, and
  # --metrics-out gets a "resilience" record
  PYTHONPATH=src python -m repro_torch.launch.train --tiny --device cpu \
      --steps 40 --fault-plan '{"events": [{"step": 10, "kind": "crash",
      "replica": 2}, {"step": 22, "kind": "rejoin", "replica": 2}]}'

  # a JSONL run trace (obs/trace.py): the run_metadata event, the macro
  # executor's cycle / overlap / compile / checkpoint events, the
  # controller's decisions and the per-level comm_meters counter; the
  # stream PATH.e0p0.jsonl is merged into PATH at the end of the run.
  # tools/trace_report.py PATH reads it where JAX is installed
  PYTHONPATH=src python -m repro_torch.launch.train --tiny --device cpu \
      --steps 40 --trace-out runs/trace.jsonl --metrics-out runs/m.json

  # the multi-process runtime (launch/distributed.py): two processes, one
  # pod of the topology each, through the process launcher; the same run
  # with --procs 1 gives the same losses and checkpoint bit for bit
  PYTHONPATH=src python -m repro_torch.launch.procs --procs 2 -- \
      --tiny --device cpu --topology "chip:4 x host:2@50e9 x pod:2@25e9" \
      --steps 16 --ckpt DIR --metrics-out runs/m.json

`--distributed` places the run over a torch.distributed process group
(gloo) whose identity comes from `--coordinator` / `--procs` / `--proc-id`
or the DASO_* environment `launch/procs.py` exports; it needs `--topology`.
Process 0 alone logs, writes `--metrics-out` and the checkpoints; each
process writes its own trace stream (PATH.e{epoch}p{proc}.jsonl, merged by
the process launcher) and, with `--proc-report PATH`, its own
PATH.p{proc}.json (gathers, kernel launches, peak memory, cycle times, a
digest per replica row of its final carry). Under the launcher's supervisor
mode a relaunched epoch reads its regroup file and resumes from the newest
intact TrainState with the dead replicas' crash replayed.

Either package loads the other's checkpoints (`checkpoint/io.py`), and
reads the other's traces. The reference's other flags (the per-leaf
exchange, autotune) are not ported yet: each is refused with the ROADMAP
item that will port it.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

import torch

from repro_torch.checkpoint.io import (TrainState, fit_tree, load_latest_train_state,
                                       load_train_state, save_checkpoint)
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import MAMBA, RGLRU
from repro_torch.core.executor import MacroCycleExecutor, list_strategies
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import launch_counts
from repro_torch.launch import distributed as dist_rt
from repro_torch.launch.mesh import validate_process_topology
from repro_torch.models.lm import init_params
from repro_torch.obs import meters
from repro_torch.obs.trace import Tracer, merge_streams, stream_path
from repro_torch.optim.optimizers import sgd
from repro_torch.optim.schedules import warmup_linear_scaled
from repro_torch.resilience import FaultPlan, run_with_faults
from repro_torch.resilience import runtime as live
from repro_torch.topo import TopologySpec, derive_inner_periods
from repro_torch.train.loop import (TrainLoopConfig, build_strategy, ckpt_step_dir,
                                    make_placement, run_training, save_placed_train_state)
from repro_torch.train.step import make_lm_loss
from repro_torch.tree import leaves, tree_map

# flags of the reference launcher that wait for a later part of the port,
# with the ROADMAP item that ports them
LATER_FLAGS = {"--exchange-impl": 7, "--autotune": 18, "--autotune-every": 18}


def refuse_later_flags(argv) -> None:
    """Raise on any flag of `LATER_FLAGS`, naming its ROADMAP item."""
    for tok in argv:
        flag = tok.split("=", 1)[0]
        if flag in LATER_FLAGS:
            raise SystemExit(f"train: {flag} is not ported yet "
                             f"(ROADMAP item {LATER_FLAGS[flag]})")


def parse_args(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    refuse_later_flags(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--strategy", default="daso", choices=list_strategies())
    ap.add_argument("--executor", default="macro", choices=["macro", "per_step"],
                    help="macro = one dispatch per controller cycle; per_step = "
                         "one per step")
    ap.add_argument("--max-cycle-len", type=int, default=32)
    ap.add_argument("--wire-format", default=None, choices=["f32", "bf16", "int8"],
                    help="wire tier of the global exchange; default derives "
                         "bf16 / f32 per phase, int8 is the block-scaled tier "
                         "(K5 / K6)")
    ap.add_argument("--overlap", default="off", choices=["off", "one_cycle"],
                    help="double-buffered overlap of the global exchange: each "
                         "exchange merged one cycle stale (daso only); the macro "
                         "executor runs it on its own CUDA stream while the "
                         "cycle's local steps run, the per-step one in order")
    ap.add_argument("--overlap-serial-exchange", action="store_true",
                    help="the macro executor waits for each overlap exchange "
                         "before the cycle's local steps: the same numbers, and "
                         "the exchange's own time in executor_stats")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--nodes", type=int, default=4,
                    help="DASO replicas (paper nodes); superseded by --topology")
    ap.add_argument("--local-world", type=int, default=4)
    ap.add_argument("--b-max", type=int, default=4)
    ap.add_argument("--topology", default=None, metavar="SPEC",
                    help="N-level cluster topology (repro_torch/topo): a spec "
                         "string like 'chip:4 x host:2 x pod:2', inline JSON or "
                         "a JSON file path. Replica count and world size come "
                         "from the level fanouts; specs of more than 2 levels run "
                         "the hier_daso per-level sync schedule")
    ap.add_argument("--per-node-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the parameter init and the synthetic data")
    ap.add_argument("--full", action="store_true",
                    help="the published config instead of the reduced one")
    ap.add_argument("--tiny", action="store_true",
                    help="shrink the reduced config to quickstart scale (2 "
                         "layers, d_model 128, vocab 256)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers (widths "
                         "unchanged)")
    ap.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                    help="params and compute in this dtype (default: the "
                         "config's; the reduced configs are float32)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory: the final params always land "
                         "here; with --ckpt-every, TrainStates in step_XXXXXXXX/")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save a resumable TrainState every N steps (requires "
                         "--ckpt)")
    ap.add_argument("--resume", default=None, metavar="STATE_DIR",
                    help="resume from a TrainState directory written by "
                         "--ckpt-every (by either package)")
    ap.add_argument("--fault-plan", default=None, metavar="PLAN_JSON",
                    help="replay a declarative fault plan (JSON file or text: "
                         "crash / rejoin / straggle / recover / degrade_dcn / "
                         "restore_dcn events) through the resilience supervisor "
                         "on the macro executor; replica-axis strategies, "
                         "--overlap off")
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a JSONL run trace (obs/trace.py): the macro "
                         "executor's and the controller's events and the comm "
                         "meters; the stream PATH.e0p0.jsonl is merged into PATH. "
                         "Inspect with tools/trace_report.py")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; under --distributed, cuda means "
                         "cuda:{proc %% device count}")
    ap.add_argument("--distributed", action="store_true",
                    help="run over a torch.distributed process group (gloo; "
                         "launch/distributed.py), each process owning a block of "
                         "the topology's replica rows; requires --topology. With "
                         "one process this is the run the N-process run gives bit "
                         "for bit")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="the process group's coordinator (default "
                         "$DASO_COORDINATOR, which launch/procs.py exports)")
    ap.add_argument("--procs", type=int, default=None,
                    help="process count (default $DASO_NUM_PROCS)")
    ap.add_argument("--proc-id", type=int, default=None,
                    help="this process's id (default $DASO_PROC_ID)")
    ap.add_argument("--dispatch", default=None, choices=["serial", "overlap"],
                    help="where an overlap cycle's exchange gathers (default "
                         "$DASO_DISPATCH or serial): serial waits for it before "
                         "the cycle's local steps; overlap runs it beside them "
                         "and requires --overlap one_cycle")
    ap.add_argument("--proc-report", default=None, metavar="PATH",
                    help="each process writes PATH.p{proc}.json: its gathers, "
                         "kernel launches, peak device memory, cycle times and a "
                         "digest per replica row of its final carry")
    args = ap.parse_args(argv)
    if args.ckpt_every and not args.ckpt:
        ap.error("--ckpt-every requires --ckpt")
    return args


def build_config(args):
    cfg = get_config(args.arch) if args.full else get_reduced(args.arch)
    if MAMBA in cfg.layer_pattern:
        raise SystemExit(f"train: {args.arch} needs a backward through the selective "
                         f"scan, which is not ported (ROADMAP item 23)")
    if RGLRU in cfg.layer_pattern:
        raise SystemExit(f"train: {args.arch} needs a backward through the RG-LRU "
                         f"scan (K8), which is not ported (ROADMAP item 23)")
    if args.tiny:
        if args.full:
            raise SystemExit("train: --tiny and --full are mutually exclusive")
        cfg = cfg.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                          head_dim=32, d_ff=256, vocab_size=256)
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)
    if args.dtype is not None:
        dtype = getattr(torch, args.dtype)
        cfg = cfg.replace(param_dtype=dtype, compute_dtype=dtype)
    return cfg


def run_fault_plan(args, loss_fn, params0, data_fn, loop_cfg, lr_fn, spec, tracer,
                   device, *, regroup=None, health=None, say=print):
    """`--fault-plan`, or a regrouped epoch of a supervised run: the plan
    (its topology-node events resolved against `spec`) replayed by
    `resilience.run_with_faults` on the macro executor, with `--resume` and
    `--ckpt-every` (the TrainState keeps the membership mask). A `regroup`
    (resilience.runtime.RegroupPlan) resumes from the newest intact
    TrainState in `--ckpt` and replays the dead replicas' crash at its step,
    then any scripted event still ahead. Returns (ResilienceReport, its
    losses the whole run's; the live record or None)."""
    if args.strategy == "sync":
        raise SystemExit("train: --fault-plan requires a replica-axis strategy "
                         "(daso / local_sgd / gossip / easgd / downpour)")
    if args.executor != "macro":
        raise SystemExit("train: --fault-plan drives the macro-cycle supervisor; "
                         "--executor per_step is not supported with it")
    if args.overlap != "off":
        raise SystemExit("train: --fault-plan with --overlap is not supported: a "
                         "membership change mid-cycle would merge a pending snapshot "
                         "taken under the old active set (stale exchange weights). "
                         "Run fault plans with the blocking schedule (--overlap off).")
    strategy = build_strategy(loss_fn, loop_cfg, sgd(momentum=0.9, weight_decay=1e-4))
    placement = make_placement(loop_cfg)
    ts, live_meta = None, None
    if regroup is not None:
        resumed_from, ts = load_latest_train_state(args.ckpt, device=device,
                                                   expect_overlap="off",
                                                   placement=placement)
        plan = FaultPlan(tuple(live.regroup_fault_events(
            ts.step, ts.membership, regroup.dead_replicas, rejoin=regroup.rejoin)))
        if args.fault_plan:
            # the scripted events still ahead of the resume step
            scripted = FaultPlan.from_json(args.fault_plan)
            if spec is not None:
                scripted = scripted.resolve(spec)
            plan = FaultPlan(plan.events + tuple(e for e in scripted.events
                                                 if e.step >= ts.step))
        live_meta = {"epoch": regroup.epoch, "crash_step": ts.step,
                     "dead_replicas": list(regroup.dead_replicas),
                     "rejoin": regroup.rejoin, "resumed_from": resumed_from,
                     "watchdog_s": health.cfg.watchdog_s if health is not None else None}
        say(f"[train] regroup epoch {regroup.epoch}: resumed {resumed_from} at step "
            f"{ts.step}, replaying {len(plan.events)} event(s) for dead replicas "
            f"{list(regroup.dead_replicas)}" + (" with elastic rejoin" if regroup.rejoin
                                                else ""))
    else:
        plan = FaultPlan.from_json(args.fault_plan)
        if spec is not None:
            plan = plan.resolve(spec)  # topology-node events -> replicas
        if args.resume:
            ts = load_train_state(args.resume, device=device, expect_overlap="off",
                                  fallback=True, placement=placement)
    start_step, carry, membership, prior_losses = 0, None, None, []
    if ts is not None:
        if ts.strategy != args.strategy:
            raise SystemExit(f"train: checkpoint was written by strategy "
                             f"{ts.strategy!r}, run requests {args.strategy!r}")
        start_step, membership, prior_losses = ts.step, ts.membership, list(ts.losses)
        like = strategy.init_carry(tree_map(lambda x: x.to("meta"), params0))
        if placement is not None:
            like = placement.put_carry(like)
        carry = fit_tree(like, ts.carry, "carry/", what="this run's carry")
        if ts.controller is not None and strategy.controller is not None:
            strategy.controller.load_state_dict(ts.controller)
        del ts
        if regroup is None:
            say(f"[train] resumed from {args.resume} at step {start_step}")

    ckpt_cb = None
    if args.ckpt_every:
        def ckpt_cb(step, cur_carry, seg_losses):
            save_placed_train_state(placement, ckpt_step_dir(args.ckpt, step), TrainState(
                step=step, carry=cur_carry, controller=strategy.controller.state_dict(),
                membership=(list(strategy.membership)
                            if strategy.membership is not None else None),
                strategy=args.strategy, losses=prior_losses + list(seg_losses)))

    if tracer is not None and strategy.controller is not None:
        strategy.controller.tracer = tracer
    if health is not None:
        health.phase("train")
    executor = MacroCycleExecutor(strategy, max_cycle_len=args.max_cycle_len,
                                  placement=placement, health=health)
    report = run_with_faults(strategy, params0, data_fn, lr_fn, args.steps, plan,
                             executor=executor, ckpt_every=args.ckpt_every,
                             ckpt_cb=ckpt_cb, start_step=start_step, carry=carry,
                             membership=membership, tracer=tracer)
    del carry
    if prior_losses:
        report.result.losses = prior_losses + report.result.losses
    say(f"[train] fault plan: {len(plan.events)} events, "
        f"{report.invalidations} cycle-cache invalidations, "
        f"simulated_time={report.simulated_time_s:.2f}s")
    for ev in report.applied:
        say(f"[train]   step {ev['step']:>5} {ev['kind']:<12} "
            f"replica={ev.get('replica')} "
            f"handle={ev['handle_s'] * 1e3:.1f}ms "
            f"first_cycle={ev['first_cycle_s'] * 1e3:.1f}ms")
    return report, live_meta


def start_distributed(args):
    """The --distributed preamble, before the process group comes up:
    the identity, the supervised health monitor (started first, so even a
    wedged start is watchdog-bounded), this process's trace stream, and the
    refusals that must not wait for the group (a dispatch or a process
    count the run cannot take). Then joins the group. Returns (config,
    HealthConfig or None, HealthMonitor or None, Tracer or None)."""
    if not args.topology:
        raise SystemExit("train: --distributed places the replica axis of "
                         "--topology; give one")
    cfg = dist_rt.DistributedConfig.from_env(
        coordinator=args.coordinator, num_processes=args.procs,
        process_id=args.proc_id, dispatch=args.dispatch)
    live_cfg = live.HealthConfig.from_env()  # None unless supervised
    tracer = None
    if args.trace_out:
        # one stream per (epoch, proc); the process launcher merges them
        tracer = Tracer(stream_path(args.trace_out, cfg.process_id,
                                    live_cfg.epoch if live_cfg is not None else 0),
                        proc_id=cfg.process_id)
    health = None
    if live_cfg is not None:
        if args.executor != "macro":
            raise SystemExit("train: supervised runs (DASO_RUN_DIR set) report "
                             "progress from the macro executor; drop --executor "
                             "per_step")
        health = live.HealthMonitor(live_cfg, proc_id=cfg.process_id,
                                    tracer=tracer).start()
        health.phase("init")
    if cfg.dispatch == "overlap" and args.overlap == "off":
        # before the group comes up: only the overlap cycle's discipline
        # (one collective in flight) makes the helper-thread gather safe
        raise SystemExit("train: --dispatch overlap requires --overlap one_cycle: "
                         "it runs the overlap exchange's gather beside the cycle's "
                         "local steps, and the blocking schedule has no such "
                         "exchange. Use --dispatch serial (the default).")
    spec = TopologySpec.load(args.topology)
    try:
        validate_process_topology(spec, cfg.num_processes)
        if cfg.dispatch == "overlap":
            dist_rt.check_overlap_topology(spec, cfg.num_processes)
    except ValueError as e:
        raise SystemExit(f"train: {e}")
    dist_rt.initialize(cfg)
    return cfg, live_cfg, health, tracer


def write_proc_report(path, proc, placement, result, device, wall_s):
    """--proc-report: this process's PATH.p{proc}.json."""
    stats = result.executor_stats
    rep = {"proc": proc, "device": str(device), "wall_s": wall_s,
           "modes": ([h[1] for h in result.controller.history]
                     if result.controller is not None else None),
           "placement": placement.report() if placement is not None else None,
           "launches": launch_counts(),
           "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                    if device.type == "cuda" else None),
           "executor_stats": dataclasses.asdict(stats) if stats is not None else None,
           "cycles": [[[list(t) for t in shape], sec] for shape, sec in result.cycles],
           "carry_digest": dist_rt.row_digests(result.carry, placement),
           "params_digest": [dist_rt.fingerprint(x) for x in leaves(result.params)]}
    out = f"{path}.p{proc}.json"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(rep, f)


def main(argv=None):
    t_start = time.perf_counter()
    args = parse_args(argv)
    say = print
    dist_cfg = live_cfg = health = tracer = None
    if args.distributed:
        dist_cfg, live_cfg, health, tracer = start_distributed(args)
        if args.device == "cuda" and torch.cuda.is_available():
            args.device = f"cuda:{dist_cfg.process_id % torch.cuda.device_count()}"
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    proc = dist_cfg.process_id if dist_cfg is not None else 0
    if dist_cfg is not None:
        if proc != 0:
            if args.metrics_out:
                print(f"[train][proc {proc}] --metrics-out is written by process 0 "
                      f"only; this process drops {args.metrics_out}")
            say = lambda *a, **k: None  # one process speaks for the group
            args.metrics_out = None
        say(f"[train] distributed: process {proc}/{dist_cfg.num_processes} "
            f"(gloo, dispatch={dist_cfg.dispatch}, device={device})")
    cfg = build_config(args)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params0 = init_params(cfg, gen, device)
    src = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq_len, seed=args.seed)
    spec = None
    if args.topology:
        if args.strategy not in ("daso", "hier_daso", "gossip", "easgd", "downpour"):
            raise SystemExit("train: --topology drives the replica-axis strategies "
                             "(daso / hier_daso / gossip / easgd / downpour)")
        spec = TopologySpec.load(args.topology)
        args.nodes, args.local_world = spec.n_replicas, spec.local_world
        # a %period on the outermost level overrides --b-max, as the
        # lowering does, so the line names the schedule that runs
        b_eff = spec.outer.period if spec.outer.period is not None else args.b_max
        say(f"[train] topology: {spec.to_str()} -> R={spec.n_replicas} "
            f"world={spec.world} inner_periods="
            f"{derive_inner_periods(spec, b_max=b_eff)}")
    R, per = args.nodes, args.per_node_batch

    def daso_data(step):
        b = src.batch(R * per, step, device=device)
        return {k: v.reshape((R, per) + v.shape[1:]) for k, v in b.items()}

    def sync_data(step):
        return src.batch(R * per, step, device=device)

    loop_cfg = TrainLoopConfig(
        strategy=args.strategy, n_steps=args.steps, n_replicas=R,
        local_world=args.local_world, b_max=args.b_max, lr=args.lr,
        # the canonical string of the spec parsed above, so the run trains
        # on the topology R and the data were sized from
        topology=spec.to_str() if spec is not None else None,
        executor=args.executor, max_cycle_len=args.max_cycle_len,
        wire_format=args.wire_format, overlap=args.overlap,
        overlap_serial_exchange=args.overlap_serial_exchange,
        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt, resume_from=args.resume,
        device=str(device), distributed=args.distributed)
    lr_fn = warmup_linear_scaled(args.lr / (R * args.local_world), R * args.local_world,
                                 max(1, args.steps // 10))
    if args.trace_out and tracer is None:
        tracer = Tracer(stream_path(args.trace_out, 0), proc_id=0)
    if tracer is not None:
        # what tools/trace_report.py needs to price the model side of its
        # drift table, in the reference launcher's keys
        tracer.metadata(
            arch=args.arch, strategy=args.strategy, steps=args.steps,
            topology=spec.to_str() if spec is not None else None,
            n_replicas=R, local_world=args.local_world,
            b_max=(spec.outer.period if spec is not None and spec.outer.period is not None
                   else args.b_max),
            wire_format=args.wire_format, exchange_impl="fused", overlap=args.overlap,
            param_bytes=sum(x.numel() * x.element_size() for x in leaves(params0)),
            procs=dist_cfg.num_processes if dist_cfg is not None else 1,
            seed=args.seed, tiny=bool(args.tiny))
    # a supervised regroup epoch (the launcher relaunched this process after a
    # real process death) becomes a fault-plan run
    regroup = None
    if live_cfg is not None and live_cfg.regroup_file:
        regroup = live.load_regroup(live_cfg.regroup_file)
        if not args.ckpt:
            raise SystemExit("train: a regrouped epoch resumes from --ckpt; the "
                             "supervisor must pass --ckpt DIR --ckpt-every N")
    report = live_meta = None
    try:
        if args.fault_plan or regroup is not None:
            report, live_meta = run_fault_plan(
                args, make_lm_loss(cfg), params0, daso_data, loop_cfg, lr_fn, spec,
                tracer, device, regroup=regroup, health=health, say=say)
            result = report.result
        else:
            if health is not None:
                health.phase("train")
            result = run_training(make_lm_loss(cfg), params0,
                                  sync_data if args.strategy == "sync" else daso_data,
                                  loop_cfg, lr_fn=lr_fn, log=say, tracer=tracer,
                                  health=health)
    except dist_rt.PeerLostError as e:
        # a peer died under a collective: the supervisor's regroup signal
        print(f"[train][proc {proc}] {e}", file=sys.stderr, flush=True)
        os._exit(live.EXIT_PEER_LOST)
    if health is not None:
        health.phase("finalize")
    stats = result.executor_stats
    if stats is not None:
        say(f"[train] executor: {stats.dispatches} host dispatches for "
            f"{args.steps} steps ({stats.compiles} compiled cycle shapes, "
            f"{stats.fallback_steps} tail-fallback steps, "
            f"{stats.invalidations} invalidations)")
    comm_rows = None
    if tracer is not None and result.controller is not None:
        # per-level comm accounting over the whole run, in the trace (a
        # counter event) and in the metrics JSON
        ctrl = result.controller
        comm_rows = meters.level_bytes_report(
            params0, ctrl.level_sync_counts(), ctrl.cfg, topo=spec,
            outer_split=meters.outer_sync_split(ctrl.history))
        tracer.counter("comm_meters", meters.rows_as_counter(comm_rows))
    if args.ckpt and proc == 0:
        save_checkpoint(args.ckpt, result.params, step=args.steps)
        say(f"[train] checkpoint -> {args.ckpt}")
    if args.metrics_out:
        os.makedirs(os.path.dirname(args.metrics_out) or ".", exist_ok=True)
        metrics = {"losses": result.losses, "sync_fraction": result.sync_fraction,
                   "final_loss": result.final_loss, "seed": args.seed,
                   "device": str(device)}
        if stats is not None:
            metrics["executor_stats"] = dataclasses.asdict(stats)
        if report is not None:
            metrics["resilience"] = {
                "events": report.applied, "invalidations": report.invalidations,
                "simulated_time_s": report.simulated_time_s,
                "retunes": report.retunes, "reshuffles": report.reshuffles,
                "wasted_wait_s": report.wasted_wait_s}
            if live_meta is not None:
                metrics["resilience"]["live"] = live_meta
        if comm_rows is not None:
            metrics["comm_meters"] = [{**dataclasses.asdict(r), "total_bytes": r.total_bytes}
                                      for r in comm_rows]
        with open(args.metrics_out, "w") as f:
            json.dump(metrics, f)
        print(f"[train] metrics -> {args.metrics_out}")
    if args.proc_report:
        write_proc_report(args.proc_report, proc, result.placement, result, device,
                          time.perf_counter() - t_start)
    if health is not None:
        health.close()
    if tracer is not None:
        tracer.close()
        if dist_cfg is None:
            # one process: merge its own stream, so --trace-out names a ready
            # run trace (the process launcher merges a group's streams)
            merge_streams(args.trace_out, log=print)
        say(f"[train] trace events={tracer.n_events} "
            f"overhead={tracer.overhead_s * 1e3:.1f}ms -> {args.trace_out}")
    return result


if __name__ == "__main__":
    main()
