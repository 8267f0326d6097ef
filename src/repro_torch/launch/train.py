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

Either package loads the other's checkpoints (`checkpoint/io.py`), and
reads the other's traces. The reference's other flags (the per-leaf
exchange, autotune, the multi-process runtime) are not ported yet: each is
refused with the ROADMAP item that will port it. So a trace here is one
process's stream: the merge of several processes' streams
(tools/launch_procs.py), the health monitor's `phase` instants and the
regroup replay of a real process death wait for item 16.
"""
import argparse
import dataclasses
import json
import os
import sys

import torch

from repro_torch.checkpoint.io import (TrainState, fit_tree, load_train_state,
                                       save_checkpoint, save_train_state)
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import MAMBA, RGLRU
from repro_torch.core.executor import MacroCycleExecutor, list_strategies
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models.lm import init_params
from repro_torch.obs import meters
from repro_torch.obs.trace import Tracer, merge_streams, stream_path
from repro_torch.optim.optimizers import sgd
from repro_torch.optim.schedules import warmup_linear_scaled
from repro_torch.resilience import FaultPlan, run_with_faults
from repro_torch.topo import TopologySpec, derive_inner_periods
from repro_torch.train.loop import (TrainLoopConfig, build_strategy, ckpt_step_dir,
                                    run_training)
from repro_torch.train.step import make_lm_loss
from repro_torch.tree import leaves, tree_map

# flags of the reference launcher that wait for a later part of the port,
# with the ROADMAP item that ports them
LATER_FLAGS = {
    "--exchange-impl": 7, "--dispatch": 16, "--autotune": 18, "--autotune-every": 18, "--distributed": 16,
    "--coordinator": 16, "--procs": 16, "--proc-id": 16,
}


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
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
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
    return cfg


def run_fault_plan(args, loss_fn, params0, data_fn, loop_cfg, lr_fn, spec, tracer,
                   device):
    """`--fault-plan`: the plan (its topology-node events resolved against
    `spec`) replayed by `resilience.run_with_faults` on the macro executor,
    with `--resume` and `--ckpt-every` (the TrainState keeps the membership
    mask). Returns the ResilienceReport, its losses the whole run's."""
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
    plan = FaultPlan.from_json(args.fault_plan)
    if spec is not None:
        plan = plan.resolve(spec)  # topology-node events -> replicas
    strategy = build_strategy(loss_fn, loop_cfg, sgd(momentum=0.9, weight_decay=1e-4))
    start_step, carry, membership, prior_losses = 0, None, None, []
    if args.resume:
        ts = load_train_state(args.resume, device=device, expect_overlap="off",
                              fallback=True)
        if ts.strategy != args.strategy:
            raise SystemExit(f"train: checkpoint was written by strategy "
                             f"{ts.strategy!r}, run requests {args.strategy!r}")
        start_step, membership, prior_losses = ts.step, ts.membership, list(ts.losses)
        like = strategy.init_carry(tree_map(lambda x: x.to("meta"), params0))
        carry = fit_tree(like, ts.carry, "carry/", what="this run's carry")
        if ts.controller is not None and strategy.controller is not None:
            strategy.controller.load_state_dict(ts.controller)
        del ts
        print(f"[train] resumed from {args.resume} at step {start_step}")

    ckpt_cb = None
    if args.ckpt_every:
        def ckpt_cb(step, cur_carry, seg_losses):
            save_train_state(ckpt_step_dir(args.ckpt, step), TrainState(
                step=step, carry=cur_carry, controller=strategy.controller.state_dict(),
                membership=(list(strategy.membership)
                            if strategy.membership is not None else None),
                strategy=args.strategy, losses=prior_losses + list(seg_losses)))

    if tracer is not None and strategy.controller is not None:
        strategy.controller.tracer = tracer
    executor = MacroCycleExecutor(strategy, max_cycle_len=args.max_cycle_len)
    report = run_with_faults(strategy, params0, data_fn, lr_fn, args.steps, plan,
                             executor=executor, ckpt_every=args.ckpt_every,
                             ckpt_cb=ckpt_cb, start_step=start_step, carry=carry,
                             membership=membership, tracer=tracer)
    del carry
    if prior_losses:
        report.result.losses = prior_losses + report.result.losses
    print(f"[train] fault plan: {len(plan.events)} events, "
          f"{report.invalidations} cycle-cache invalidations, "
          f"simulated_time={report.simulated_time_s:.2f}s")
    for ev in report.applied:
        print(f"[train]   step {ev['step']:>5} {ev['kind']:<12} "
              f"replica={ev.get('replica')} "
              f"handle={ev['handle_s'] * 1e3:.1f}ms "
              f"first_cycle={ev['first_cycle_s'] * 1e3:.1f}ms")
    return report


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
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
        print(f"[train] topology: {spec.to_str()} -> R={spec.n_replicas} "
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
        device=str(device))
    lr_fn = warmup_linear_scaled(args.lr / (R * args.local_world), R * args.local_world,
                                 max(1, args.steps // 10))
    tracer = None
    if args.trace_out:
        tracer = Tracer(stream_path(args.trace_out, 0), proc_id=0)
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
            procs=1, seed=args.seed, tiny=bool(args.tiny))
    report = None
    if args.fault_plan:
        report = run_fault_plan(args, make_lm_loss(cfg), params0, daso_data, loop_cfg,
                                lr_fn, spec, tracer, device)
        result = report.result
    else:
        result = run_training(make_lm_loss(cfg), params0,
                              sync_data if args.strategy == "sync" else daso_data,
                              loop_cfg, lr_fn=lr_fn, tracer=tracer)
    stats = result.executor_stats
    if stats is not None:
        print(f"[train] executor: {stats.dispatches} host dispatches for "
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
    if args.ckpt:
        save_checkpoint(args.ckpt, result.params, step=args.steps)
        print(f"[train] checkpoint -> {args.ckpt}")
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
        if comm_rows is not None:
            metrics["comm_meters"] = [{**dataclasses.asdict(r), "total_bytes": r.total_bytes}
                                      for r in comm_rows]
        with open(args.metrics_out, "w") as f:
            json.dump(metrics, f)
        print(f"[train] metrics -> {args.metrics_out}")
    if tracer is not None:
        tracer.close()
        # one process: merge its own stream, so --trace-out names a ready
        # run trace
        merge_streams(args.trace_out, log=print)
        print(f"[train] trace events={tracer.n_events} "
              f"overhead={tracer.overhead_s * 1e3:.1f}ms -> {args.trace_out}")
    return result


if __name__ == "__main__":
    main()
