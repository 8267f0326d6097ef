"""Where a DASO training step's time goes, mode by mode: llama3.2-1b at
its published widths (`--layers` of its 16, f32), R = 4 replicas of 2 x 256
tokens, sgd(0.9, 1e-4) — the train phase of chip_smoke.py. One step of
each mode (local, send, receive, blocking) from the same carry, then with
the int8 wire tier and the overlap schedule (the train_int8_overlap phase)
an ov_sync~3 step (B = 4, W = 1) and an int8 blocking step; then the
cycle (local, local, local, ov_sync~3) through the macro-cycle executor,
its exchange on the executor's own CUDA stream, and again with
serial_exchange, with the executor's timing legs per cycle. Each timed
once plain and once under torch.profiler: device time by kernel and the
device-busy share (see `profile_serve.profile_phase`; under the overlap
the two streams' kernels may run at once, so the busy share can pass 1).
The cycle rows also read the profiled cycle's trace by CUDA stream
(`stream_overlap`): each stream's kernel time, and the time the exchange
stream's kernels ran while the main stream's ran, which is the most the
stream can have hidden on the card.

  python -m repro_torch.launch.profile_train [--layers 4] [--trace out.json]

Runs on CUDA unless --device cpu is given (then only host times exist and
the device numbers read "not measured").
"""
import argparse
import json
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.core.daso import DasoConfig
from repro_torch.core.executor import OVERLAP_COMPUTE_PREFIX, CyclePlan, DasoStrategy, \
    MacroCycleExecutor
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.profile_serve import profile_phase
from repro_torch.models.lm import init_params
from repro_torch.optim.optimizers import sgd
from repro_torch.train.step import make_lm_loss
from repro_torch.tree import leaves, tree_map

REPLICAS, LOCAL_WORLD, PER, SEQ, LR = 4, 4, 2, 256, 0.005
PEAK_F32_FLOPS, PEAK_BYTES = 67e12, 3.35e12  # H100 SXM, CUDA cores / HBM3


def step_counts(cfg, n_params: int) -> dict:
    """What one local step must do, from the shapes: the GEMM operations of
    forward and backward (3x forward) over all replicas, with the plain
    attention's full S x S scores; and the bytes one fused SGD pass would
    move (read grad, param, momentum; write param, momentum: 20 B each)."""
    D, hd = cfg.d_model, cfg.head_dim
    per_layer = (D * cfg.n_heads * hd * 2 + D * cfg.n_kv_heads * hd * 2
                 + 3 * D * cfg.d_ff)
    tokens = PER * SEQ
    fwd = 2 * tokens * (per_layer * cfg.n_layers + cfg.vocab_size * D)
    fwd += cfg.n_layers * 4 * PER * cfg.n_heads * SEQ * SEQ * hd
    flops = 3 * fwd * REPLICAS
    sgd_bytes = 20 * n_params * REPLICAS
    return {"gemm_flops": flops, "gemm_bound_ms": 1e3 * flops / PEAK_F32_FLOPS,
            "sgd_fused_bytes": sgd_bytes,
            "sgd_fused_bound_ms": 1e3 * sgd_bytes / PEAK_BYTES}


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def stream_overlap(trace_path: str) -> dict:
    """Kernel time by CUDA stream in a Chrome trace of one cycle: the main
    stream (the one with the most kernels) and the others (the exchange
    stream), each as the union of its kernels' spans, and the time both
    had a kernel running. Device time, ms; "not measured" without kernels."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    by_stream = {}
    for e in events:
        if e.get("cat") == "kernel":
            by_stream.setdefault(e["args"].get("stream"), []).append(
                (e["ts"], e["ts"] + e["dur"]))
    if not by_stream:
        return {"main_busy_ms": "not measured", "exchange_busy_ms": "not measured",
                "concurrent_ms": "not measured"}
    main = max(by_stream, key=lambda s: len(by_stream[s]))
    busy = _union(by_stream.pop(main))
    side = _union([iv for ivs in by_stream.values() for iv in ivs])
    both, i, j = 0.0, 0, 0
    while i < len(busy) and j < len(side):
        both += max(0.0, min(busy[i][1], side[j][1]) - max(busy[i][0], side[j][0]))
        if busy[i][1] < side[j][1]:
            i += 1
        else:
            j += 1
    return {"main_busy_ms": sum(b - a for a, b in busy) / 1e3,
            "exchange_busy_ms": sum(b - a for a, b in side) / 1e3,
            "concurrent_ms": both / 1e3}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None,
                    help="write the receive step's Chrome trace here, and the "
                         "overlap cycle's beside it (name.cycle.json)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config("llama3.2-1b").replace(n_layers=args.layers,
                                            param_dtype=torch.float32,
                                            compute_dtype=torch.float32)
    params0 = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    strategy = DasoStrategy(make_lm_loss(cfg), sgd(0.9, 1e-4), DasoConfig(
        n_replicas=REPLICAS, global_world=REPLICAS * LOCAL_WORLD))
    src = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=SEQ, seed=0)
    b = src.batch(REPLICAS * PER, 0, device=device)
    batch = {k: v.reshape((REPLICAS, PER) + v.shape[1:]) for k, v in b.items()}

    counts = step_counts(cfg, sum(x.numel() for x in leaves(params0)))
    rows = []

    def run(strategy, warmup, modes, wire):
        carry = strategy.init_carry(params0)
        for mode in warmup:
            carry, _ = strategy.step_fn(mode, 1)(carry, batch, LR)
        for mode in modes:
            step = strategy.step_fn(mode, 1)
            row = profile_phase(mode, lambda: step(carry, batch, LR), device, args.top,
                                args.trace if mode == "receive" else None)
            row.update(layers=args.layers, replicas=REPLICAS, wire=wire,
                       tokens_per_replica=PER * SEQ, device=str(device), **counts)
            print(json.dumps(row), flush=True)
            rows.append(row)

    # warm-up; leaves a send in flight
    run(strategy, ("blocking", "send", "local", "receive", "send"),
        ("local", "send", "receive", "blocking"), "f32 cycling / bf16 blocking")
    del strategy
    ov = DasoStrategy(make_lm_loss(cfg), sgd(0.9, 1e-4), DasoConfig(
        n_replicas=REPLICAS, global_world=REPLICAS * LOCAL_WORLD, wire_format="int8",
        overlap="one_cycle"))
    # warm-up; leaves a snapshot pending that differs from the params
    run(ov, ("blocking", "ov_start", "ov_sync~3", "local"), ("ov_sync~3", "blocking"),
        "int8")

    # the B = 4 overlap cycle through the macro executor, from the same carry
    shape = (("local", 1),) * 3 + (("ov_sync~3", 1),)
    plan = CyclePlan(0, shape)
    batches = tree_map(lambda x: torch.stack([x] * len(shape)), batch)
    lrs = torch.full((len(shape),), LR, dtype=torch.float32, device=device)
    # each cycle takes the carry and leaves its own, as in a run (a cycle
    # that kept its input alive would hold 3 x 8.1 GB more at this size)
    held = {"carry": ov.init_carry(params0)}
    for mode in ("blocking", "ov_start", "ov_sync~3", "local"):
        held["carry"], _ = ov.step_fn(mode, 1)(held["carry"], batch, LR)

    def cycle():
        held["carry"], _ = ex.run_cycle([held.pop("carry")], plan, batches, lrs)

    for serial in (False, True):
        ex = MacroCycleExecutor(ov, serial_exchange=serial)
        cycle()  # the exchange stream's first cycle
        ex.stats = type(ex.stats)()
        name = "ov_cycle" + ("_serial_exchange" if serial else "")
        with tempfile.TemporaryDirectory() as tmp:
            trace = (args.trace.removesuffix(".json") + ".cycle.json"
                     if args.trace and not serial else os.path.join(tmp, "cycle.json"))
            row = profile_phase(name, cycle, device, args.top, trace)
            streams = stream_overlap(trace)
        st = ex.stats
        row.update(shape=[m for m, _ in shape], layers=args.layers, replicas=REPLICAS,
                   wire="int8", device=str(device), **counts, streams=streams,
                   legs_ms_per_cycle={k[:-2]: 1e3 * getattr(st, k) / st.overlap_cycles for k in (
                       "overlap_compute_s", "overlap_exchange_visible_s",
                       "overlap_exchange_blocking_s", "overlap_merge_s", "overlap_wall_s")})
        assert st.overlap_cycles == 2 and all(
            m.startswith(OVERLAP_COMPUTE_PREFIX) for m, _ in ex.cached_shapes[0])
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
