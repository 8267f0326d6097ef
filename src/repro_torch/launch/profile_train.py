"""Where a DASO training step's time goes, mode by mode: llama3.2-1b at
its published widths (`--layers` of its 16, f32), R = 4 replicas of 2 x 256
tokens, sgd(0.9, 1e-4) — the train phase of chip_smoke.py. One step of
each mode (local, send, receive, blocking) from the same carry, then with
the int8 wire tier and the overlap schedule (the train_int8_overlap phase)
an ov_sync~3 step (B = 4, W = 1) and an int8 blocking step; each timed
once plain and once under torch.profiler: device time by kernel and the
device-busy share (see `profile_serve.profile_phase`).

  python -m repro_torch.launch.profile_train [--layers 4] [--trace out.json]

Runs on CUDA unless --device cpu is given (then only host times exist and
the device numbers read "not measured").
"""
import argparse
import json

import torch

from repro_torch.configs import get_config
from repro_torch.core.daso import DasoConfig
from repro_torch.core.executor import DasoStrategy
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.profile_serve import profile_phase
from repro_torch.models.lm import init_params
from repro_torch.optim.optimizers import sgd
from repro_torch.train.step import make_lm_loss
from repro_torch.tree import leaves

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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None,
                    help="write the receive step's Chrome trace here")
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
    return rows


if __name__ == "__main__":
    main()
