"""Ablation of the paper's knobs, the twin of
`examples/daso_schedule_ablation.py` and the port's entry point for the CNN
(the LM launcher trains decoder LMs only):
  * B (max batches between global syncs) on a tiny LM: a larger B means less
    global traffic but a larger effective batch and more staleness
  * the Eq. (1) staleness-weighted merge against naive periodic averaging
    (local_sgd) on a tiny ResNet
  * iid against non-iid node data (the paper's core assumption)
  * the macro-cycle executor against the per-step path: the same loss
    trace with far fewer host dispatches

All runs go through the strategy registry
(`repro_torch.core.executor.list_strategies()`). On CUDA the run is in
strict f32 with deterministic cuDNN (TF32 off for cuBLAS and cuDNN), so the
two executors' loss traces agree bit for bit on the card too.

  PYTHONPATH=src python -m repro_torch.launch.ablation [--device cpu] [--steps N]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.configs.resnet50 import ResNetConfig
from repro_torch.core.executor import list_strategies
from repro_torch.data.synthetic import (SyntheticImages, SyntheticLM,
                                        make_noniid_class_partition)
from repro_torch.device import resolve_device, strict_f32
from repro_torch.models.cnn import init_resnet
from repro_torch.models.lm import init_params
from repro_torch.train.loop import TrainLoopConfig, run_training
from repro_torch.train.step import make_lm_loss, make_resnet_loss
from repro_torch.tree import tree_map

# the reference's step counts (its `run` and `run_lm` defaults)
CNN_STEPS, LM_STEPS = 120, 150


def make_problem(n_nodes, device, noniid=False, per_node_batch=8):
    """(params0, loss_fn, data_fn) of the tiny ResNet run: R = n_nodes
    replicas of `per_node_batch` images each, every replica with the same
    initial batch-norm statistics (a stride-0 expand over the replica
    axis)."""
    cfg = ResNetConfig(name="resnet-tiny", stage_sizes=(1, 1), width=8,
                       bottleneck=False, n_classes=4, image_size=16)
    src = SyntheticImages(n_classes=4, image_size=16, seed=0)
    params, state = init_resnet(cfg, torch.Generator(device=device).manual_seed(0), device)
    loss_fn = make_resnet_loss(cfg)
    weights = (make_noniid_class_partition(4, n_nodes, alpha=0.2, seed=0)
               if noniid else None)
    bn_state = tree_map(lambda x: x.expand((n_nodes,) + x.shape), state)

    def data(step):
        outs = []
        for r in range(n_nodes):
            w = None if weights is None else weights[r]
            outs.append(src.batch(per_node_batch, step * n_nodes + r,
                                  class_weights=w, device=device))
        batch = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        batch["bn_state"] = bn_state
        return batch

    return {"net": params}, loss_fn, data


def run(tag, strategy, n_nodes, b_max, device, noniid=False, steps=CNN_STEPS,
        executor="macro"):
    if strategy not in list_strategies():
        raise ValueError(f"unknown strategy {strategy!r}; registered: {list_strategies()}")
    params0, loss_fn, data = make_problem(n_nodes, device, noniid=noniid)
    res = run_training(loss_fn, params0, data, TrainLoopConfig(
        strategy=strategy, n_steps=steps, n_replicas=n_nodes, local_world=4,
        b_max=b_max, lr=0.05, loss_window=10, executor=executor,
        device=str(device)), log=None)
    acc = np.mean([m.get("acc", 0.0) for m in res.metrics[-12:]])
    stats = res.executor_stats
    disp = f" dispatches={stats.dispatches}/{steps}" if stats else ""
    print(f"{tag:40s} final_loss={res.final_loss:.4f} acc={acc:.3f} "
          f"sync_frac={res.sync_fraction:.2f}{disp}")
    return res


def run_lm(tag, b_max, device, n_nodes=4, steps=LM_STEPS):
    """B sweep on the (harder, non-saturating) LM task."""
    cfg = get_reduced("llama3.2-1b").replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=256)
    params0 = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    loss_fn = make_lm_loss(cfg)
    src = SyntheticLM(vocab_size=256, seq_len=64, seed=0)
    per = 8

    def data(step):
        b = src.batch(n_nodes * per, step, device=device)
        return {k: v.reshape((n_nodes, per) + v.shape[1:]) for k, v in b.items()}

    res = run_training(loss_fn, params0, data, TrainLoopConfig(
        strategy="daso", n_steps=steps, n_replicas=n_nodes, local_world=4,
        b_max=b_max, lr=0.05, loss_window=15, device=str(device)), log=None)
    print(f"{tag:40s} final_loss={res.final_loss:.4f} "
          f"sync_frac={res.sync_fraction:.2f}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=None,
                    help=f"steps of every run (default: {CNN_STEPS} for the ResNet "
                         f"runs, {LM_STEPS} for the LM sweep, as the reference)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    strict_f32(device)
    steps = {} if args.steps is None else {"steps": args.steps}
    print("== B sweep on tiny LM (larger B = bigger effective batch / more "
          "staleness, paper Fig 7 mechanism) ==")
    for b in (1, 4, 8, 16):
        run_lm(f"daso B={b}", b_max=b, device=device, **steps)
    print("\n== Eq.(1) staleness weighting vs naive periodic averaging ==")
    run("daso (Eq.1 weighted merge)", "daso", 4, 4, device, **steps)
    run("local_sgd (naive overwrite)", "local_sgd", 4, 4, device, **steps)
    print("\n== iid assumption (paper: non-iid breaks all DP schemes) ==")
    run("daso iid nodes", "daso", 4, 4, device, noniid=False, **steps)
    run("daso NON-iid nodes", "daso", 4, 4, device, noniid=True, **steps)
    print("\n== macro-cycle executor vs per-step reference (same numerics, "
          "fewer host dispatches) ==")
    a = run("daso macro-cycle executor", "daso", 4, 4, device, **steps)
    b = run("daso per-step reference", "daso", 4, 4, device, executor="per_step", **steps)
    drift = float(np.max(np.abs(np.asarray(a.losses) - np.asarray(b.losses))))
    print(f"{'max |loss trace drift|':40s} {drift:.2e} (expect 0: the same "
          "step functions)")
    return {"macro": a, "per_step": b, "drift": drift}


if __name__ == "__main__":
    main()
