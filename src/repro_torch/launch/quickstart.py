"""Quickstart of the port, the twin of `examples/quickstart.py`: train a
tiny llama3.2-1b-family LM with DASO and with the synchronous
(Horovod-analog) baseline on the same data, and compare: the paper's claim
of equal quality with far less global communication.

  PYTHONPATH=src python -m repro_torch.launch.quickstart --device cuda
"""
import argparse

import torch

from repro_torch.configs import get_reduced
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models.lm import init_params
from repro_torch.train.loop import TrainLoopConfig, run_training
from repro_torch.train.step import make_lm_loss


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_reduced("llama3.2-1b").replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=256)
    params0 = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    loss_fn = make_lm_loss(cfg)
    src = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=64, seed=0)

    R, per = 4, 8  # 4 virtual "nodes", 8 sequences each

    def daso_data(step):
        b = src.batch(R * per, step, device=device)
        return {k: v.reshape((R, per) + v.shape[1:]) for k, v in b.items()}

    def sync_data(step):
        return src.batch(R * per, step, device=device)

    sync = run_training(loss_fn, params0, sync_data, TrainLoopConfig(
        strategy="sync", n_steps=args.steps, lr=0.05, device=str(device)))
    daso = run_training(loss_fn, params0, daso_data, TrainLoopConfig(
        strategy="daso", n_steps=args.steps, n_replicas=R, local_world=4,
        b_max=4, lr=0.05, device=str(device)))

    print(f"\nsync  final loss: {sync.final_loss:.4f} "
          f"(global sync every step)")
    print(f"DASO  final loss: {daso.final_loss:.4f} "
          f"(global network touched on {daso.sync_fraction:.0%} of steps)")
    gap = abs(daso.final_loss - sync.final_loss) / sync.final_loss
    print(f"relative quality gap: {gap:.2%}  "
          f"<- paper claim: parity with far less global traffic")
    return sync, daso


if __name__ == "__main__":
    main()
