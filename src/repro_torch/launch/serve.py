"""Serving launcher of the port: batched generation from seeded parameters.

  python -m repro_torch.launch.serve --full --batch 4 --prompt-len 1024 \
      --max-new 32 [--temperature 0.8] [--device cpu]
  python -m repro_torch.launch.serve --arch falcon-mamba-7b --full --batch 4 \
      --prompt-len 1024 --max-new 32
  python -m repro_torch.launch.serve --arch recurrentgemma-9b --full --batch 4 \
      --prompt-len 1024 --max-new 32

  # trained parameters, from either package's checkpoint (a launcher's
  # --ckpt DIR); they must fit the --arch / --full config
  python -m repro_torch.launch.serve --ckpt DIR --device cpu

Runs on CUDA unless --device cpu is given. Without --full it serves the
reduced config. Without --ckpt the weights are random, drawn from --seed;
the prompts are drawn from --seed either way.
"""
import argparse
import time

import torch

from repro_torch.checkpoint.io import fit_tree, load_checkpoint
from repro_torch.configs import ARCH_IDS, get_config, get_reduced, require_lm
from repro_torch.models.lm import init_params
from repro_torch.serve.engine import Engine, resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ckpt", default=None,
                    help="a params checkpoint directory (either package's)")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    require_lm(args.arch, "serve")
    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_reduced(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.ckpt:
        loaded, manifest = load_checkpoint(args.ckpt, device=device)
        params = fit_tree(init_params(cfg, torch.Generator(), "meta"), loaded,
                          what="the config")
        print(f"[serve] restored checkpoint step={manifest['step']}")
    else:
        params = init_params(cfg, gen, device)
    eng = Engine(cfg, params, max_len=args.prompt_len + args.max_new,
                 device=device)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = eng.generate(prompts, args.max_new, temperature=args.temperature,
                       generator=gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = out.shape[0] * out.shape[1]
    print(f"[serve] {args.arch} on {device}: {tuple(out.shape)} tokens in "
          f"{dt:.3f}s ({toks / dt:.1f} tok/s)")
    for row in out[: min(4, args.batch)].tolist():
        print("  ", row[:16], "...")
    return out


if __name__ == "__main__":
    main()
