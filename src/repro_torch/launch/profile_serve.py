"""Where the serving path's time goes: one prefill and a few decode steps,
each timed once plain and once under torch.profiler. Reports device time
by kernel and the device-busy share: the profiled device time (one
stream, so kernel times add up without overlap) over the plain run's wall
time, since the profiler's own host cost lengthens the profiled one.

  python -m repro_torch.launch.profile_serve --full \
      [--arch falcon-mamba-7b | recurrentgemma-9b] \
      [--batch 4] [--prompt-len 1024] [--decode-steps 8] [--trace out.json]

Runs on CUDA unless --device cpu is given (then only host times exist and
the device numbers read "not measured").
"""
import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ARCH_IDS, get_config, get_reduced, require_lm
from repro_torch.models.lm import init_params
from repro_torch.serve.engine import make_decode_fn, make_prefill_fn, resolve_device


def _device_us(event) -> float:
    # the attribute was renamed from self_cuda_time_total across versions
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def _timed(fn, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return 1e3 * (time.perf_counter() - t0)


def profile_phase(name, fn, device, top, trace=None):
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    wall_ms = _timed(fn, device)
    with profile(activities=activities) as prof:
        profiled_wall_ms = _timed(fn, device)
    if trace:
        prof.export_chrome_trace(trace)
    # device-side events only (kernels, copies): the operators that launch
    # them report the same device time again
    averages = prof.key_averages()
    events = [e for e in averages if e.device_type == DeviceType.CUDA]
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    events.sort(key=_device_us, reverse=True)
    # the host's CUDA runtime calls: launches, and the caching allocator's
    # cudaMalloc / cudaFree and the waits they bring
    runtime = sorted((e for e in averages if e.device_type == DeviceType.CPU
                      and e.key.startswith("cuda")),
                     key=lambda e: e.cpu_time_total, reverse=True)
    return {"phase": name, "wall_ms": wall_ms, "profiled_wall_ms": profiled_wall_ms,
            "device_busy_ms": busy_ms if device.type == "cuda" else "not measured",
            "device_busy_share": busy_ms / wall_ms if device.type == "cuda"
            else "not measured",
            "top": [{"name": e.key[:120], "calls": e.count,
                     "device_ms": _device_us(e) / 1e3} for e in events[:top]],
            "runtime_top": [{"name": e.key, "calls": e.count,
                             "host_ms": e.cpu_time_total / 1e3} for e in runtime[:5]]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCH_IDS)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None,
                    help="write the decode phase's Chrome trace here")
    args = ap.parse_args(argv)

    require_lm(args.arch, "profile_serve")
    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_reduced(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device)
    prefill = make_prefill_fn(cfg, cache_len=args.prompt_len + args.decode_steps + 2)
    decode = make_decode_fn(cfg)
    state = {}

    def run_prefill():
        state["st"] = prefill(params, prompts)

    def run_decode():
        cache = state["st"]["cache"]
        nxt = state["st"]["logits_last"].argmax(-1, keepdim=True)
        for i in range(args.decode_steps):
            out = decode(params, cache, nxt, args.prompt_len + i)
            nxt = out["logits"].argmax(-1, keepdim=True)

    rows = []
    with torch.inference_mode():
        run_prefill()  # warm-up: kernel build and load, library handles
        run_decode()
        rows.append(profile_phase("prefill", run_prefill, device, args.top))
        rows.append(profile_phase("decode", run_decode, device, args.top, args.trace))
    for row in rows:
        row.update(arch=args.arch, full=args.full, batch=args.batch,
                   prompt=args.prompt_len, device=str(device))
        if row["phase"] == "decode":
            row["decode_steps"] = args.decode_steps
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
