#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (built for H100,
sm_90a). Run from the repository root:

  python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:
  build   compile every CUDA kernel of the serving path from
          src/repro_torch/csrc with nvcc (sm_90a), with ptxas's report
  check   hold each kernel against its plain PyTorch version on the card,
          at the serving shape and a sweep (dtypes, ragged lengths, head
          dims, window, q shorter than kv)
  serve   Engine.generate on llama3.2-1b at full size (16 layers, bf16,
          seeded random weights): batch 4, prompt 1024, 32 new greedy
          tokens. Kernel launches per prefill are counted; the prefill's
          last logits are held against a teacher-forced plain forward (bf16),
          and prefill + decode against it in f32 with 2 layers
  timing  each kernel, its plain version and the library call at the
          serving shape (CUDA events)
then the `kernels` line, the card's name and power limit, and as the last
line {"ok": true, "device": {...}}.

Exits non-zero without printing a result when no CUDA device is present.
"""
import json
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.ref import attention_ref  # noqa: E402
from repro_torch.models.lm import forward, init_params  # noqa: E402
from repro_torch.serve.engine import Engine, make_decode_fn, make_prefill_fn  # noqa: E402

ARCH = "llama3.2-1b"
BATCH, PROMPT, NEW = 4, 1024, 32
# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}  # tests/test_kernels.py

KERNELS = [{
    "name": "flash_attention_fwd",
    "route": "cuda",
    "source": "src/repro_torch/csrc/flash_attention_fwd.cu",
    "replaces": "src/repro/kernels/flash_attention.py:26",
    "counter": flash_attention_fwd,
}]

# (name, B, Hq, Hk, Sq, Sk, D, dtype, window)
CHECKS = [
    ("serve_shape_bf16", 4, 32, 8, 1024, 1024, 64, torch.bfloat16, 0),
    ("serve_shape_f32", 4, 32, 8, 1024, 1024, 64, torch.float32, 0),
    ("ragged_500_bf16", 4, 32, 8, 500, 500, 64, torch.bfloat16, 0),
    ("ragged_500_f32", 2, 8, 2, 500, 500, 64, torch.float32, 0),
    ("d32_f32", 2, 8, 2, 384, 384, 32, torch.float32, 0),
    ("d128_f32", 2, 8, 2, 384, 384, 128, torch.float32, 0),
    ("d128_bf16", 2, 8, 2, 384, 384, 128, torch.bfloat16, 0),
    ("window64_f32", 2, 8, 2, 700, 700, 64, torch.float32, 64),
    ("window64_bf16", 4, 32, 8, 1024, 1024, 64, torch.bfloat16, 64),
    ("q_suffix_f32", 2, 8, 2, 256, 1024, 64, torch.float32, 0),
    ("q_suffix_ragged_f32", 2, 8, 2, 100, 777, 128, torch.float32, 0),
    ("q_suffix_ragged_bf16", 2, 8, 4, 37, 555, 32, torch.bfloat16, 0),
]


def emit(obj):
    print(json.dumps(obj), flush=True)


def sync():
    torch.cuda.synchronize()


def qkv(B, Hq, Hk, Sq, Sk, D, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(s, generator=g, device="cuda").to(dtype)
                 for s in ((B, Hq, Sq, D), (B, Hk, Sk, D), (B, Hk, Sk, D)))


def cuda_ms(fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def attended_pairs(Sq, Sk, causal, window):
    """(query, key) pairs the mask keeps: the work this input needs."""
    n = 0
    for r in range(Sk - Sq, Sk):
        hi = r + 1 if causal else Sk
        lo = max(0, r - window + 1) if window else 0
        n += max(0, hi - lo)
    return n


def attention_bound_ms(q, k, v, window):
    B, Hq, Sq, D = q.shape
    Sk = k.shape[2]
    flops = 4 * D * B * Hq * attended_pairs(Sq, Sk, True, window)  # QK^T + PV
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()  # q, k, v, o
    t_ops, t_bytes = flops / PEAK_FLOPS[q.dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_build():
    out = []
    for kern in KERNELS:
        t0 = time.perf_counter()
        report = ops.build(kern["name"])
        out.append({"kernel": kern["name"], "seconds": time.perf_counter() - t0,
                    "ptxas": [ln.strip() for ln in report.splitlines()
                              if "registers" in ln or "spill" in ln]})
    emit({"phase": "build", "kernels": out})


def phase_check():
    rows = []
    for i, (name, B, Hq, Hk, Sq, Sk, D, dtype, window) in enumerate(CHECKS):
        q, k, v = qkv(B, Hq, Hk, Sq, Sk, D, dtype, seed=100 + i)
        out = ops.flash_attention(q, k, v, causal=True, window=window)
        sync()
        ref = attention_ref(q, k, v, causal=True, window=window)
        err = (out.float() - ref.float()).abs().max().item()
        rows.append({"case": name, "shape": [B, Hq, Hk, Sq, Sk, D],
                     "dtype": str(dtype), "window": window,
                     "max_abs_err": err, "tolerance": TOL[dtype]})
        if not (math.isfinite(err) and err <= TOL[dtype]):
            emit({"phase": "check", "failed": rows[-1]})
            raise AssertionError(f"kernel check {name}: {err} > {TOL[dtype]}")
    emit({"phase": "check", "cases": rows})
    return rows


def tensor_bytes(tree):
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def bf16_ulp(x):
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def phase_serve():
    cfg = get_config(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, "cuda")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                            device="cuda")
    eng = Engine(cfg, params, max_len=PROMPT + NEW, device="cuda")
    eng.generate(prompts, 2)  # warm-up: kernel load, cuBLAS handles
    sync()

    for kern in KERNELS:
        kern["counter"].launches = 0
    t0 = time.perf_counter()
    tokens = eng.generate(prompts, NEW)
    sync()
    gen_s = time.perf_counter() - t0
    launches = {kern["name"]: kern["counter"].launches for kern in KERNELS}
    if launches["flash_attention_fwd"] != cfg.n_layers:
        raise AssertionError(f"flash_attention_fwd launched {launches} times in one "
                             f"prefill, expected {cfg.n_layers}")
    if tuple(tokens.shape) != (BATCH, NEW) or not (
            0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab_size):
        raise AssertionError(f"bad tokens {tokens.shape}")

    with torch.inference_mode():
        prefill = make_prefill_fn(cfg, cache_len=PROMPT + NEW)
        decode = make_decode_fn(cfg)
        sync()
        t0 = time.perf_counter()
        st = prefill(params, prompts)
        sync()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        cache, nxt = st["cache"], st["logits_last"].argmax(-1, keepdim=True)
        t0 = time.perf_counter()
        for i in range(NEW - 1):
            nxt = decode(params, cache, nxt, PROMPT + i)["logits"].argmax(-1, keepdim=True)
        sync()
        decode_ms = 1e3 * (time.perf_counter() - t0) / (NEW - 1)
        # a decode step reads every weight and the whole KV cache once
        decode_bytes = tensor_bytes(params) + tensor_bytes(cache)

        # bf16: the kernel path against the plain teacher-forced forward
        got = st["logits_last"].float()
        want = forward(params, prompts, cfg, attn_impl="plain")["logits"][:, -1].float()
        peak = want.abs().max().item()
        err = (got - want).abs().max().item()
        # both sides round logits to bf16 (1 ulp) and 16 layers round the
        # attention output and residual to bf16 at different points: 8 ulps
        # of the largest logit
        tol = 8 * bf16_ulp(peak)
        finite = bool(torch.isfinite(got).all())
    del params, eng, cache, st
    torch.cuda.empty_cache()
    if not (finite and err <= tol):
        raise AssertionError(f"bf16 prefill logits: max err {err} > {tol} (finite={finite})")

    f32 = serve_f32_check(cfg)
    emit({"phase": "serve", "arch": ARCH, "layers": cfg.n_layers, "dtype": "bfloat16",
          "batch": BATCH, "prompt": PROMPT, "new_tokens": NEW,
          "launches_per_prefill": launches,
          "generate_s": gen_s, "tokens_per_s": BATCH * NEW / gen_s,
          "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
          "decode_bytes": decode_bytes,
          "decode_bound_ms": 1e3 * decode_bytes / PEAK_BYTES,
          "bf16_last_logits_max_abs_err": err, "bf16_tolerance": tol,
          "max_abs_logit": peak, "f32_2layer": f32})
    return launches


def serve_f32_check(cfg):
    """Prefill + 6 decode steps against a teacher-forced plain forward, f32,
    full width, 2 layers, at tests/test_serve.py's 2e-3 (TF32 off)."""
    cfg = cfg.replace(n_layers=2, param_dtype=torch.float32,
                      compute_dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = init_params(cfg, gen, "cuda")
    B, S, S0 = 2, 256, 250
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    before = flash_attention_fwd.launches
    with torch.inference_mode():
        full = forward(params, toks, cfg, attn_impl="plain")["logits"]
        st = make_prefill_fn(cfg, cache_len=S)(params, toks[:, :S0])
        decode = make_decode_fn(cfg)
        cache, logits = st["cache"], [st["logits_last"]]
        for i in range(S - S0):
            out = decode(params, cache, toks[:, S0 + i:S0 + i + 1], S0 + i)
            logits.append(out["logits"])
            cache = out["cache"]
        errs = [(full[:, S0 - 1 + i] - lg).abs().max().item()
                for i, lg in enumerate(logits)]
    if flash_attention_fwd.launches - before != cfg.n_layers:
        raise AssertionError("f32 prefill did not go through the kernel")
    if not max(errs) < 2e-3:
        raise AssertionError(f"f32 prefill/decode vs teacher forcing: {errs}")
    return {"max_abs_err": max(errs), "tolerance": 2e-3, "steps": len(errs)}


def phase_timing(check_rows, launches):
    """Times at the serving shape, and the kernels line."""
    q, k, v = qkv(4, 32, 8, PROMPT, PROMPT, 64, torch.bfloat16, seed=7)
    ms = cuda_ms(lambda: ops.flash_attention(q, k, v), 50)
    plain_ms = cuda_ms(lambda: attention_ref(q, k, v), 10)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 50)
    bound_ms, bound_by = attention_bound_ms(q, k, v, 0)
    serve_row = next(r for r in check_rows if r["case"] == "serve_shape_bf16")
    fa = KERNELS[0]
    emit({"kernels": [{
        "name": fa["name"], "route": fa["route"], "source": fa["source"],
        "replaces": fa["replaces"], "launches": launches[fa["name"]],
        "max_abs_err": serve_row["max_abs_err"], "tolerance": serve_row["tolerance"],
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
        "shape": [4, 32, 8, PROMPT, PROMPT, 64], "dtype": "bfloat16"}]})


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    rows = phase_check()
    launches = phase_serve()
    phase_timing(rows, launches)
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
