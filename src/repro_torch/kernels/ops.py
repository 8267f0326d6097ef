"""Public kernel entry points of the port, and the build of the CUDA
sources at first use.

A wrapper takes its kernel's plain version (`ref.py`) only for tensors on
the CPU. For CUDA tensors it builds the kernel (once per process, with
`nvcc` for sm_90a, into `build/` beside the sources) and launches it, or
raises. The two scans are `torch.autograd.Function`s whose backward is
again a kernel on the card (K7-bwd, K8-bwd) and the plain backward on the
CPU.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import comm_kernels as comm
from repro_torch.kernels import rglru_scan as rglru
from repro_torch.kernels import ssm_scan as scan
from repro_torch.kernels.flash_attention import check_inputs, flash_attention_fwd
from repro_torch.kernels.ref import (attention_ref, bf16_pack_ref, bf16_unpack_ref,
                                     dequantize_int8_block_ref, eq1_merge_ref,
                                     quantize_int8_block_ref, rglru_scan_bwd_ref,
                                     rglru_scan_ref, ssm_scan_bwd_ref, ssm_scan_ref)

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libraries: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (set CUDA_HOME or PATH)")


def build(name: str) -> str:
    """Compile `csrc/<name>.cu` into `build/lib<name>.so`. Returns the
    compiler's report (ptxas registers / shared memory / spills)."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}.so"
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}\n{r.stderr}")
    os.replace(tmp, out)  # atomic: no process loads a partly written library
    return r.stderr


def kernel_library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built if missing or stale.
    Processes that share the checkout (a multi-process run's workers) take
    a file lock around the check and the build, so one builds and the
    others load its library."""
    lib = _libraries.get(name)
    if lib is None:
        so = BUILD_DIR / f"lib{name}.so"
        src = CSRC / f"{name}.cu"

        def stale():
            return not so.exists() or so.stat().st_mtime < src.stat().st_mtime

        if stale():
            BUILD_DIR.mkdir(exist_ok=True)
            with open(BUILD_DIR / f".lib{name}.lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if stale():
                    build(name)
        lib = _libraries[name] = ctypes.CDLL(str(so))
    return lib


def launch_counts() -> dict:
    """Each kernel's launches in this process so far (the wrappers count
    where they launch, and nowhere else), by kernel name."""
    return {"flash_attention_fwd": flash_attention_fwd.launches,
            "eq1_merge": comm.eq1_merge_fwd.launches,
            "bf16_pack": comm.bf16_pack_fwd.launches,
            "bf16_unpack": comm.bf16_unpack_fwd.launches,
            "quantize_int8": comm.quantize_int8_fwd.launches,
            "dequantize_int8": comm.dequantize_int8_fwd.launches,
            "ssm_scan": scan.ssm_scan_fwd.launches,
            "rglru_scan": rglru.rglru_scan_fwd.launches,
            "ssm_scan_bwd": scan.ssm_scan_bwd.launches,
            "rglru_scan_bwd": rglru.rglru_scan_bwd.launches}


class CopyMeter:
    """Copies made to hand a kernel or a gather a contiguous tensor: how
    many, and their bytes."""

    def __init__(self):
        self.copies = self.bytes = 0

    def reset(self) -> None:
        self.copies = self.bytes = 0


CONTIGUOUS_COPIES = CopyMeter()


def contiguous(x: torch.Tensor) -> torch.Tensor:
    """`x` itself when contiguous, else a contiguous copy, counted in
    `CONTIGUOUS_COPIES` (the wrappers refuse strided views)."""
    if x.is_contiguous():
        return x
    CONTIGUOUS_COPIES.copies += 1
    CONTIGUOUS_COPIES.bytes += x.numel() * x.element_size()
    return x.contiguous()


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B,Hq,Sq,D); k,v (B,Hk,Sk,D) -> (B,Hq,Sq,D) in q's dtype.

    Sq may be shorter than Sk (the q rows are the suffix of the kv range,
    e.g. chunked prefill); rows are aligned at the end."""
    check_inputs(q, k, v, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return flash_attention_fwd(kernel_library("flash_attention_fwd"), q, k, v,
                               causal=causal, window=window)


def _on_card(name: str, t) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return True


class _SsmScan(torch.autograd.Function):
    """K7 forward and K7-bwd backward on the card, the plain versions of
    both on the CPU. Saves the inputs (the backward recomputes the states
    from them)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, h0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm, h0)
        if not _on_card("ssm_scan", x):
            return ssm_scan_ref(x, dt, A, Bm, Cm, h0)
        return scan.ssm_scan_fwd(kernel_library("ssm_scan"), x, dt, A, Bm, Cm, h0)

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, Bm, Cm, h0 = ctx.saved_tensors
        if dy is None:  # only h_final was used
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        if not _on_card("ssm_scan", x):
            grads = ssm_scan_bwd_ref(x, dt, A, Bm, Cm, h0, dy, dh)
        else:
            grads = scan.ssm_scan_bwd(kernel_library("ssm_scan_bwd"), x, dt, A, Bm, Cm,
                                      h0, contiguous(dy),
                                      None if dh is None else contiguous(dh))
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


class _RglruScan(torch.autograd.Function):
    """K8 forward and K8-bwd backward on the card, the plain versions of
    both on the CPU. Saves a, h0 and the states hs."""

    @staticmethod
    def forward(ctx, a, gx, h0):
        ctx.set_materialize_grads(False)
        if not _on_card("rglru_scan", a):
            hs, h = rglru_scan_ref(a, gx, h0)
        else:
            hs, h = rglru.rglru_scan_fwd(kernel_library("rglru_scan"), a, gx, h0)
        ctx.save_for_backward(a, h0, hs)
        return hs, h

    @staticmethod
    def backward(ctx, dhs, dh):
        a, h0, hs = ctx.saved_tensors
        if dhs is None:  # only h_final was used
            dhs = torch.zeros(hs.shape, dtype=torch.float32, device=hs.device)
        if not _on_card("rglru_scan", a):
            # gx's dtype is a's, which is all the plain backward reads of gx
            grads = rglru_scan_bwd_ref(a, a, h0, hs, dhs, dh)
        else:
            grads = rglru.rglru_scan_bwd(kernel_library("rglru_scan_bwd"), a, h0, hs,
                                         contiguous(dhs),
                                         None if dh is None else contiguous(dh))
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def ssm_scan(x, dt, A, Bm, Cm, h0):
    """Mamba-1 selective scan (K7): x, dt (B,S,Di); A (Di,N) f32; Bm, Cm
    (B,S,N); h0 (B,Di,N) f32 -> (y (B,S,Di) f32, h_final (B,Di,N) f32).
    Differentiable in every input, the backward K7-bwd on the card; without
    a gradient to take (torch.no_grad, serving) nothing is saved."""
    scan.check_inputs(x, dt, A, Bm, Cm, h0)
    return _SsmScan.apply(x, dt, A, Bm, Cm, h0)


def rglru_scan(a, gx, h0):
    """RG-LRU diagonal recurrence h_t = a_t * h_{t-1} + gx_t (K8): a, gx
    (B,S,W) of one dtype; h0 (B,W) f32 -> (hs (B,S,W) f32, h_final (B,W)
    f32). Differentiable in every input, the backward K8-bwd on the card;
    without a gradient to take (torch.no_grad, serving) nothing is saved."""
    rglru.check_inputs(a, gx, h0)
    return _RglruScan.apply(a, gx, h0)


def eq1_merge(local, stale, *, staleness: int, global_world,
              extra_staleness: int = 0):
    """Paper Eq. (1) over an arena of any shape: (2(S+E)·local + P·stale) /
    (2(S+E) + P) in f32, output in local's dtype (K2)."""
    comm.check_eq1(local, stale)
    kw = dict(staleness=staleness, global_world=global_world,
              extra_staleness=extra_staleness)
    if not _on_card("eq1_merge", local):
        return eq1_merge_ref(local, stale, **kw)
    return comm.eq1_merge_fwd(kernel_library("comm_kernels"), local, stale, **kw)


def bf16_pack(x):
    """Arena -> bf16 wire buffer of the same shape (K3)."""
    comm.check_pack(x)
    if not _on_card("bf16_pack", x):
        return bf16_pack_ref(x)
    return comm.bf16_pack_fwd(kernel_library("comm_kernels"), x)


def bf16_unpack(x, out_dtype=torch.float32):
    """bf16 wire buffer -> arena in `out_dtype` (K4)."""
    comm.check_unpack(x, out_dtype)
    if not _on_card("bf16_unpack", x):
        return bf16_unpack_ref(x, out_dtype)
    return comm.bf16_unpack_fwd(kernel_library("comm_kernels"), x, out_dtype)


def quantize_int8(x, bits=None, *, block: int = 256):
    """Block-scaled int8 quantization over the trailing axis (K5). `bits`
    (uint32, x's shape) selects stochastic rounding; None rounds to nearest
    even. Returns (values int8 like x, scales f32 (*lead, ceil(N/block)))."""
    comm.check_quantize(x, bits, block)
    if not _on_card("quantize_int8", x):
        return quantize_int8_block_ref(x, block=block, bits=bits)
    return comm.quantize_int8_fwd(kernel_library("comm_kernels"), x, bits, block=block)


def dequantize_int8(values, scales, *, block: int = 256):
    """Inverse of `quantize_int8`: f32 of values' shape (K6)."""
    comm.check_dequantize(values, scales, block)
    if not _on_card("dequantize_int8", values):
        return dequantize_int8_block_ref(values, scales, block=block)
    return comm.dequantize_int8_fwd(kernel_library("comm_kernels"), values, scales,
                                    block=block)
