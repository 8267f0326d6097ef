"""Binding of the hand-written selective-scan kernel (`csrc/ssm_scan.cu`,
K7), the port of the Pallas TPU kernel `repro/kernels/ssm_scan.py
::_ssm_kernel`.

x, dt (B, S, Di); A (Di, N); Bm, Cm (B, S, N); h0 (B, Di, N). x, Bm and Cm
share one dtype (f32 or bf16); dt, A and h0 are f32. x, dt, Bm and Cm may be
strided views whose last axis is contiguous (Bm and Cm are column slices of
the x_proj output); A and h0 are contiguous. `check_inputs` applies on every
device, so the CPU path accepts exactly what the card path accepts.
"""
from __future__ import annotations

import ctypes

import torch

DTYPES = (torch.float32, torch.bfloat16)
MAX_STATE = 32   # the kernel's largest instance: 8 states in each of 4 lanes
MAX_BATCH = 65535  # the kernel's grid.y
SSM_NO_BACKWARD = ("ssm_scan has no backward: training through the selective "
                   "scan is not ported (ROADMAP item 23)")


def check_inputs(x, dt, A, Bm, Cm, h0) -> None:
    """Raise on anything the kernel does not take."""
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"ssm_scan: x {tuple(x.shape)} and dt {tuple(dt.shape)} "
                         f"must both be (B, S, Di)")
    B, S, Di = x.shape
    if A.dim() != 2 or A.shape[0] != Di:
        raise ValueError(f"ssm_scan: A {tuple(A.shape)} must be (Di={Di}, N)")
    N = A.shape[1]
    if Bm.shape != (B, S, N) or Cm.shape != (B, S, N):
        raise ValueError(f"ssm_scan: Bm {tuple(Bm.shape)} / Cm {tuple(Cm.shape)} "
                         f"must be {(B, S, N)}")
    if h0.shape != (B, Di, N):
        raise ValueError(f"ssm_scan: h0 {tuple(h0.shape)} must be {(B, Di, N)}")
    if not (0 < B <= MAX_BATCH and S > 0 and Di > 0 and 0 < N <= MAX_STATE):
        raise ValueError(f"ssm_scan: need 0 < B <= {MAX_BATCH}, S > 0, Di > 0 and "
                         f"0 < N <= {MAX_STATE}; got {(B, S, Di, N)}")
    if x.dtype not in DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssm_scan: x / Bm / Cm dtypes {x.dtype}/{Bm.dtype}/"
                        f"{Cm.dtype}; need one of {DTYPES} for all three")
    for name, t in (("dt", dt), ("A", A), ("h0", h0)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssm_scan: {name} is {t.dtype}, need torch.float32")
    for name, t in (("x", x), ("dt", dt), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssm_scan: {name}'s last axis is not contiguous")
    for name, t in (("A", A), ("h0", h0)):
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan: {name} is not contiguous")
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm), ("h0", h0)):
        if t.device != x.device:
            raise ValueError(f"ssm_scan: {name} on {t.device}, x on {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bm, Cm, h0)):
        raise NotImplementedError(SSM_NO_BACKWARD)


def ssm_scan_fwd(lib: ctypes.CDLL, x, dt, A, Bm, Cm, h0):
    """Launch K7 from `lib` on CUDA tensors already passed through
    `check_inputs`; returns (y (B, S, Di) f32, h (B, Di, N) f32), new."""
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan_fwd: needs CUDA tensors, got {x.device}")
    B, S, Di = x.shape
    N = A.shape[1]
    y = torch.empty((B, S, Di), dtype=torch.float32, device=x.device)
    h = torch.empty((B, Di, N), dtype=torch.float32, device=x.device)
    fn = lib.ssm_scan
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_int64] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    strides = [s for t in (x, dt, Bm, Cm) for s in (t.stride(0), t.stride(1))]
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             h0.data_ptr(), y.data_ptr(), h.data_ptr(), int(x.dtype == torch.bfloat16),
             B, S, Di, N, *strides, stream)
    if err:
        raise RuntimeError(f"ssm_scan_fwd: launch failed with cudaError {err}")
    ssm_scan_fwd.launches += 1
    return y, h


ssm_scan_fwd.launches = 0


_CONFIG_FIELDS = ("lanes", "channels_per_cta", "tile", "stages", "threads", "smem_bytes",
                  "ctas_per_sm", "registers", "local_bytes")


def scan_config(lib: ctypes.CDLL, dtype, N: int) -> dict:
    """K7's choice for x / Bm / Cm of `dtype` with N states on the current
    device: lanes per channel, channels per CTA, tile (time steps), stages,
    threads per CTA, dynamic shared bytes, resident CTAs per SM (the occupancy
    query's), registers and local (spill) bytes per thread."""
    out = (ctypes.c_int * len(_CONFIG_FIELDS))()
    fn = lib.ssm_scan_config
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(int(dtype == torch.bfloat16), N, out)
    if err:
        raise RuntimeError(f"ssm_scan_config: cudaError {err}")
    return dict(zip(_CONFIG_FIELDS, out))
