"""Bindings of the hand-written selective-scan kernel (`csrc/ssm_scan.cu`,
K7), the port of the Pallas TPU kernel `repro/kernels/ssm_scan.py
::_ssm_kernel`, and of its backward (`csrc/ssm_scan_bwd.cu`, K7-bwd), which
has no Pallas counterpart (the JAX package differentiates its scan with
jax.grad).

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


def ssm_scan_bwd(lib: ctypes.CDLL, x, dt, A, Bm, Cm, h0, dy, dh=None):
    """Launch K7-bwd from `lib` (the scan kernel and its partial-sum kernel,
    counted as one launch) on the CUDA inputs of a K7 call already passed
    through `check_inputs`, dy (B, S, Di) f32 contiguous and dh (B, Di, N)
    f32 contiguous or None. Returns (dx, ddt, dA, dBm, dCm, dh0), new and
    contiguous, each in its input's dtype."""
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan_bwd: needs CUDA tensors, got {x.device}")
    B, S, Di = x.shape
    N = A.shape[1]
    for name, t, shape in (("dy", dy, (B, S, Di)), ("dh", dh, (B, Di, N))):
        if t is not None and (t.shape != shape or t.dtype != torch.float32
                              or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"ssm_scan_bwd: {name} must be a contiguous f32 {shape} "
                             f"on {x.device}")
    dx = torch.empty((B, S, Di), dtype=x.dtype, device=x.device)
    ddt = torch.empty((B, S, Di), dtype=torch.float32, device=x.device)
    dA = torch.empty((Di, N), dtype=torch.float32, device=x.device)
    dBm = torch.empty((B, S, N), dtype=Bm.dtype, device=x.device)
    dCm = torch.empty((B, S, N), dtype=Cm.dtype, device=x.device)
    dh0 = torch.empty((B, Di, N), dtype=torch.float32, device=x.device)
    scratch = torch.empty(ssm_scan_bwd_scratch(lib, B, S, Di, N), dtype=torch.float32,
                          device=x.device)
    fn = lib.ssm_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [
        ctypes.c_int64] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    strides = [s for t in (x, dt, Bm, Cm) for s in (t.stride(0), t.stride(1))]
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             h0.data_ptr(), dy.data_ptr(), None if dh is None else dh.data_ptr(),
             dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dBm.data_ptr(), dCm.data_ptr(),
             dh0.data_ptr(), scratch.data_ptr(), int(x.dtype == torch.bfloat16),
             B, S, Di, N, *strides, stream)
    if err:
        raise RuntimeError(f"ssm_scan_bwd: launch failed with cudaError {err}")
    ssm_scan_bwd.launches += 1
    return dx, ddt, dA, dBm, dCm, dh0


ssm_scan_bwd.launches = 0


def ssm_scan_bwd_scratch(lib: ctypes.CDLL, B: int, S: int, Di: int, N: int) -> int:
    """The f32 scratch values of one K7-bwd call, as the kernel's source
    sizes them: the tile checkpoints, the channel blocks' partial sums of
    dBm and dCm and the per-batch partials of dA."""
    fn = lib.ssm_scan_bwd_scratch
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int64
    return fn(B, S, Di, N, (ctypes.c_int64 * 3)())
