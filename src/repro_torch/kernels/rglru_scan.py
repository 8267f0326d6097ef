"""Bindings of the hand-written RG-LRU scan kernel (`csrc/rglru_scan.cu`,
K8), the port of the Pallas TPU kernel `repro/kernels/rglru_scan.py
::_rglru_kernel`, and of its backward (`csrc/rglru_scan_bwd.cu`, K8-bwd),
which has no Pallas counterpart (the JAX package differentiates its
recurrence with jax.grad).

a, gx (B, S, W) of one dtype (f32 or bf16), read as f32; h0 (B, W) f32; all
contiguous. `check_inputs` applies on every device, so the CPU path accepts
exactly what the card path accepts.
"""
from __future__ import annotations

import ctypes

import torch

DTYPES = (torch.float32, torch.bfloat16)


def check_inputs(a, gx, h0) -> None:
    """Raise on anything the kernel does not take."""
    if a.dim() != 3 or gx.shape != a.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} and gx {tuple(gx.shape)} "
                         f"must both be (B, S, W)")
    B, S, W = a.shape
    if not (B > 0 and S > 0 and W > 0):
        raise ValueError(f"rglru_scan: need B, S, W > 0; got {(B, S, W)}")
    if h0.shape != (B, W):
        raise ValueError(f"rglru_scan: h0 {tuple(h0.shape)} must be {(B, W)}")
    if a.dtype not in DTYPES or gx.dtype != a.dtype:
        raise TypeError(f"rglru_scan: a / gx dtypes {a.dtype}/{gx.dtype}; need one "
                        f"of {DTYPES} for both")
    if h0.dtype != torch.float32:
        raise TypeError(f"rglru_scan: h0 is {h0.dtype}, need torch.float32")
    for name, t in (("a", a), ("gx", gx), ("h0", h0)):
        if t.device != a.device:
            raise ValueError(f"rglru_scan: {name} on {t.device}, a on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"rglru_scan: {name} is not contiguous")


def rglru_scan_fwd(lib: ctypes.CDLL, a, gx, h0):
    """Launch K8 from `lib` on CUDA tensors already passed through
    `check_inputs`; returns (hs (B, S, W) f32, h (B, W) f32), new."""
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan_fwd: needs CUDA tensors, got {a.device}")
    B, S, W = a.shape
    hs = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    h = torch.empty((B, W), dtype=torch.float32, device=a.device)
    fn = lib.rglru_scan
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_int64] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), gx.data_ptr(), h0.data_ptr(), hs.data_ptr(), h.data_ptr(),
             int(a.dtype == torch.bfloat16), B, S, W, stream)
    if err:
        raise RuntimeError(f"rglru_scan_fwd: launch failed with cudaError {err}")
    rglru_scan_fwd.launches += 1
    return hs, h


rglru_scan_fwd.launches = 0


def rglru_scan_bwd(lib: ctypes.CDLL, a, h0, hs, dhs, dh=None):
    """Launch K8-bwd from `lib` on the CUDA inputs of a K8 call already
    passed through `check_inputs` (a, h0), the forward's states hs and their
    cotangent dhs ((B, S, W) f32 contiguous), and the final state's
    cotangent dh ((B, W) f32 contiguous, or None). Returns (da, dgx, dh0),
    new: da and dgx in a's dtype (gx shares it), dh0 f32."""
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan_bwd: needs CUDA tensors, got {a.device}")
    B, S, W = a.shape
    for name, t, shape in (("hs", hs, (B, S, W)), ("dhs", dhs, (B, S, W)),
                           ("dh", dh, (B, W))):
        if t is not None and (t.shape != shape or t.dtype != torch.float32
                              or not t.is_contiguous() or t.device != a.device):
            raise ValueError(f"rglru_scan_bwd: {name} must be a contiguous f32 {shape} "
                             f"on {a.device}")
    da = torch.empty((B, S, W), dtype=a.dtype, device=a.device)
    dgx = torch.empty((B, S, W), dtype=a.dtype, device=a.device)
    dh0 = torch.empty((B, W), dtype=torch.float32, device=a.device)
    fn = lib.rglru_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] + [ctypes.c_int64] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), hs.data_ptr(), dhs.data_ptr(), h0.data_ptr(),
             None if dh is None else dh.data_ptr(), da.data_ptr(), dgx.data_ptr(),
             dh0.data_ptr(), int(a.dtype == torch.bfloat16), B, S, W, stream)
    if err:
        raise RuntimeError(f"rglru_scan_bwd: launch failed with cudaError {err}")
    rglru_scan_bwd.launches += 1
    return da, dgx, dh0


rglru_scan_bwd.launches = 0
