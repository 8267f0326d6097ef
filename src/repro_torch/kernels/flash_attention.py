"""Binding of the hand-written flash attention forward kernel
(`csrc/flash_attention_fwd.cu`), the port of the Pallas TPU kernel
`repro/kernels/flash_attention.py::_fwd_kernel`.

Layout: q (B, Hq, Sq, D); k/v (B, Hk, Sk, D); Hq = G * Hk (GQA, kv head
h // G inside the kernel). Sq may be shorter than Sk: the q rows are the
suffix of the kv range.
"""
from __future__ import annotations

import ctypes

import torch

HEAD_DIMS = (32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)


def check_inputs(q, k, v, window: int) -> None:
    """Raise on anything the kernel does not take. Applied on every device,
    so the CPU path accepts exactly what the card path accepts."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D (B, H, S, D)")
    B, Hq, Sq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    Hk, Sk = k.shape[1], k.shape[2]
    if Hk == 0 or Hq % Hk:
        raise ValueError(f"flash_attention: Hq={Hq} is not a multiple of Hk={Hk}")
    if not 0 < Sq <= Sk or B == 0 or Hq == 0:
        raise ValueError(f"flash_attention: need B, H > 0 and 0 < Sq={Sq} <= Sk={Sk}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        f"need one of {DTYPES} for all three")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")


def flash_attention_fwd(lib: ctypes.CDLL, q, k, v, *, causal: bool,
                        window: int) -> torch.Tensor:
    """Launch the kernel from `lib` on CUDA tensors already passed through
    `check_inputs`; returns a new (B, Hq, Sq, D) tensor of q's dtype."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: needs CUDA tensors, got {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_fwd: {name} is not 16-byte aligned")
    B, Hq, Sq, D = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             int(q.dtype == torch.bfloat16), B, Hq, Hk, Sq, Sk, D,
             int(causal), int(window), D ** -0.5, stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd: launch failed with cudaError {err}")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
