"""Bindings of the hand-written exchange kernels (`csrc/comm_kernels.cu`),
the ports of the Pallas TPU kernels in `repro/kernels/comm_kernels.py`:

  eq1_merge_fwd        K2, `_eq1_kernel`: paper Eq. (1) over an arena
  bf16_pack_fwd        K3, `_cast_kernel` into bf16: arena -> bf16 wire
  bf16_unpack_fwd      K4, `_cast_kernel` out of bf16: bf16 wire -> arena dtype
  quantize_int8_fwd    K5, `_quantize_kernel`: arena -> int8 values and one
                       f32 scale per block of the trailing axis
  dequantize_int8_fwd  K6, `_dequantize_kernel`: int8 values * scales -> f32

K2 to K4 take contiguous tensors of any shape and treat them as one flat
range; K5 and K6 treat them as (rows, N) over the trailing axis. `check_*`
validate on every device, so the CPU path accepts exactly what the card
path accepts; the `*_fwd` launchers take CUDA tensors only, launch on the
current stream, raise on a non-zero cudaError and count their launches.
`launch_eq1_merge` and `launch_cast` call K2 to K4's entry points into an
output the caller gives (a view at any alignment) and count nothing: the
checks use them. `ring_config` reads the stream ring's sizing.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels.ref import INT8_SCALE_FLOOR

ARENA_DTYPES = (torch.float32, torch.bfloat16)
_CODE = {torch.float32: 0, torch.bfloat16: 1}


def eq1_weights(staleness: int, global_world, extra_staleness: int = 0):
    """(s2, p, denom) of Eq. (1) as the reference rounds them: s2 = 2(S+E)
    and p = P as f32 multipliers, denom = s2 + p summed in double and
    rounded to f32 once (`repro/kernels/ref.py::eq1_merge_ref`)."""
    s2 = 2.0 * (staleness + extra_staleness)
    p = float(global_world)
    return s2, p, float(np.float32(s2 + p))


def _check_tensors(name: str, *tensors) -> None:
    first = tensors[0]
    for t in tensors:
        if t.device != first.device:
            raise ValueError(f"{name}: tensors on {t.device} and {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: input is not contiguous")


def check_eq1(local, stale) -> None:
    if local.shape != stale.shape or local.dtype != stale.dtype:
        raise ValueError(f"eq1_merge: local {tuple(local.shape)} {local.dtype} and "
                         f"stale {tuple(stale.shape)} {stale.dtype} differ")
    if local.dtype not in ARENA_DTYPES:
        raise TypeError(f"eq1_merge: arena dtype {local.dtype} not in {ARENA_DTYPES}")
    _check_tensors("eq1_merge", local, stale)


def check_pack(x) -> None:
    if x.dtype not in ARENA_DTYPES:
        raise TypeError(f"bf16_pack: arena dtype {x.dtype} not in {ARENA_DTYPES}")
    _check_tensors("bf16_pack", x)


def check_unpack(x, out_dtype) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"bf16_unpack: wire dtype {x.dtype}, need torch.bfloat16")
    if out_dtype not in ARENA_DTYPES:
        raise TypeError(f"bf16_unpack: out dtype {out_dtype} not in {ARENA_DTYPES}")
    _check_tensors("bf16_unpack", x)


def n_scale_blocks(n: int, block: int) -> int:
    """Scale blocks of a row of n elements: ceil(n / block)."""
    return -(-n // block)


def _check_block(name: str, block) -> None:
    if not isinstance(block, int) or block <= 0:
        raise ValueError(f"{name}: block must be a positive int, got {block!r}")


def check_quantize(x, bits, block) -> None:
    _check_block("quantize_int8", block)
    if x.dtype not in ARENA_DTYPES:
        raise TypeError(f"quantize_int8: dtype {x.dtype} not in {ARENA_DTYPES}")
    if x.dim() < 1:
        raise ValueError("quantize_int8: needs at least one axis (blocks run over "
                         "the trailing one)")
    if bits is None:
        _check_tensors("quantize_int8", x)
        return
    if bits.dtype != torch.uint32 or bits.shape != x.shape:
        raise TypeError(f"quantize_int8: bits must be uint32 of x's shape "
                        f"{tuple(x.shape)}, got {bits.dtype} {tuple(bits.shape)}")
    _check_tensors("quantize_int8", x, bits)


def check_dequantize(values, scales, block) -> None:
    _check_block("dequantize_int8", block)
    if values.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"dequantize_int8: needs int8 values and float32 scales, got "
                        f"{values.dtype} and {scales.dtype}")
    if values.dim() < 1:
        raise ValueError("dequantize_int8: needs at least one axis")
    want = tuple(values.shape[:-1]) + (n_scale_blocks(values.shape[-1], block),)
    if tuple(scales.shape) != want:
        raise ValueError(f"dequantize_int8: scales {tuple(scales.shape)} for values "
                         f"{tuple(values.shape)} at block {block}, need {want}")
    _check_tensors("dequantize_int8", values, scales)


def _stream(t) -> int:
    if t.device.type != "cuda":
        raise ValueError(f"needs CUDA tensors, got {t.device}")
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: launch failed with cudaError {err}")


_ARGTYPES = {
    "eq1_merge": [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int] + [
        ctypes.c_float] * 3 + [ctypes.c_void_p],
    "bf16_pack": [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p],
    "bf16_unpack": [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p],
    "stream_ring_config": [ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p],
}


def _entry(lib: ctypes.CDLL, name: str):
    fn = getattr(lib, name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def launch_eq1_merge(lib: ctypes.CDLL, local, stale, out, *, staleness: int,
                     global_world, extra_staleness: int = 0) -> None:
    """K2's entry point into `out`, a CUDA tensor of local's shape and
    dtype at any alignment (a view whose 16-byte misalignment x and y share
    takes the ring's scalar head). Counts nothing: `eq1_merge_fwd` is the
    path's launch."""
    s2, p, denom = eq1_weights(staleness, global_world, extra_staleness)
    _raise_on("eq1_merge", _entry(lib, "eq1_merge")(
        local.data_ptr(), stale.data_ptr(), out.data_ptr(), local.numel(),
        _CODE[local.dtype], s2, p, denom, _stream(local)))


def launch_cast(lib: ctypes.CDLL, name: str, x, out) -> None:
    """The cast entry point `name` ("bf16_pack": K3, arena -> bf16;
    "bf16_unpack": K4, bf16 -> arena dtype) into `out`, as
    `launch_eq1_merge`."""
    code = _CODE[x.dtype] if name == "bf16_pack" else _CODE[out.dtype]
    _raise_on(name, _entry(lib, name)(x.data_ptr(), out.data_ptr(), x.numel(), code,
                                      _stream(x)))


_RING_FIELDS = ("chunk_bytes", "chunk_elements", "stages", "ctas_per_sm", "smem_bytes",
                "grid")
_RING_ENTRIES = {"eq1_merge": 0, "bf16_pack": 1, "bf16_unpack": 2}


def ring_config(lib: ctypes.CDLL, entry: str, dtype, n: int) -> dict:
    """The stream ring's choice for `entry` (K2 at arena `dtype`, K3 from
    it, K4 into it) at n aligned elements on the current device: chunk
    bytes per input and elements, stages, CTAs per SM (the occupancy
    query's), dynamic shared bytes and grid."""
    out = (ctypes.c_int * len(_RING_FIELDS))()
    _raise_on("stream_ring_config", _entry(lib, "stream_ring_config")(
        _RING_ENTRIES[entry], _CODE[dtype], n, out))
    return dict(zip(_RING_FIELDS, out))


def eq1_merge_fwd(lib: ctypes.CDLL, local, stale, *, staleness: int,
                  global_world, extra_staleness: int = 0) -> torch.Tensor:
    """K2 on CUDA tensors already passed through `check_eq1`; returns a new
    tensor of local's shape and dtype."""
    _stream(local)  # refuses a CPU tensor before anything is allocated
    out = torch.empty_like(local)
    if local.numel():
        launch_eq1_merge(lib, local, stale, out, staleness=staleness,
                         global_world=global_world, extra_staleness=extra_staleness)
        eq1_merge_fwd.launches += 1
    return out


def bf16_pack_fwd(lib: ctypes.CDLL, x) -> torch.Tensor:
    """K3 on a CUDA tensor already passed through `check_pack`."""
    _stream(x)
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    if x.numel():
        launch_cast(lib, "bf16_pack", x, out)
        bf16_pack_fwd.launches += 1
    return out


def bf16_unpack_fwd(lib: ctypes.CDLL, x, out_dtype=torch.float32) -> torch.Tensor:
    """K4 on a CUDA tensor already passed through `check_unpack`."""
    _stream(x)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel():
        launch_cast(lib, "bf16_unpack", x, out)
        bf16_unpack_fwd.launches += 1
    return out


def quantize_int8_fwd(lib: ctypes.CDLL, x, bits=None, *, block: int = 256):
    """K5 on CUDA tensors already passed through `check_quantize`; returns
    (values int8 of x's shape, scales f32 (*lead, ceil(N / block)))."""
    stream = _stream(x)
    n = x.shape[-1]
    rows = math.prod(x.shape[:-1])
    values = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty(tuple(x.shape[:-1]) + (n_scale_blocks(n, block),),
                         dtype=torch.float32, device=x.device)
    if x.numel():
        fn = lib.quantize_int8
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _raise_on("quantize_int8", fn(
            x.data_ptr(), None if bits is None else bits.data_ptr(), values.data_ptr(),
            scales.data_ptr(), rows, n, block, _CODE[x.dtype], INT8_SCALE_FLOOR, stream))
        quantize_int8_fwd.launches += 1
    return values, scales


def dequantize_int8_fwd(lib: ctypes.CDLL, values, scales, *, block: int = 256):
    """K6 on CUDA tensors already passed through `check_dequantize`;
    returns f32 of values' shape."""
    stream = _stream(values)
    out = torch.empty(values.shape, dtype=torch.float32, device=values.device)
    if values.numel():
        fn = lib.dequantize_int8
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _raise_on("dequantize_int8", fn(
            values.data_ptr(), scales.data_ptr(), out.data_ptr(),
            math.prod(values.shape[:-1]), values.shape[-1], block, stream))
        dequantize_int8_fwd.launches += 1
    return out


eq1_merge_fwd.launches = 0
bf16_pack_fwd.launches = 0
bf16_unpack_fwd.launches = 0
quantize_int8_fwd.launches = 0
dequantize_int8_fwd.launches = 0
