"""Wire-format byte accounting of the global exchange
(`repro/core/compression.py`): the bytes one exchange puts on the wire at
each tier, for the training summary and the benchmarks.

Paper §3: parameters are cast to a 16-bit type for the blocking global
syncs. The beyond-paper int8 tier carries 1 byte per element plus one f32
scale per `int8_block` elements of each dtype arena. (The reference's
per-leaf back-compat wrappers, `compress_bf16` and friends, have no caller
in either package and are not ported.)
"""
from __future__ import annotations

import math

from repro_torch.core.flatbuf import dtype_name
from repro_torch.tree import leaves

#: bytes per floating element on the wire, excluding int8 scale overhead
WIRE_ITEMSIZE = {"f32": 4.0, "bf16": 2.0, "f16": 2.0, "int8": 1.0}


def _check(wire_format: str) -> None:
    if wire_format not in WIRE_ITEMSIZE:
        raise ValueError(f"unknown wire_format {wire_format!r}; expected "
                         f"one of {sorted(WIRE_ITEMSIZE)}")


def wire_itemsize(wire_format: str, *, int8_block: int = 256) -> float:
    """Bytes per floating element at `wire_format`, with the int8 tier's
    per-block f32 scale."""
    _check(wire_format)
    size = WIRE_ITEMSIZE[wire_format]
    if wire_format == "int8":
        size += 4.0 / int8_block
    return size


def transfer_bytes(tree, *, wire_format: str = "bf16", int8_block: int = 256) -> int:
    """Wire bytes of one global exchange of `tree`. Floating leaves cross
    at the tier's itemsize ("f32" is the identity tier: a bf16 leaf still
    crosses at 2 bytes); int8 scales are counted as the fused codec makes
    them, one block grid per dtype arena (blocks span leaf boundaries),
    rounded up once per arena. Other leaves cross at their own dtype."""
    _check(wire_format)
    total = 0.0
    arena_elems: dict = {}
    for x in leaves(tree):
        if not x.is_floating_point():
            total += x.numel() * x.element_size()
        elif wire_format == "int8":
            key = dtype_name(x.dtype)
            arena_elems[key] = arena_elems.get(key, 0) + x.numel()
        elif wire_format == "f32":
            total += x.numel() * x.element_size()
        else:
            total += x.numel() * wire_itemsize(wire_format)
    for n in arena_elems.values():
        total += n + 4 * (-(-n // int8_block))
    return int(math.ceil(total))
