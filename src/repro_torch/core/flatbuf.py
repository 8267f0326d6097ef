"""Flat-buffer parameter arenas for the fused global exchange
(`repro/core/flatbuf.py`).

A tree of tensors is packed into ONE contiguous arena per leaf dtype with a
static offset table, so an exchange is one reduction and one elementwise
pass over one large buffer, whatever the leaf count:

  * leaves are grouped by dtype (one arena per dtype), so `pack` / `unpack`
    is a bit-exact roundtrip;
  * `batch_dims` leading axes (the DASO replica axis R) stay on the arena: a
    leaf (R, *s) fills an (R, prod(s)) slice;
  * leaves are laid out in the JAX package's flatten order (`repro_torch
    .tree`), so an arena of a tree equals the reference's arena of it;
  * `unpack` returns views of the arena: no copy.

Wire codecs (`encode_wire` / `decode_wire`) implement the transfer tiers:
`f32` (identity), `bf16` (the paper's 16-bit packaging) and the
beyond-paper `int8` block-scaled tier (one absmax scale per `int8_block`
elements of a row, optional stochastic rounding). The bf16 casts go through
kernels K3 / K4, the int8 codec through K5 / K6 (`kernels/ops.py`, which
takes their plain versions for CPU tensors).

Stochastic rounding: the reference draws its bits with `jax.random.bits`
from an `rng_key`; threefry is not reproduced here. The port takes the
bits themselves (`bits`, uint32 of the arena's shape) or a
`torch.Generator` that draws them: the same bits give results bit-exact
with the reference's, the same seed does not.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.tree import flatten, unflatten

WIRE_FORMATS = ("f32", "bf16", "int8")


@dataclass(frozen=True)
class LeafSlot:
    """Static placement of one leaf inside its dtype arena."""
    arena: str              # arena key = dtype name, e.g. "float32"
    offset: int             # element offset into the arena's packed axis
    size: int               # number of elements (excluding batch dims)
    shape: Tuple[int, ...]  # per-item shape (excluding batch dims)
    dtype: torch.dtype


@dataclass(frozen=True)
class ArenaLayout:
    """Static offset table of a tree: its treedef, one `LeafSlot` per leaf
    (in flatten order) and the packed size of each arena."""
    treedef: Any
    slots: Tuple[LeafSlot, ...]
    arena_sizes: Dict[str, int]
    batch_shape: Tuple[int, ...]


def dtype_name(dtype: torch.dtype) -> str:
    """The arena key of a dtype, as the reference names it ("float32")."""
    return str(dtype).removeprefix("torch.")


def build_layout(tree, *, batch_dims: int = 0) -> ArenaLayout:
    """The static arena layout of `tree`. All leaves share their first
    `batch_dims` axes (the DASO replica axis uses batch_dims=1)."""
    leaves, treedef = flatten(tree)
    if not leaves:
        raise ValueError("cannot build an arena layout for an empty tree")
    batch_shape = tuple(leaves[0].shape[:batch_dims])
    offsets: Dict[str, int] = {}
    slots = []
    for x in leaves:
        if tuple(x.shape[:batch_dims]) != batch_shape:
            raise ValueError(f"leaf batch shape {tuple(x.shape[:batch_dims])} != "
                             f"{batch_shape}; all leaves must share the leading "
                             f"{batch_dims} axes")
        key = dtype_name(x.dtype)
        shape = tuple(x.shape[batch_dims:])
        size = math.prod(shape)
        off = offsets.get(key, 0)
        slots.append(LeafSlot(arena=key, offset=off, size=size, shape=shape,
                              dtype=x.dtype))
        offsets[key] = off + size
    return ArenaLayout(treedef=treedef, slots=tuple(slots),
                       arena_sizes=dict(offsets), batch_shape=batch_shape)


def pack(tree, layout: ArenaLayout) -> Dict[str, torch.Tensor]:
    """{arena key: (*batch, N) tensor}, one copy of every leaf, bit-exact."""
    leaves, _ = flatten(tree)
    batch = layout.batch_shape
    parts: Dict[str, list] = {}
    for x, slot in zip(leaves, layout.slots):
        parts.setdefault(slot.arena, []).append(x.reshape(batch + (slot.size,)))
    return {k: (v[0].contiguous() if len(v) == 1 else torch.cat(v, dim=len(batch)))
            for k, v in parts.items()}


def unpack(arenas: Dict[str, torch.Tensor], layout: ArenaLayout):
    """Exact inverse of `pack`: each leaf a view into its arena."""
    nb = len(layout.batch_shape)
    leaves = []
    for slot in layout.slots:
        arena = arenas[slot.arena]
        piece = arena.narrow(nb, slot.offset, slot.size)
        leaves.append(piece.view(arena.shape[:nb] + slot.shape))
    return unflatten(layout.treedef, leaves)


def chain_axis0_sum(w) -> torch.Tensor:
    """Order-fixed sum over the leading axis, ``w[0] + w[1] + ...`` in w's
    dtype, a rounding after every add. `w` is a tensor or a sequence of
    tensors of one shape. Across processes its callers gather the rows
    first (`masked_axis0_mean`'s `placement`), so every process adds the
    same rows in the same order."""
    acc = w[0]
    for i in range(1, len(w)):
        acc = acc + w[i]
    return acc


# -- elastic membership --------------------------------------------------------

def normalize_membership(mask, n_replicas: int) -> Optional[Tuple[float, ...]]:
    """An active-replica mask checked against the replica axis and made a
    tuple of 0.0 / 1.0 floats, the static weights a masked exchange bakes
    in (`repro/core/flatbuf.py::normalize_membership`). The all-active mask
    gives None: callers take None as the non-elastic path, whose numbers
    are those of a run without membership, bit for bit."""
    if mask is None:
        return None
    mask = tuple(float(m) for m in mask)
    if len(mask) != n_replicas:
        raise ValueError(f"membership mask has {len(mask)} entries for "
                         f"{n_replicas} replicas")
    if any(m not in (0.0, 1.0) for m in mask):
        raise ValueError(f"membership mask must be 0/1 valued, got {mask}")
    if not any(mask):
        raise ValueError("membership mask has no active replicas")
    if all(m == 1.0 for m in mask):
        return None
    return mask


def membership_col(mask: Tuple[float, ...], dtype, ndim: int,
                   device=None) -> torch.Tensor:
    """The mask as an (R, 1, ..., 1) column of `dtype` that broadcasts
    against a rank-`ndim` tensor with a leading replica axis. Multiplying
    by it zeroes the dropped replicas' rows before a reduction (0 and 1 are
    exact in every wire dtype)."""
    col = torch.tensor(mask, dtype=dtype, device=device)
    return col.reshape((len(mask),) + (1,) * (ndim - 1))


def masked_axis0_mean(arena: torch.Tensor, mask: Optional[Tuple[float, ...]] = None,
                      placement=None) -> torch.Tensor:
    """Mean over the leading replica axis, kept as a (1, ...) tensor, in
    the arena's dtype: the sum of the rows as a chain of adds in replica
    order, times 1/R rounded to the arena's dtype.

    `mask` (`normalize_membership`) weights the mean by membership: each
    dropped replica's row is multiplied by 0 before the sum, as the
    reference multiplies the arena by `membership_col` (so a NaN or an
    infinity in a frozen row reaches the mean in both packages), and the
    scale is 1/n_active. The products are taken row by row, so no second
    full-size arena is allocated; an active row's product by 1 is the row
    itself and is skipped. The sum then takes a + 0: the reference's
    default `lax.reduce` starts from +0, so where every row holds a signed
    zero (a dropped row's 0 * x is -0 for a negative x) its sum is +0 (its
    deterministic chain tier, which the unmasked mean matches, keeps -0).

    Both of the reference's tiers reduce so on the CPU: its default
    `lax.reduce` over axis 0 adds the rows in order, a bf16 arena in bf16
    after every add, and its deterministic tier is this chain
    (`chain_axis0_sum`). A `torch.sum` of a bf16 tensor accumulates in f32
    and differs.

    `placement` (launch/distributed.py::ProcessPlacement): `arena` holds
    this process's rows, and every process's are gathered first (the int8
    tier gathers its payload before the decode instead: core/daso.py)."""
    if placement is not None:
        arena = placement.gather_rows(arena)
    if mask is None:
        scale = float(torch.tensor(1.0 / arena.shape[0], dtype=arena.dtype))
        return (chain_axis0_sum(arena) * scale)[None]
    if len(mask) != arena.shape[0]:
        raise ValueError(f"membership mask has {len(mask)} entries for "
                         f"{arena.shape[0]} replicas")
    rows = [arena[i] if m else arena[i] * 0.0 for i, m in enumerate(mask)]
    scale = float(torch.tensor(1.0 / sum(mask), dtype=arena.dtype))
    return ((chain_axis0_sum(rows) + 0.0) * scale)[None]


# -- wire codecs over an arena -------------------------------------------------

def _check_wire_format(wire_format: str) -> str:
    if wire_format not in WIRE_FORMATS:
        raise ValueError(f"unknown wire_format {wire_format!r}; "
                         f"expected one of {WIRE_FORMATS}")
    return wire_format


def random_bits(shape, generator: torch.Generator) -> torch.Tensor:
    """uint32 bits of `shape` drawn from `generator`, on its device."""
    return torch.randint(0, 2 ** 32, tuple(shape), dtype=torch.int64,
                         generator=generator,
                         device=generator.device).to(torch.uint32)


def encode_wire(arena: torch.Tensor, wire_format: str, *, int8_block: int = 256,
                bits: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
    """The payload that crosses the wire: the arena itself for ``f32``, a
    bf16 copy for ``bf16`` (K3), ``(int8 values, f32 per-block scales)``
    for ``int8`` (K5). `bits` or `generator` select stochastic rounding for
    the int8 tier; with neither it rounds to nearest even."""
    _check_wire_format(wire_format)
    if wire_format == "f32":
        return arena
    if wire_format == "bf16":
        return ops.bf16_pack(arena)
    if generator is not None:
        if bits is not None:
            raise ValueError("encode_wire: pass bits or a generator, not both")
        bits = random_bits(arena.shape, generator)
    return ops.quantize_int8(arena, bits, block=int8_block)


def decode_wire(wire, wire_format: str, out_dtype, *,
                int8_block: int = 256) -> torch.Tensor:
    """A wire payload back in `out_dtype`: K4 for ``bf16``; for ``int8``
    the (values, scales) pair through K6, then cast as the reference does."""
    _check_wire_format(wire_format)
    if wire_format == "f32":
        return wire.to(out_dtype)
    if wire_format == "bf16":
        return ops.bf16_unpack(wire, out_dtype)
    values, scales = wire
    return ops.dequantize_int8(values, scales, block=int8_block).to(out_dtype)


def wire_roundtrip(arena: torch.Tensor, wire_format: str, *, int8_block: int = 256,
                   bits: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """encode -> wire -> decode, back in the arena's own dtype: what a
    one-way transfer does to the values."""
    wire = encode_wire(arena, wire_format, int8_block=int8_block, bits=bits,
                       generator=generator)
    return decode_wire(wire, wire_format, arena.dtype, int8_block=int8_block)


def tree_wire_roundtrip(tree, wire_format: str, *, batch_dims: int = 0,
                        int8_block: int = 256,
                        bits: Optional[Dict[str, torch.Tensor]] = None,
                        generator: Optional[torch.Generator] = None):
    """Pack, roundtrip every floating arena through the wire format, unpack.
    Other arenas cross at their own dtype. `bits` maps an arena key
    ("float32") to that arena's stochastic-rounding bits."""
    layout = build_layout(tree, batch_dims=batch_dims)
    arenas = pack(tree, layout)
    bits = bits or {}
    out = {k: wire_roundtrip(a, wire_format, int8_block=int8_block, bits=bits.get(k),
                             generator=generator) if a.is_floating_point() else a
           for k, a in arenas.items()}
    return unpack(out, layout)
