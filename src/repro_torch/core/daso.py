"""DASO core for one process (`repro/core/daso.py`).

Every parameter leaf carries a leading replica axis of size R, one row per
node of the paper (a pod on the TPU). The per-replica training step runs
row by row (`local_step`; the reference vmaps it), and the outermost level's
exchange runs on the fused flat-buffer arenas (core/flatbuf.py): one
reduction and one elementwise pass per arena, whatever the leaf count.

Step variants, selected per step by the controller (core/schedule.py):

  local         forward/backward + local optimizer step only
  send          local, then inflight <- mean over replicas of params
  receive       merge the stale exchange result by paper Eq. (1),
                x = (2S x_local + P x_stale) / (2S + P), then local
  send_receive  receive, local, send
  blocking      local + synchronous average, bf16 on the wire (warm-up /
                cool-down)
  hard_avg      local + plain parameter average (local-SGD ablation)

A mode token may carry inner-level syncs (``"send+host"``, an N-level
topology, repro_torch/topo): the step functions take them as `inner_syncs`,
(level name, group size) pairs, and run one `level_group_mean` per level
after the local step and before the outer send.

With `DasoConfig.overlap == "one_cycle"` the cycling phase runs the
double-buffered family of `daso_overlap_step` instead (OV_MODES), whose
carry holds a fourth slot, the `pending` snapshot awaiting its exchange.
The macro-cycle executor (core/executor.py) splits an overlap cycle into
`daso_overlap_compute_step` (the local steps, no exchange) and the
exchange and merge, which it runs around them.

Elastic membership: every step builder takes `membership`, a 0/1 mask over
the R replicas (`flatbuf.normalize_membership`), baked into the variant as
the reference bakes it into its compiled step. The exchanges at every level
become means over the active replicas, Eq. (1) runs with the effective
world P_eff = P * n_active / R, a dropped replica's rows are frozen
(`freeze_inactive`), and the reported loss averages the active replicas.
With every replica active (None) each step gives the numbers of a run
without membership, bit for bit.

The exchange math runs through the hand-written kernels: Eq. (1) through
K2, the bf16 wire cast through K3, the int8 tier through K5 / K6
(`kernels/ops.py`, which takes their plain versions for CPU tensors). The
inner-level group mean is plain torch, as the reference's is jnp: on the
f32 wire it launches no kernel, on the bf16 wire its cast is K3.

`DasoConfig.exchange_impl = "per_leaf"` runs the outermost exchange leaf by
leaf instead (`replica_mean_per_leaf`, `global_receive_per_leaf`; f32 and
bf16 wires): one K3 launch per floating leaf on the bf16 wire, one K2 launch
per floating leaf of a merge, and across processes one gather per leaf.
Elementwise, it gives the fused exchange's numbers bit for bit. A leaf that
is not contiguous (a view of a merged or group-synced arena, a mean
broadcast back over the replicas) is copied before its launch or gather,
as `flatbuf.pack` copies the whole arena; `kernels/ops.py::contiguous`
counts those bytes. Integer leaves keep the fused rule (the mean in f32, rounded back),
where the reference's per-leaf mean gives 0. The inner-level group mean
stays fused: the reference has no per-leaf one.

Across processes (`launch/distributed.py::ProcessPlacement`): every builder
and cross-row operation takes `placement` (None: the one-process path as
before). A placed carry holds this process's replica rows; per-row work
(the local step, Eq. (1), the codecs, freezing) runs on them with the
process's entries of the membership mask, and every reduction over
replicas first gathers the wire payload of every row
(`ProcessPlacement.gather_rows`) and then runs the chain of adds of the
one-process path, in replica order, so the numbers are the one-process
run's bit for bit. Inner groups that lie inside one process gather
nothing. The cross-replica loss and aux means are left to the cycle's fetch
(`reduce_step_metrics`), so no step issues a collective for its metrics.

No step writes in place into a tensor it was given (only into outputs it
allocated), so carries may share tensors, as the reference's immutable
arrays do.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import flatbuf
from repro_torch.kernels import ops
from repro_torch.kernels.ref import eq1_merge_ref
from repro_torch.optim.optimizers import Optimizer
from repro_torch.tree import flatten, leaves, tree_map, unflatten

EXCHANGE_IMPLS = ("fused", "per_leaf")
OVERLAP_MODES = ("off", "one_cycle")


@dataclass(frozen=True)
class DasoConfig:
    n_replicas: int              # R: paper "nodes"
    global_world: int            # P in Eq. (1): GPUs in the global network
    b_max: int = 4               # paper: max batches between global syncs
    warmup_steps: int = 0
    cooldown_steps: int = 0
    total_steps: int = 0
    compress_blocking: bool = True
    # beyond the paper: bf16 on the wire in the cycling phase as well
    compress_nonblocking: bool = False
    plateau_patience: int = 5
    plateau_threshold: float = 1e-3
    # None derives bf16 / f32 per phase from the compress_* flags
    wire_format: Optional[str] = None
    exchange_impl: str = "fused"
    # every reduction of the port is the order-fixed chain of adds already
    # (flatbuf.masked_axis0_mean), so both values give the same numbers
    deterministic_reduce: bool = False
    # The exchange math always runs through the kernels (K2 to K6). The
    # reference defaults to False so the SPMD partitioner can shard a mesh
    # arena; the port's arenas are single-device, the case its docstring
    # names for True, so True is the only value.
    exchange_kernels: bool = True
    int8_block: int = 256
    overlap: str = "off"

    def __post_init__(self):
        if not self.exchange_kernels:
            raise ValueError("exchange_kernels=False: the port has one exchange "
                             "path, through the kernels (their plain versions "
                             "for CPU tensors)")
        if self.wire_format is not None:
            flatbuf._check_wire_format(self.wire_format)
        if self.overlap not in OVERLAP_MODES:
            raise ValueError(f"unknown overlap mode {self.overlap!r}; "
                             f"expected one of {OVERLAP_MODES}")
        if self.exchange_impl not in EXCHANGE_IMPLS:
            raise ValueError(f"unknown exchange_impl {self.exchange_impl!r}; "
                             f"expected one of {EXCHANGE_IMPLS}")
        if self.wire_format == "int8" and self.exchange_impl == "per_leaf":
            raise ValueError("int8 wire format requires the fused arena "
                             "exchange (exchange_impl='fused')")

    def wire_format_for(self, *, blocking: bool) -> str:
        """The wire tier of a global exchange: `wire_format` if set, else
        bf16 / f32 from the phase's compress flag."""
        if self.wire_format is not None:
            return self.wire_format
        flag = self.compress_blocking if blocking else self.compress_nonblocking
        return "bf16" if flag else "f32"


# -- replica-axis helpers ------------------------------------------------------

def replicate_params(params, n_replicas: int):
    """Each leaf broadcast to (R, ...): a view, as nothing is written in
    place."""
    return tree_map(lambda p: p.unsqueeze(0).expand((n_replicas,) + p.shape), params)


def dereplicate_params(params, index: int = 0):
    return tree_map(lambda p: p[index], params)


def _arena_mean(arena, wire_format: str, *, int8_block: int = 256, mask=None,
                placement=None):
    """Mean over the replica axis of one arena, as a (1, N) tensor in the
    arena's dtype (`repro/core/daso.py:179-216`). A floating arena is cast
    to the wire dtype first and reduced in it; on the int8 tier each
    replica's row goes through K5 -> K6 (what a transfer of int8 values and
    scales delivers, rounded to nearest: the step variants take no random
    bits, as in the reference) and the mean runs over the dequantized
    arena. `mask` (`flatbuf.normalize_membership`) makes it the mean over
    the active replicas. The caller hands the arena over: it is freed once
    the wire payload is encoded, and the payload once it is decoded.
    `placement`: `arena` holds this process's rows; the payload of every
    row is gathered before the decode and the mean (`mask` stays global)."""
    dtype = arena.dtype
    if not arena.is_floating_point():
        # integer leaves: mean in f32, rounded back (the ints gathered)
        if placement is not None:
            arena = placement.gather_rows(arena)
        return torch.round(flatbuf.masked_axis0_mean(arena.float(), mask)).to(dtype)
    w = flatbuf.encode_wire(arena, wire_format, int8_block=int8_block)
    del arena
    if wire_format != "int8":
        return flatbuf.masked_axis0_mean(w, mask, placement).to(dtype)
    # the int8 values and scales cross, then every row is decoded
    if placement is not None:
        w = placement.gather_rows(w)
    w = flatbuf.decode_wire(w, "int8", dtype, int8_block=int8_block)
    return flatbuf.masked_axis0_mean(w, mask).to(dtype)


def _leaf_mean(x, wire_format: str, mask, placement):
    """One leaf's mean over the replica axis as a (1, ...) tensor in its
    dtype: the fused `_arena_mean` on the f32 / bf16 wire, for one leaf. A
    floating leaf is cast through K3 on the bf16 wire; under `placement`
    its payload is gathered (one collective per leaf). An integer leaf takes
    the fused rule: the ints gathered, the mean in f32, rounded back."""
    dtype = x.dtype
    if not x.is_floating_point():
        if placement is not None:
            x = placement.gather_rows(ops.contiguous(x))
        return torch.round(flatbuf.masked_axis0_mean(x.float(), mask)).to(dtype)
    if wire_format == "bf16" or placement is not None:
        x = ops.contiguous(x)
    w = flatbuf.encode_wire(x, wire_format)
    return flatbuf.masked_axis0_mean(w, mask, placement).to(dtype)


def replica_mean_per_leaf(tree, *, wire_format: str = "f32", mask=None,
                          placement=None):
    """The per-leaf exchange (`repro/core/daso.py::replica_mean_per_leaf`):
    one reduction per leaf, each broadcast back over the replica axis (this
    process's rows, under `placement`), f32 and bf16 wires only. Bit for bit
    the fused `replica_mean`."""
    if wire_format not in ("f32", "bf16"):
        raise ValueError("int8 wire format requires the fused arena "
                         "exchange (impl='fused')")

    def leaf(x):
        return _leaf_mean(x, wire_format, mask, placement).expand(x.shape)

    return tree_map(leaf, tree)


def _check_impl(impl: str) -> None:
    if impl not in EXCHANGE_IMPLS:
        raise ValueError(f"unknown exchange impl {impl!r}; expected one of "
                         f"{EXCHANGE_IMPLS}")


def replica_mean(tree, *, wire_format: str = "f32", impl: str = "fused",
                 int8_block: int = 256, mask=None, placement=None):
    """Mean over the leading replica axis, broadcast back to (R, ...): one
    reduction per arena, with the wire tier applied to the whole arena
    (`impl="per_leaf"`: one per leaf, `replica_mean_per_leaf`). `mask` (a
    normalized membership tuple, or None for all active) takes the mean
    over the active replicas only. Under `placement` the tree holds this
    process's rows, and the mean comes back broadcast to them."""
    flatbuf._check_wire_format(wire_format)
    _check_impl(impl)
    if impl == "per_leaf":
        return replica_mean_per_leaf(tree, wire_format=wire_format, mask=mask,
                                     placement=placement)
    layout = flatbuf.build_layout(tree, batch_dims=1)
    arenas = flatbuf.pack(tree, layout)
    means = {k: _arena_mean(arenas.pop(k), wire_format, int8_block=int8_block,
                            mask=mask, placement=placement)
             for k in list(arenas)}
    r = layout.batch_shape[0]
    return tree_map(lambda m: m.expand((r,) + m.shape[1:]),
                    flatbuf.unpack(means, layout))


def normalize_group_perm(perm, n_replicas: int):
    """Validate and canonicalize a replica regrouping permutation: a tuple
    permutation of ``range(n_replicas)`` mapping group slot -> replica
    index (slot i holds replica perm[i], so consecutive slots share an
    inner group). The identity normalizes to None, the unpermuted path."""
    if perm is None:
        return None
    perm = tuple(int(i) for i in perm)
    if sorted(perm) != list(range(n_replicas)):
        raise ValueError(f"group permutation {perm!r} is not a permutation "
                         f"of range({n_replicas})")
    return None if perm == tuple(range(n_replicas)) else perm


def _index(rows, device) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.long, device=device)


def _arena_group_mean(slot: list, group_size: int, perm=None, mask=None,
                      n_replicas=None):
    """Mean over replica groups of `group_size` consecutive slots of the
    arena in `slot` (a one-element list, emptied: the arena is freed once
    the group sums exist), back in replica order as an (R, N) tensor of the
    arena's dtype. Slot i holds replica i, or perm[i] under a regrouping:
    the reference's `_arena_group_mean` and `_permuted_group_mean`
    (`repro/core/daso.py:269`, `:329`) in one. Each group's rows are added
    as a chain in slot order in the arena's dtype, then multiplied by 1/g
    rounded to that dtype: `flatbuf.masked_axis0_mean` per group.
    `group_size == R` is that whole-axis mean, broadcast as a view (a
    whole-world group ignores the permutation); R is `n_replicas` when the
    arena holds a process's block of rows (the groups the block holds),
    else the arena's own row count.

    `mask` (a normalized membership tuple, by replica) weights each group
    by its active rows: a dropped replica's row is multiplied by 0 before
    the sum, and the group's scale is 1 / max(1, its active count) rounded
    to the arena's dtype (a group with no active row divides by 1; its rows
    are frozen ghosts that `freeze_inactive` keeps). The mask travels with
    its rows under a regrouping."""
    arena = slot.pop()
    r = arena.shape[0]
    if group_size == (n_replicas or r):
        return flatbuf.masked_axis0_mean(arena, mask).expand(arena.shape)
    if r % group_size:
        raise ValueError(f"replica axis {r} not divisible by group size "
                         f"{group_size}")
    g = group_size
    slots = perm or tuple(range(r))
    # member i of every group: rows i, g + i, ... (a strided view), or the
    # rows the permutation puts in those slots
    members = [arena[i::g] if perm is None else
               arena.index_select(0, _index(slots[i::g], arena.device))
               for i in range(g)]
    del arena
    if mask is None:
        scale = float(torch.tensor(1.0 / g, dtype=members[0].dtype))
    else:
        for i in range(g):
            col = [mask[rep] for rep in slots[i::g]]
            if not all(col):
                members[i] = members[i] * flatbuf.membership_col(
                    col, members[i].dtype, members[i].dim(), members[i].device)
        counts = [max(1.0, sum(mask[rep] for rep in slots[j * g:(j + 1) * g]))
                  for j in range(r // g)]
        scale = torch.tensor([1.0 / c for c in counts], dtype=members[0].dtype,
                             device=members[0].device)[:, None]
    s = flatbuf.chain_axis0_sum(members)
    del members
    if mask is not None and g > 1:
        # a sum of signed zeros is +0, as flatbuf.masked_axis0_mean's (the
        # reference's reduce over a group of one is the row itself)
        s = s + 0.0
    m = s * scale
    del s
    # replica rep sits in slot slots.index(rep), of group slot // g
    group_of = [slots.index(rep) // g for rep in range(r)]
    return m.index_select(0, _index(group_of, m.device))


def level_group_mean(tree, group_size: int, *, wire_format: str = "f32",
                     mask=None, perm=None, placement=None):
    """Synchronous parameter average over replica groups of `group_size`:
    the sync of one intermediate topology level
    (`repro/core/daso.py::level_group_mean`). group_size is the product of
    the replica-level fanouts up to the syncing level, so each group is the
    replicas inside one unit of that level (inner levels vary fastest in
    the replica index).

    One group reduction per arena, whatever the leaf count. `wire_format`
    is the level's transfer dtype: "f32" (intermediate links are fast) or
    "bf16" (the arena cast through K3, reduced in bf16); int8 is for the
    outermost exchange only. Integer arenas take the mean in f32, rounded
    back. `group_size == R` is the full replica mean. `perm`
    (`normalize_group_perm`) regroups the replicas first; each group mean
    keeps its group's sum, so the global mean is the same under any
    permutation. The reference's `deterministic` tier is the chain of adds
    that this reduction always is (both of its tiers give these numbers on
    the CPU). `mask` (a normalized membership tuple) weights each group by
    its active replicas (`_arena_group_mean`).

    `placement`: the tree holds this process's rows. When every group lies
    inside the process (`ProcessPlacement.holds_groups`) the groups are
    reduced here with the process's entries of `mask`, and nothing is
    gathered; otherwise each arena's wire payload is gathered, every group
    is reduced as in one process, and this process's rows are kept."""
    if wire_format not in ("f32", "bf16"):
        raise ValueError("level_group_mean supports wire_format 'f32' | "
                         f"'bf16', got {wire_format!r} (the int8 tier is "
                         "for the outermost exchange)")
    layout = flatbuf.build_layout(tree, batch_dims=1)
    arenas = flatbuf.pack(tree, layout)
    r = layout.batch_shape[0] if placement is None else placement.n_replicas
    perm = normalize_group_perm(perm, r)
    cross = placement is not None and not placement.holds_groups(group_size, perm)
    if placement is not None and not cross:
        mask = placement.local_mask(mask)
    out = {}
    for k in list(arenas):
        w = [arenas.pop(k)]
        dtype = w[0].dtype
        if dtype.is_floating_point and wire_format == "bf16":
            w.append(flatbuf.encode_wire(w.pop(), "bf16"))
        if cross:
            w.append(placement.gather_rows(w.pop()))
        if not dtype.is_floating_point:
            w.append(w.pop().float())
        m = _arena_group_mean(w, group_size, perm, mask, n_replicas=r)
        if cross:
            m = m[placement.rows.start:placement.rows.stop]
        out[k] = (torch.round(m) if not dtype.is_floating_point else m).to(dtype)
    return flatbuf.unpack(out, layout)


# -- elastic membership --------------------------------------------------------

def freeze_inactive(new_tree, old_tree, mask):
    """Row by row: an active replica's rows come from `new_tree`, a dropped
    one's from `old_tree` (`repro/core/daso.py::freeze_inactive`). A dropped
    replica's row is a ghost of the gone node; freezing it keeps it from
    drifting, so a rejoin's reseed is the only write to it. mask=None (all
    active) is the identity: `new_tree` itself is returned."""
    if mask is None:
        return new_tree

    def leaf(n, o):
        keep = flatbuf.membership_col(mask, torch.bool, n.dim(), n.device)
        return torch.where(keep, n, o)

    return tree_map(leaf, new_tree, old_tree)


# -- DASO primitive operations -------------------------------------------------

def global_send(params, *, wire_format: str = "f32", impl: str = "fused",
                int8_block: int = 256, mask=None, placement=None):
    """Snapshot + start the global exchange: the in-flight buffer is the
    replica mean of the current params (over the active replicas under
    `mask`), one copy per replica (per row of this process's, under
    `placement`)."""
    return replica_mean(params, wire_format=wire_format, impl=impl,
                        int8_block=int8_block, mask=mask, placement=placement)


def global_receive_per_leaf(params, inflight, *, staleness: int, global_world,
                            extra_staleness: int = 0, mask=None):
    """Eq. (1) leaf by leaf (`repro/core/daso.py::global_receive_per_leaf`):
    ONE K2 launch per floating leaf, on contiguous copies of leaves that are
    views; a dropped replica's rows keep `params` (`mask`, the entries of
    the rows given). Bit for bit the fused merge."""
    kw = dict(staleness=staleness, global_world=global_world,
              extra_staleness=extra_staleness)
    dead = [] if mask is None else [i for i, m in enumerate(mask) if not m]

    def leaf(a, b):
        if not a.is_floating_point():
            out = eq1_merge_ref(a, b, **kw)
        else:
            out = ops.eq1_merge(ops.contiguous(a), ops.contiguous(b), **kw)
        for r in dead:
            out[r].copy_(a[r])
        return out

    return tree_map(leaf, params, inflight)


def global_receive(params, inflight, *, staleness: int, global_world,
                   impl: str = "fused", extra_staleness: int = 0, mask=None,
                   placement=None):
    """Paper Eq. (1): merge the stale global average into the local params.
    S = batches waited, P = the global world size: a float under elastic
    membership, the surviving world's P_eff = P * n_active / R. A dropped
    replica's rows keep `params` (`mask`).

    Both trees are packed and each floating arena is merged by ONE K2
    launch; the leaves of the result are views of the merged arena, into
    which a dropped replica's row is copied back from the packed params
    (`impl="per_leaf"`: one launch per leaf, `global_receive_per_leaf`).
    Row by row, so under `placement` it runs on this process's rows and
    gathers nothing."""
    _check_impl(impl)
    kw = dict(staleness=staleness, global_world=global_world,
              extra_staleness=extra_staleness)
    if placement is not None:
        mask = placement.local_mask(mask)
    if impl == "per_leaf":
        return global_receive_per_leaf(params, inflight, mask=mask, **kw)
    dead = [] if mask is None else [i for i, m in enumerate(mask) if not m]
    layout = flatbuf.build_layout(params, batch_dims=1)
    locals_ = flatbuf.pack(params, layout)
    stales = flatbuf.pack(inflight, layout)
    out = {}
    for k in list(locals_):
        a, b = locals_.pop(k), stales.pop(k)
        out[k] = (ops.eq1_merge(a, b, **kw) if a.is_floating_point()
                  else eq1_merge_ref(a, b, **kw))
        for r in dead:
            out[k][r].copy_(a[r])
        del a, b
    return flatbuf.unpack(out, layout)


def blocking_sync(params, *, wire_format: str = "bf16", impl: str = "fused",
                  int8_block: int = 256, mask=None, placement=None):
    """Synchronous global average (warm-up / cool-down), with the paper's
    16-bit transfer packaging (or the tier in `wire_format`). `mask` takes
    the average over the active replicas and keeps the dropped rows."""
    synced = replica_mean(params, wire_format=wire_format, impl=impl,
                          int8_block=int8_block, mask=mask, placement=placement)
    return freeze_inactive(synced, params, _local(mask, placement))


def _local(mask, placement):
    """The entries of `mask` for the rows this process holds."""
    return mask if placement is None else placement.local_mask(mask)


def replica_divergence(params, placement=None) -> torch.Tensor:
    """Max abs deviation of any replica from the replica mean (diagnostic),
    a 0-dim f32 tensor. Under `placement` every leaf's rows are gathered
    first (a diagnostic fetch)."""
    if placement is not None:
        params = tree_map(lambda x: placement.gather_rows(x, kind="fetch"), params)

    def leaf(x):
        x = x.float()
        return torch.max(torch.abs(x - x.mean(dim=0, keepdim=True)))
    return functools.reduce(torch.maximum, [leaf(x) for x in leaves(params)])


# -- assembled train step ------------------------------------------------------

def value_and_grad(loss_fn: Callable):
    """(params, batch) -> ((loss, aux), grads) by reverse mode through
    torch.autograd on detached copies of the leaves; loss, aux (a tree, e.g.
    the ResNet loss's nested "bn_state") and grads come out detached.
    (torch.func's transforms flatten their inputs and outputs with
    recursive closures that keep the gradients in reference cycles until
    the garbage collector runs: at full width several GB per step on the
    card.)"""
    def fn(params, batch):
        flat, treedef = flatten(params)
        xs = [p.detach().requires_grad_() for p in flat]
        with torch.enable_grad():
            loss, aux = loss_fn(unflatten(treedef, xs), batch)
            grads = torch.autograd.grad(loss, xs, allow_unused=True,
                                        materialize_grads=True)
        aux = tree_map(torch.Tensor.detach, aux)
        return (loss.detach(), aux), unflatten(treedef, list(grads))

    return fn


def microbatched_value_and_grad(loss_fn: Callable, n_micro: int):
    """Gradient accumulation (`repro/core/daso.py:516-551`): the batch split
    along its leading axis into n_micro chunks, one forward / backward per
    chunk in order, so one chunk's activations are live at a time. As the
    reference's scan: loss, aux and grads start at zeros, the chunks' values
    are added in chunk order, and the sums are scaled by 1 / n_micro, cast
    back to each floating leaf's dtype (integer leaves stay sums).

    Every batch leaf is chunked, as in the reference (`repro/core/daso.py:
    526-528`): a vlm / audio batch's "prefix_embeds" (B, P, D) and its
    labels over the spliced length (B, P + S) split along B with the
    tokens. A ResNet batch's "bn_state" would be cut across channels: the
    reference then fails inside batch norm, and the port refuses such a
    batch with a ValueError."""
    vg = value_and_grad(loss_fn)
    if n_micro <= 1:
        return vg

    def scale(tree, inv):
        return tree_map(lambda x: (x * inv).to(x.dtype) if x.is_floating_point() else x,
                        tree)

    def fn(params, batch):
        if isinstance(batch, dict) and "bn_state" in batch:
            raise ValueError(
                f"n_micro={n_micro} chunks every batch leaf along its leading axis, "
                "bn_state included (as the reference does), which cuts the running "
                "statistics across channels: a ResNet batch trains with n_micro=1")
        acc = None
        for i in range(n_micro):
            def chunk(x):
                return x.reshape((n_micro, x.shape[0] // n_micro) + x.shape[1:])[i]
            out = vg(params, tree_map(chunk, batch))
            if acc is None:
                acc = tree_map(torch.zeros_like, out)
            acc = tree_map(torch.add, acc, out)
            del out
        ((loss, aux), grads), inv = acc, 1.0 / n_micro
        return (loss * inv, scale(aux, inv)), scale(grads, inv)

    return fn


def local_step(loss_fn: Callable, optimizer: Optimizer, n_micro: int = 1,
               mask=None):
    """step(params_R, opt_R, batch_R, lr) -> (params, opt, loss_R, aux_R):
    gradient and optimizer update of every replica (the reference's
    `jax.vmap` over the replica axis, `repro/core/daso.py:554-571`).
    loss_fn(params, batch) -> (loss, aux); `n_micro` splits each replica's
    batch for gradient accumulation (`microbatched_value_and_grad`).

    A loop over the R replica rows: each row's gradient and update are
    computed on its own and written into (R, ...) outputs allocated at the
    first row, so one replica's activations and gradients are live at a
    time. Under `mask` a dropped replica's rows of params and optimizer
    state are written as they came in (the reference's `freeze_inactive`
    after its vmapped step), its loss and aux as computed."""
    vg = microbatched_value_and_grad(loss_fn, n_micro)

    def step(params, opt_state, batch, lr):
        n_rep = leaves(params)[0].shape[0]
        bufs, treedef = None, None
        for r in range(n_rep):
            def row(x):
                return x[r]
            p_r, o_r = tree_map(row, params), tree_map(row, opt_state)
            (loss, aux), grads = vg(p_r, tree_map(row, batch))
            new_p, new_o = optimizer.update(grads, o_r, p_r, lr)
            del grads
            if mask is not None and not mask[r]:
                new_p, new_o = p_r, o_r
            out, treedef = flatten((new_p, new_o, loss, aux))
            del new_p, new_o
            if bufs is None:
                bufs = [x.new_empty((n_rep,) + x.shape) for x in out]
            for buf, x in zip(bufs, out):
                buf[r].copy_(x)
            del out
        return unflatten(treedef, bufs)

    return step


MODES = ("local", "send", "receive", "send_receive", "blocking", "hard_avg")

# Outermost-level actions of the double-buffered overlap schedule
# (DasoConfig.overlap == "one_cycle"), in place of send / receive in the
# cycling phase:
#   ov_start  local step, then pending <- params (first cycling step, and
#             the restart after a blocking phase: nothing in flight yet)
#   ov_sync   local step, then inflight <- mean(pending_old) [the one outer
#             exchange], params <- Eq. (1) merge, pending <- params
OV_MODES = ("local", "ov_start", "ov_sync", "blocking")


# key prefix of an aux metric's per-replica values in a placed step's
# metrics, reduced at the cycle's fetch (`reduce_step_metrics`)
AUX_ROWS = "rows/"


def _cross_replica_loss(cfg: DasoConfig, mask, n_active: int,
                        loss_r: torch.Tensor, *, axis: int = 0) -> torch.Tensor:
    """The scalar loss the plateau controller consumes: the mean of the
    per-replica losses over the active replicas, in the reduction order of
    the reference's configured tier (with a mask: the chain of the masked
    losses over n_active). `axis` is the replica axis: 0 for one step's
    (R,) losses, 1 for the (L, R) losses of an overlap cycle's L steps,
    whose merge defers the reduction out of the compute steps; it reduces
    row by row, so each step's loss is the one the step itself would give,
    bit for bit."""
    if axis == 1:
        return torch.stack([_cross_replica_loss(cfg, mask, n_active, row)
                            for row in loss_r])
    if mask is not None:
        w = loss_r * flatbuf.membership_col(mask, loss_r.dtype, loss_r.dim(),
                                            loss_r.device)
        return flatbuf.chain_axis0_sum(w) / n_active
    if cfg.deterministic_reduce:
        return flatbuf.chain_axis0_sum(loss_r) / cfg.n_replicas
    return torch.mean(loss_r, dim=0)


def _membership_of(cfg: DasoConfig, membership):
    """(mask, n_active, P_eff) of a step variant: the normalized mask, the
    active count and Eq. (1)'s world, P * n_active / R under a mask."""
    mask = flatbuf.normalize_membership(membership, cfg.n_replicas)
    if mask is None:
        return None, cfg.n_replicas, cfg.global_world
    n_active = int(sum(mask))
    return mask, n_active, cfg.global_world * n_active / cfg.n_replicas


def daso_train_step(loss_fn: Callable, optimizer: Optimizer, cfg: DasoConfig,
                    *, mode: str, staleness: int = 1, n_micro: int = 1,
                    membership=None,
                    inner_syncs: Tuple[Tuple[str, int], ...] = (),
                    group_perm=None, placement=None):
    """One step variant:
    step(params_R, opt_R, inflight, batch_R, lr) -> (params_R, opt_R,
    inflight, metrics). `mode` is the outermost level's action (MODES).

    `inner_syncs` is the step's intermediate-level phase vector: a (level
    name, group size) pair, innermost first, for every topology level whose
    period elapses this step. Each adds one `level_group_mean` over that
    level's replica groups after the local step and before the outer send,
    so an outer exchange ships tier-synced values. `group_perm`
    (`normalize_group_perm`) regroups the replicas for every inner sync.

    `membership` (a 0/1 mask over the R replicas) is baked into the
    variant: every exchange is a mean over the active replicas, Eq. (1)
    runs with P_eff = P * n_active / R, a dropped replica's params and
    optimizer rows stay frozen, and the loss averages the active
    replicas. `placement` runs the variant on this process's rows (the
    module docstring). The outer exchange runs fused or leaf by leaf, as
    `cfg.exchange_impl` says."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    mask, n_active, p_eff = _membership_of(cfg, membership)
    inner = _inner_sync_fn(cfg, inner_syncs, group_perm, mask, placement)
    lstep = local_step(loss_fn, optimizer, n_micro, _local(mask, placement))
    blk = cfg.int8_block
    px = dict(mask=mask, placement=placement, impl=cfg.exchange_impl)

    def step(params, opt_state, inflight, batch, lr):
        if mode in ("receive", "send_receive"):
            params = global_receive(params, inflight, staleness=staleness,
                                    global_world=p_eff, **px)
        params, opt_state, loss_r, aux_r = lstep(params, opt_state, batch, lr)
        params = inner(params)
        if mode in ("send", "send_receive"):
            inflight = global_send(params, wire_format=cfg.wire_format_for(blocking=False),
                                   int8_block=blk, **px)
        elif mode == "blocking":
            params = blocking_sync(params, wire_format=cfg.wire_format_for(blocking=True),
                                   int8_block=blk, **px)
        elif mode == "hard_avg":
            params = freeze_inactive(replica_mean(params, **px), params,
                                     _local(mask, placement))
        return params, opt_state, inflight, _step_metrics(cfg, mask, n_active,
                                                          loss_r, aux_r, placement)

    return step


def daso_overlap_step(loss_fn: Callable, optimizer: Optimizer, cfg: DasoConfig,
                      *, mode: str, staleness: int = 1, extra_staleness: int = 0,
                      n_micro: int = 1, membership=None,
                      inner_syncs: Tuple[Tuple[str, int], ...] = (),
                      group_perm=None, placement=None):
    """One step variant of the double-buffered overlap schedule
    (`repro/core/daso.py::daso_overlap_step`, one process):
    step(params_R, opt_R, inflight, pending, batch_R, lr) -> (params_R,
    opt_R, inflight, pending, metrics). `mode` is one of OV_MODES:

      local     local step; both buffers pass through
      ov_start  local step, then pending <- params
      ov_sync   local step, then inflight <- mean(pending_old) at the
                cycling phase's wire tier, params <- Eq. (1) through K2
                with S = staleness + extra_staleness (the snapshot's true
                age), pending <- the merged params
      blocking  local step + synchronous average; buffers pass through (the
                next cycling phase restarts with ov_start)

    The merge lands after the step's local update, where off-mode
    `receive` merges before it: the exchange result arrives at the cycle's
    end. Inner syncs run between the local update and the buffers' update,
    as in `daso_train_step`, and `membership` and `cfg.exchange_impl`
    are baked in as there."""
    if mode not in OV_MODES:
        raise ValueError(f"unknown overlap mode {mode!r}; expected one of {OV_MODES}")
    mask, n_active, p_eff = _membership_of(cfg, membership)
    inner = _inner_sync_fn(cfg, inner_syncs, group_perm, mask, placement)
    lstep = local_step(loss_fn, optimizer, n_micro, _local(mask, placement))
    blk = cfg.int8_block
    px = dict(mask=mask, placement=placement, impl=cfg.exchange_impl)

    def step(params, opt_state, inflight, pending, batch, lr):
        params, opt_state, loss_r, aux_r = lstep(params, opt_state, batch, lr)
        params = inner(params)
        if mode == "ov_start":
            pending = params
        elif mode == "ov_sync":
            inflight = global_send(pending, wire_format=cfg.wire_format_for(blocking=False),
                                   int8_block=blk, **px)
            params = global_receive(params, inflight, staleness=staleness,
                                    extra_staleness=extra_staleness,
                                    global_world=p_eff, **px)
            pending = params
        elif mode == "blocking":
            params = blocking_sync(params, wire_format=cfg.wire_format_for(blocking=True),
                                   int8_block=blk, **px)
        return params, opt_state, inflight, pending, _step_metrics(
            cfg, mask, n_active, loss_r, aux_r, placement)

    return step


def daso_overlap_compute_step(loss_fn: Callable, optimizer: Optimizer,
                              cfg: DasoConfig, *, n_micro: int = 1,
                              membership=None,
                              inner_syncs: Tuple[Tuple[str, int], ...] = (),
                              group_perm=None, placement=None):
    """The compute half of an overlap cycle on the macro-cycle executor
    (`repro/core/daso.py::daso_overlap_compute_step`):
    step(params_R, opt_R, batch_R, lr) -> (params_R, opt_R, metrics).

    A local step and no outer exchange, so it can run while the cycle's
    exchange is in flight: the cross-replica loss is deferred to the merge
    (`_cross_replica_loss` with axis=1), and the aux metrics, whose means
    reduce over the replicas, are dropped. Inner-level syncs stay: they run
    on the current stream beside the exchange, and read only the params
    this step made (the exchange reads the pending snapshot, which no step
    writes). `membership` freezes the dropped rows as in `daso_train_step`.
    It has no outer exchange, so `cfg.exchange_impl` does not reach it: the
    inner syncs are fused under either impl, as in the reference."""
    mask = flatbuf.normalize_membership(membership, cfg.n_replicas)
    inner = _inner_sync_fn(cfg, inner_syncs, group_perm, mask, placement)
    lstep = local_step(loss_fn, optimizer, n_micro, _local(mask, placement))

    def step(params, opt_state, batch, lr):
        params, opt_state, loss_r, _aux_r = lstep(params, opt_state, batch, lr)
        return inner(params), opt_state, {"loss_per_replica": loss_r}

    return step


def _inner_sync_fn(cfg: DasoConfig, inner_syncs, group_perm, mask=None,
                   placement=None) -> Callable:
    """params -> params after one `level_group_mean` per inner sync, in
    order, the dropped rows frozen under `mask` (the identity without inner
    syncs). Each group size must lie in 2..R."""
    for name, g in inner_syncs:
        if not 1 < g <= cfg.n_replicas:
            raise ValueError(f"inner sync {name!r}: group size {g} outside "
                             f"2..{cfg.n_replicas}")
    perm = normalize_group_perm(group_perm, cfg.n_replicas)

    def sync(params):
        for _name, g in inner_syncs:
            params = freeze_inactive(level_group_mean(params, g, mask=mask, perm=perm,
                                                      placement=placement),
                                     params, _local(mask, placement))
        return params

    return sync


def _aux_mean(cfg: DasoConfig, mask, n_active: int, v) -> torch.Tensor:
    """An aux metric's mean over the replicas (the active ones, for a
    per-replica vector under a mask)."""
    if mask is not None and v.dim() == 1 and v.shape[0] == cfg.n_replicas:
        w = v * flatbuf.membership_col(mask, v.dtype, 1, v.device)
        return torch.sum(w) / n_active
    return torch.mean(v)


def _step_metrics(cfg: DasoConfig, mask, n_active: int, loss_r, aux_r,
                  placement=None) -> dict:
    """The loss the controller reads, the per-replica losses, and the mean
    of every aux tensor of rank <= 1 (over the active replicas, for a
    per-replica vector under a mask). Under `placement` only this process's
    per-replica values: the loss and the aux rows (`AUX_ROWS` + name),
    which `reduce_step_metrics` reduces once the cycle's fetch has gathered
    every replica's."""
    if placement is not None:
        metrics = {"loss_per_replica": loss_r}
        for k, v in aux_r.items():
            if isinstance(v, torch.Tensor) and v.dim() == 1:
                metrics[AUX_ROWS + k] = v
        return metrics
    metrics = {"loss": _cross_replica_loss(cfg, mask, n_active, loss_r),
               "loss_per_replica": loss_r}
    for k, v in aux_r.items():
        if isinstance(v, torch.Tensor) and v.dim() <= 1:
            metrics[k] = _aux_mean(cfg, mask, n_active, v)
    return metrics


def reduce_step_metrics(cfg: DasoConfig, mask, n_active: int, metrics: dict) -> dict:
    """A placed cycle's metrics, every replica's rows gathered ((L, R)
    "loss_per_replica" and `AUX_ROWS` entries), reduced step by step as
    `_step_metrics` reduces one step's in one process: the per-step loss
    (L,) and aux means (L,), bit for bit."""
    loss_r = metrics["loss_per_replica"]
    out = {"loss": _cross_replica_loss(cfg, mask, n_active, loss_r, axis=1),
           "loss_per_replica": loss_r}
    for k, v in metrics.items():
        if k.startswith(AUX_ROWS):
            out[k[len(AUX_ROWS):]] = torch.stack(
                [_aux_mean(cfg, mask, n_active, row) for row in v])
    return out


def sync_train_step(loss_fn: Callable, optimizer: Optimizer, n_micro: int = 1):
    """Horovod-analog baseline: flat data parallelism, no replica axis, one
    gradient over the global batch every step."""
    vg = microbatched_value_and_grad(loss_fn, n_micro)

    def step(params, opt_state, batch, lr):
        (loss, aux), grads = vg(params, batch)
        new_params, new_opt = optimizer.update(grads, opt_state, params, lr)
        metrics = {"loss": loss}
        for k, v in aux.items():
            if isinstance(v, torch.Tensor) and v.dim() == 0:
                metrics[k] = v
        return new_params, new_opt, metrics

    return step
