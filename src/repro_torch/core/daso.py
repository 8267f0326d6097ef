"""DASO core for one process and fixed membership (`repro/core/daso.py`).

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

The exchange math runs through the hand-written kernels: Eq. (1) through
K2, the bf16 wire cast through K3 (`kernels/ops.py`, which takes their
plain versions for CPU tensors). Not ported yet, and raising
NotImplementedError:
the per-leaf exchange (`exchange_impl="per_leaf"`, ROADMAP item 7), the
overlap schedule and the int8 tier (item 12), inner-level syncs (item 13)
and elastic membership (item 15).

No step writes in place into a tensor it was given (only into outputs it
allocated), so carries may share tensors, as the reference's immutable
arrays do.
"""
from __future__ import annotations

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
    # The exchange math always runs through the kernels (K2, K3). The
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
        if self.overlap != "off":
            raise NotImplementedError("the overlap schedule is not ported yet "
                                      "(ROADMAP item 12)")
        if self.exchange_impl not in EXCHANGE_IMPLS:
            raise ValueError(f"unknown exchange_impl {self.exchange_impl!r}; "
                             f"expected one of {EXCHANGE_IMPLS}")
        if self.exchange_impl == "per_leaf":
            raise NotImplementedError("the per-leaf exchange is not ported yet "
                                      "(ROADMAP item 7)")

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


def _arena_mean(arena, wire_format: str):
    """Mean over the replica axis of one arena, as a (1, N) tensor in the
    arena's dtype. A floating arena is cast to the wire dtype first and
    reduced in it (`repro/core/daso.py:209-216`)."""
    if not arena.is_floating_point():
        # integer leaves: mean in f32, rounded back
        return torch.round(flatbuf.masked_axis0_mean(arena.float())).to(arena.dtype)
    w = flatbuf.encode_wire(arena, wire_format)
    return flatbuf.masked_axis0_mean(w).to(arena.dtype)


def replica_mean(tree, *, wire_format: str = "f32"):
    """Mean over the leading replica axis, broadcast back to (R, ...): one
    reduction per arena, with the wire tier applied to the whole arena."""
    flatbuf._check_wire_format(wire_format)
    layout = flatbuf.build_layout(tree, batch_dims=1)
    arenas = flatbuf.pack(tree, layout)
    means = {k: _arena_mean(a, wire_format) for k, a in arenas.items()}
    del arenas
    r = layout.batch_shape[0]
    return tree_map(lambda m: m.expand((r,) + m.shape[1:]),
                    flatbuf.unpack(means, layout))


# -- DASO primitive operations -------------------------------------------------

def global_send(params, *, wire_format: str = "f32"):
    """Snapshot + start the global exchange: the in-flight buffer is the
    replica mean of the current params, one copy per replica."""
    return replica_mean(params, wire_format=wire_format)


def global_receive(params, inflight, *, staleness: int, global_world,
                   extra_staleness: int = 0):
    """Paper Eq. (1): merge the stale global average into the local params.
    S = batches waited, P = the global world size.

    Both trees are packed and each floating arena is merged by ONE K2
    launch; the leaves of the result are views of the merged arena."""
    kw = dict(staleness=staleness, global_world=global_world,
              extra_staleness=extra_staleness)
    layout = flatbuf.build_layout(params, batch_dims=1)
    locals_ = flatbuf.pack(params, layout)
    stales = flatbuf.pack(inflight, layout)
    out = {}
    for k in list(locals_):
        a, b = locals_.pop(k), stales.pop(k)
        out[k] = (ops.eq1_merge(a, b, **kw) if a.is_floating_point()
                  else eq1_merge_ref(a, b, **kw))
        del a, b
    return flatbuf.unpack(out, layout)


def blocking_sync(params, *, wire_format: str = "bf16"):
    """Synchronous global average (warm-up / cool-down), with the paper's
    16-bit transfer packaging (or the tier in `wire_format`)."""
    return replica_mean(params, wire_format=wire_format)


# -- assembled train step ------------------------------------------------------

def value_and_grad(loss_fn: Callable):
    """(params, batch) -> ((loss, aux), grads) by reverse mode through
    torch.autograd on detached copies of the leaves; loss, aux and grads
    come out detached. (torch.func's transforms flatten their inputs and
    outputs with recursive closures that keep the gradients in reference
    cycles until the garbage collector runs: at full width several GB per
    step on the card.)"""
    def fn(params, batch):
        flat, treedef = flatten(params)
        xs = [p.detach().requires_grad_() for p in flat]
        with torch.enable_grad():
            loss, aux = loss_fn(unflatten(treedef, xs), batch)
            grads = torch.autograd.grad(loss, xs, allow_unused=True,
                                        materialize_grads=True)
        aux = {k: v.detach() for k, v in aux.items()}
        return (loss.detach(), aux), unflatten(treedef, list(grads))

    return fn


def local_step(loss_fn: Callable, optimizer: Optimizer):
    """step(params_R, opt_R, batch_R, lr) -> (params, opt, loss_R, aux_R):
    gradient and optimizer update of every replica (the reference's
    `jax.vmap` over the replica axis, `repro/core/daso.py:554-571`).
    loss_fn(params, batch) -> (loss, aux).

    A loop over the R replica rows: each row's gradient and update are
    computed on its own and written into (R, ...) outputs allocated at the
    first row, so one replica's activations and gradients are live at a
    time."""
    vg = value_and_grad(loss_fn)

    def step(params, opt_state, batch, lr):
        n_rep = leaves(params)[0].shape[0]
        bufs, treedef = None, None
        for r in range(n_rep):
            def row(x):
                return x[r]
            p_r = tree_map(row, params)
            (loss, aux), grads = vg(p_r, tree_map(row, batch))
            new_p, new_o = optimizer.update(grads, tree_map(row, opt_state), p_r, lr)
            del grads
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


def _cross_replica_loss(cfg: DasoConfig, loss_r: torch.Tensor) -> torch.Tensor:
    """The scalar loss the plateau controller consumes: the mean of the
    per-replica losses (fixed membership), in the reduction order of the
    reference's configured tier."""
    if cfg.deterministic_reduce:
        return flatbuf.chain_axis0_sum(loss_r) / cfg.n_replicas
    return torch.mean(loss_r, dim=0)


def daso_train_step(loss_fn: Callable, optimizer: Optimizer, cfg: DasoConfig,
                    *, mode: str, staleness: int = 1,
                    inner_syncs: Tuple[Tuple[str, int], ...] = ()):
    """One step variant:
    step(params_R, opt_R, inflight, batch_R, lr) -> (params_R, opt_R,
    inflight, metrics). `mode` is the outermost level's action (MODES)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if inner_syncs:
        raise NotImplementedError("inner-level syncs are not ported yet "
                                  "(ROADMAP item 13)")
    lstep = local_step(loss_fn, optimizer)

    def step(params, opt_state, inflight, batch, lr):
        if mode in ("receive", "send_receive"):
            params = global_receive(params, inflight, staleness=staleness,
                                    global_world=cfg.global_world)
        params, opt_state, loss_r, aux_r = lstep(params, opt_state, batch, lr)
        if mode in ("send", "send_receive"):
            inflight = global_send(params,
                                   wire_format=cfg.wire_format_for(blocking=False))
        elif mode == "blocking":
            params = blocking_sync(params,
                                   wire_format=cfg.wire_format_for(blocking=True))
        elif mode == "hard_avg":
            params = replica_mean(params)
        metrics = {"loss": _cross_replica_loss(cfg, loss_r),
                   "loss_per_replica": loss_r}
        for k, v in aux_r.items():
            if v.dim() <= 1:
                metrics[k] = torch.mean(v)
        return params, opt_state, inflight, metrics

    return step


def sync_train_step(loss_fn: Callable, optimizer: Optimizer):
    """Horovod-analog baseline: flat data parallelism, no replica axis, one
    gradient over the global batch every step."""
    vg = value_and_grad(loss_fn)

    def step(params, opt_state, batch, lr):
        (loss, aux), grads = vg(params, batch)
        new_params, new_opt = optimizer.update(grads, opt_state, params, lr)
        metrics = {"loss": loss}
        for k, v in aux.items():
            if v.dim() == 0:
                metrics[k] = v
        return new_params, new_opt, metrics

    return step
