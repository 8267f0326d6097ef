"""The relaxed-synchronization baselines: gossip, EASGD and DOWNPOUR
(`repro/core/baselines.py`).

DASO is one point in a design space; these are three classic neighbours,
registered beside it so every surface of the port drives them through the
one Strategy interface: both executors, the checkpoint TrainState, elastic
membership and the resilience supervisor's fault plans.

  * **gossip**: every B steps each replica averages with ONE partner, a ring
    shift whose offset rotates between exchanges (1, 2, ..., R-1, 1, ...),
    so information crosses the whole ring. The partner copy is a roll of
    the packed arena along the replica axis, and only it is wire-encoded:
    a replica's own row never leaves it (Jin et al.).
  * **easgd**: Elastic Averaging SGD. Replicas are pulled toward a center,
    ``params <- (1-a) params + a center``, and the center follows the
    replica mean, ``center <- (1-b) center + b mean(params)`` with
    b = a n_active (Zhang et al., 2015). One global mean per exchange.
  * **downpour**: DOWNPOUR's parameter server as replicated state. Each
    replica accumulates a delta against the last server copy (the `anchor`
    slot); a push adds the sum of the active deltas (n_active times their
    masked mean, one global mean) to the server copy and hands it out as
    every replica's params (Dean et al., 2012).

All three run the periodic schedule (`PeriodicController`): blocking warm-up
and cool-down as DASO's, and one exchange every B cycling steps, B following
the paper's plateau rule. None has an exchange in flight, so the overlap
schedule is refused.

Carry layouts:

    gossip    (params_R, opt_R)             2 slots
    easgd     (params_R, opt_R, center_R)   3 slots
    downpour  (params_R, opt_R, anchor_R)   3 slots

The reference copies the center and the anchor out of the params
(`jnp.array`); here they start as the params themselves, and a blocking step
or a push makes them the tensors it gives the params. No step writes into a
tensor it was given, so the numbers are the same, and a carry holds one
slot less until the first elastic step or push. A TrainState records that
aliasing (`checkpoint/io.py::_carry_layout`), and a resume restores it.

The exchanges run through the kernels: gossip's int8 partner through K5 /
K6, its bf16 partner through K3 (then a plain upcast, as the reference's
`astype`); EASGD's and DOWNPOUR's means and every blocking step as DASO's
(`core/daso.py::replica_mean`), fused or leaf by leaf as
`DasoConfig.exchange_impl` says. Gossip's partner copy is always fused, as
the reference's `gossip_mix` takes no impl.

Across processes (`launch/distributed.py::ProcessPlacement`) each builder
takes `placement`: the carry holds this process's rows, EASGD's and
DOWNPOUR's means gather every row's wire payload as DASO's do, and gossip
gathers every row's encoded partner copy and keeps the partners of its own
rows, so the numbers are the one-process run's bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from repro_torch.core import flatbuf
from repro_torch.core.daso import (_local, _membership_of, _step_metrics,
                                   blocking_sync, freeze_inactive, local_step,
                                   replica_mean, replicate_params)
from repro_torch.core.executor import DasoStrategy, register_strategy
from repro_torch.core.schedule import DasoController, Mode, split_mode, split_ov
from repro_torch.tree import tree_map


# -- periodic controllers ------------------------------------------------------

@dataclass
class PeriodicController(DasoController):
    """DASO's phases with the send / receive pair folded into one periodic
    exchange token: blocking warm-up and cool-down, then
    `exchange_token(step)` every B cycling steps. Nothing is ever in flight,
    so the base class's cycle planner and plateau rule work unchanged: a
    plateau shortens the exchange period as it shortens DASO's."""
    # the outer-mode token of an exchange (subclasses override it, or
    # `exchange_token` for a token that varies)
    exchange_base = Mode.HARD_AVG
    # exchanges emitted so far (gossip's rotating shift; checkpointed, so a
    # resumed ring goes on where it stopped)
    _n_ex: int = field(init=False, default=0)

    _STATE_FIELDS = DasoController._STATE_FIELDS + ("_n_ex",)

    def exchange_token(self, step: int) -> str:
        return self.exchange_base

    def mode_for_step(self, step: int) -> Tuple[str, int]:
        ph = self.phase(step)
        if ph in ("warmup", "cooldown"):
            self._inflight_since = None
            self._ov_last = None
            mode = Mode.BLOCKING
        elif self._would_send(step):
            self._last_send = step
            mode = self.exchange_token(step)
            self._n_ex += 1
        else:
            mode = Mode.LOCAL
        self.history.append((step, mode, self._b, self._w))
        return mode, 1


@dataclass
class GossipController(PeriodicController):
    """Exchange k pairs replica i with replica (i + shift) mod R, the shift
    rotating through 1..R-1, so consecutive exchanges use other partners and
    the ring mixes globally (a fixed shift of 1 needs R-1 exchanges to
    spread a value)."""
    exchange_base = Mode.GOSSIP

    def exchange_token(self, step: int) -> str:
        r = self.cfg.n_replicas
        shift = (self._n_ex % (r - 1)) + 1 if r > 1 else 1
        return f"{Mode.GOSSIP}~{shift}"


@dataclass
class EasgdController(PeriodicController):
    exchange_base = Mode.ELASTIC


@dataclass
class DownpourController(PeriodicController):
    exchange_base = Mode.PUSH


# -- the gossip exchange -------------------------------------------------------

def gossip_mix(tree, *, shift: int, wire_format: str = "f32",
               int8_block: int = 256, mask=None, placement=None):
    """One pairwise gossip exchange over the leading replica axis:
    ``row_i <- (row_i + row_{(i+shift) mod R}) / 2``.

    On the packed arenas, one roll per dtype arena whatever the leaf count.
    Only the partner copy is wire-encoded (int8 through K5 / K6, bf16
    through K3 and then upcast); a floating arena averages in f32, an
    integer one in f32 and rounds. No reduction anywhere.

    `mask`: a row mixes only when both it and its partner are active; any
    other row keeps its own value (a dropped row stays a frozen ghost).
    Under partial membership the exchange keeps the mean pairwise only.

    `placement`: the tree holds this process's rows; every process encodes
    its own rows, the payloads are gathered, and each process takes the
    partners of its rows (the codecs work row by row, so each partner's
    payload is the one-process run's)."""
    layout = flatbuf.build_layout(tree, batch_dims=1)
    arenas = flatbuf.pack(tree, layout)
    r = layout.batch_shape[0] if placement is None else placement.n_replicas
    if not 1 <= shift < max(r, 2):
        raise ValueError(f"gossip shift {shift} outside 1..{r - 1}")
    own = range(r) if placement is None else placement.rows
    keep = ([] if mask is None else
            [i - own.start for i in own if not (mask[i] and mask[(i + shift) % r])])

    def partner_of(arena, wire_format):
        """The wire payload of every own row's partner."""
        if placement is None:
            return flatbuf.encode_wire(torch.roll(arena, -shift, 0), wire_format,
                                       int8_block=int8_block)
        full = placement.gather_rows(flatbuf.encode_wire(arena, wire_format,
                                                         int8_block=int8_block))
        idx = torch.tensor([(i + shift) % r for i in own], dtype=torch.long,
                           device=arena.device)
        if isinstance(full, tuple):
            return tuple(x.index_select(0, idx) for x in full)
        return full.index_select(0, idx)

    def mix(arena):
        if not arena.is_floating_point():
            partner = partner_of(arena, "f32")
            out = torch.round(0.5 * (arena.float() + partner.float()))
        else:
            tier = wire_format if wire_format in ("int8", "bf16") else "f32"
            partner = partner_of(arena, tier)
            if tier == "int8":
                partner = flatbuf.decode_wire(partner, "int8", arena.dtype,
                                              int8_block=int8_block)
            # the partner is this function's own tensor (the roll, or the
            # decoded wire): sum and halve in place (a + b and b + a are one
            # IEEE value, and so are 0.5 x and x * 0.5)
            out = partner.float().add_(arena.float()).mul_(0.5)
        out = out.to(arena.dtype)
        for i in keep:
            out[i].copy_(arena[i])
        return out

    return flatbuf.unpack({k: mix(arenas.pop(k)) for k in list(arenas)}, layout)


# -- assembled train steps -----------------------------------------------------

def _lerp(a_tree, b_tree, t: float):
    """(1 - t) a + t b leaf by leaf in f32 (integer leaves round back), as
    the reference's easgd lerp; a (1, ...) leaf of `b_tree` broadcasts over
    the replicas. Row by row into one output per leaf, so the temporaries
    are one replica's row."""
    def leaf(x, y):
        out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        for i in range(x.shape[0]):
            yi = y[i if y.shape[0] > 1 else 0]
            torch.add((1.0 - t) * x[i].float(), t * yi.float(), out=out[i])
        if not x.is_floating_point():
            out = torch.round(out)
        return out.to(x.dtype)

    return tree_map(leaf, a_tree, b_tree)


def _row(tree):
    """The first replica's row of every leaf, kept as (1, ...): the value a
    `replica_mean` result repeats on every row."""
    return tree_map(lambda x: x[:1], tree)


def gossip_train_step(loss_fn, optimizer, cfg, *, mode: str, shift: int = 1,
                      n_micro: int = 1, membership=None, placement=None):
    """step(params_R, opt_R, batch_R, lr) -> (params_R, opt_R, metrics).
    `mode` is local | blocking | gossip (the shift decoded by the caller)."""
    if mode not in (Mode.LOCAL, Mode.BLOCKING, Mode.GOSSIP):
        raise ValueError(f"gossip step: unknown mode {mode!r}")
    mask, n_active, _ = _membership_of(cfg, membership)
    lstep = local_step(loss_fn, optimizer, n_micro, _local(mask, placement))
    blk = cfg.int8_block
    px = dict(mask=mask, placement=placement)

    def step(params, opt_state, batch, lr):
        params, opt_state, loss_r, aux_r = lstep(params, opt_state, batch, lr)
        if mode == Mode.GOSSIP:
            params = gossip_mix(params, shift=shift,
                                wire_format=cfg.wire_format_for(blocking=False),
                                int8_block=blk, **px)
        elif mode == Mode.BLOCKING:
            params = blocking_sync(params, wire_format=cfg.wire_format_for(blocking=True),
                                   impl=cfg.exchange_impl, int8_block=blk, **px)
        return params, opt_state, _step_metrics(cfg, mask, n_active, loss_r, aux_r,
                                                placement)

    return step


def easgd_train_step(loss_fn, optimizer, cfg, *, mode: str, alpha: float,
                     n_micro: int = 1, membership=None, placement=None):
    """step(params_R, opt_R, center_R, batch_R, lr)
        -> (params_R, opt_R, center_R, metrics).

    `mode` elastic: the one global exchange is the masked replica mean m of
    the stepped params; then the elastic pull ``params <- (1-a) params +
    a center`` and ``center <- (1-b) center + b m`` with b = a n_active.
    `mode` blocking makes the center the freshly synced params: a full
    average is the consensus. The center rows are global state, never
    frozen; a dropped replica's param rows are."""
    if mode not in (Mode.LOCAL, Mode.BLOCKING, Mode.ELASTIC):
        raise ValueError(f"easgd step: unknown mode {mode!r}")
    mask, n_active, _ = _membership_of(cfg, membership)
    lmask = _local(mask, placement)
    lstep = local_step(loss_fn, optimizer, n_micro, lmask)
    blk = cfg.int8_block
    beta = alpha * n_active
    px = dict(mask=mask, placement=placement)

    def step(params, opt_state, center, batch, lr):
        params, opt_state, loss_r, aux_r = lstep(params, opt_state, batch, lr)
        if mode == Mode.ELASTIC:
            m = replica_mean(params, wire_format=cfg.wire_format_for(blocking=False),
                             impl=cfg.exchange_impl, int8_block=blk, **px)
            params = freeze_inactive(_lerp(params, center, alpha), params, lmask)
            center = _lerp(center, _row(m), beta)
            del m
        elif mode == Mode.BLOCKING:
            params = blocking_sync(params, wire_format=cfg.wire_format_for(blocking=True),
                                   impl=cfg.exchange_impl, int8_block=blk, **px)
            center = params
        return params, opt_state, center, _step_metrics(cfg, mask, n_active,
                                                        loss_r, aux_r, placement)

    return step


def downpour_train_step(loss_fn, optimizer, cfg, *, mode: str,
                        push_scale: float = 1.0, n_micro: int = 1,
                        membership=None, placement=None):
    """step(params_R, opt_R, anchor_R, batch_R, lr)
        -> (params_R, opt_R, anchor_R, metrics).

    `anchor` is the server's copy at the last push. A push adds the SUM of
    the active replicas' deltas to it, ``anchor + push_scale n_active
    masked_mean(params - anchor)``, one masked global mean, and hands the
    result out: params = anchor = server. `push_scale` is the server's rate
    on the delta sum (1.0 applies it as it is). A dropped row adds no delta
    and keeps its frozen params; the anchor rows all update (server
    state)."""
    if mode not in (Mode.LOCAL, Mode.BLOCKING, Mode.PUSH):
        raise ValueError(f"downpour step: unknown mode {mode!r}")
    mask, n_active, _ = _membership_of(cfg, membership)
    lmask = _local(mask, placement)
    lstep = local_step(loss_fn, optimizer, n_micro, lmask)
    blk = cfg.int8_block
    scale = push_scale * n_active
    px = dict(mask=mask, placement=placement)

    def step(params, opt_state, anchor, batch, lr):
        params, opt_state, loss_r, aux_r = lstep(params, opt_state, batch, lr)
        if mode == Mode.PUSH:
            delta = tree_map(lambda p, a: p.float() - a.float(), params, anchor)
            dmean = _row(replica_mean(delta, wire_format=cfg.wire_format_for(blocking=False),
                                      impl=cfg.exchange_impl, int8_block=blk, **px))
            del delta

            def apply(a, d):
                out = a.float() + scale * d.float()
                if not a.is_floating_point():
                    out = torch.round(out)
                return out.to(a.dtype)

            server = tree_map(apply, anchor, dmean)
            del dmean
            params = freeze_inactive(server, params, lmask)
            anchor = server
        elif mode == Mode.BLOCKING:
            params = blocking_sync(params, wire_format=cfg.wire_format_for(blocking=True),
                                   impl=cfg.exchange_impl, int8_block=blk, **px)
            anchor = params
        return params, opt_state, anchor, _step_metrics(cfg, mask, n_active,
                                                        loss_r, aux_r, placement)

    return step


# -- strategies ----------------------------------------------------------------

class PeriodicStrategy(DasoStrategy):
    """The baselines' base: the replica-axis carry, a `PeriodicController`
    schedule, no overlap, nothing in flight. Membership, the step cache,
    cycle planning and the first-active finalize are DasoStrategy's;
    a subclass gives the controller class and the step builder."""
    controller_cls = PeriodicController

    def __init__(self, loss_fn, optimizer, cfg, *, membership=None,
                 controller=None, n_micro=1):
        if cfg is None:
            raise ValueError(f"strategy {self.name!r} needs a DasoConfig")
        if cfg.overlap != "off":
            raise ValueError(f"strategy {self.name!r} has no non-blocking exchange to "
                             "overlap; run it with overlap='off'")
        if cfg.n_replicas < 2:
            raise ValueError(f"strategy {self.name!r} exchanges between replicas; "
                             f"n_replicas must be >= 2, got {cfg.n_replicas}")
        if controller is None:
            controller = self.make_controller(cfg)
        elif not isinstance(controller, PeriodicController):
            raise TypeError(f"strategy {self.name!r} needs a periodic controller (use "
                            f"{type(self).__name__}.make_controller); got "
                            f"{type(controller).__name__}")
        super().__init__(loss_fn, optimizer, cfg, membership=membership,
                         controller=controller, n_micro=n_micro)

    @classmethod
    def make_controller(cls, cfg, *, loss_window: int = 50):
        return cls.controller_cls(cfg, loss_window=loss_window)

    def _replicated(self, params0):
        return (replicate_params(params0, self.cfg.n_replicas),
                replicate_params(self.optimizer.init(params0), self.cfg.n_replicas))

    def _base_mode(self, mode: str) -> Tuple[str, int]:
        outer, inner = split_mode(mode)
        self._inner_syncs_of(inner)  # no topology: refuses inner syncs
        return split_ov(outer)


@register_strategy("gossip")
class GossipStrategy(PeriodicStrategy):
    """Pairwise gossip averaging; carry (params, opt_state)."""
    controller_cls = GossipController

    def init_carry(self, params0):
        return self._replicated(params0)

    def build_step(self, mode, staleness):
        base, shift = self._base_mode(mode)
        raw = gossip_train_step(self.loss_fn, self.optimizer, self.cfg, mode=base,
                                shift=max(shift, 1), n_micro=self.n_micro,
                                membership=self._membership, placement=self.placement)

        def step(carry, batch, lr):
            params, opt_state = carry
            params, opt_state, m = raw(params, opt_state, batch, lr)
            return (params, opt_state), m

        return step


@register_strategy("easgd")
class EasgdStrategy(PeriodicStrategy):
    """Elastic Averaging SGD; carry (params, opt_state, center).

    `alpha` is the elastic coupling (each exchange's pull toward the
    center); the center's own rate is b = alpha n_active, so a stable
    center needs alpha n_replicas < 1. Default alpha = 0.5 / n_replicas
    (b = 0.5 with every replica active)."""
    controller_cls = EasgdController

    def __init__(self, loss_fn, optimizer, cfg, *, alpha: Optional[float] = None, **kw):
        super().__init__(loss_fn, optimizer, cfg, **kw)
        self.alpha = 0.5 / cfg.n_replicas if alpha is None else float(alpha)
        if not 0.0 < self.alpha * cfg.n_replicas < 1.0:
            raise ValueError(f"easgd needs 0 < alpha * n_replicas < 1 for a stable "
                             f"center (beta = alpha * n_active); got alpha={self.alpha} "
                             f"with n_replicas={cfg.n_replicas}")

    def init_carry(self, params0):
        params, opt_state = self._replicated(params0)
        return (params, opt_state, params)

    def build_step(self, mode, staleness):
        base, _ = self._base_mode(mode)
        raw = easgd_train_step(self.loss_fn, self.optimizer, self.cfg, mode=base,
                               alpha=self.alpha, n_micro=self.n_micro,
                               membership=self._membership, placement=self.placement)

        def step(carry, batch, lr):
            params, opt_state, center = carry
            params, opt_state, center, m = raw(params, opt_state, center, batch, lr)
            return (params, opt_state, center), m

        return step


@register_strategy("downpour")
class DownpourStrategy(PeriodicStrategy):
    """DOWNPOUR-style delta pushes; carry (params, opt_state, anchor).
    `push_scale` is the server's rate on the delta sum."""
    controller_cls = DownpourController

    def __init__(self, loss_fn, optimizer, cfg, *, push_scale: float = 1.0, **kw):
        super().__init__(loss_fn, optimizer, cfg, **kw)
        if push_scale <= 0:
            raise ValueError(f"push_scale must be positive, got {push_scale}")
        self.push_scale = float(push_scale)

    def init_carry(self, params0):
        params, opt_state = self._replicated(params0)
        return (params, opt_state, params)

    def build_step(self, mode, staleness):
        base, _ = self._base_mode(mode)
        raw = downpour_train_step(self.loss_fn, self.optimizer, self.cfg, mode=base,
                                  push_scale=self.push_scale, n_micro=self.n_micro,
                                  membership=self._membership,
                                  placement=self.placement)

        def step(carry, batch, lr):
            params, opt_state, anchor = carry
            params, opt_state, anchor, m = raw(params, opt_state, anchor, batch, lr)
            return (params, opt_state, anchor), m

        return step
