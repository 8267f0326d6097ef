"""The port's DASO core (`repro_torch.core.daso`, `.schedule`) and its
synthetic data held against the JAX package on the CPU, on a tiny
llama3.2-1b-family model with R = 4 replicas:

  * the exchange functions (`replica_mean`, `global_send`,
    `global_receive`, `blocking_sync`) bit-exact on the same carry against
    the reference's default (plain) tier, and against the reference's
    per-leaf forms (`impl="per_leaf"`) and a per-leaf oracle built here
    from the port's plain pieces; the reference's per-leaf mean of integer
    leaves (zeros) kept visible beside the port's;
  * the port's own per-leaf exchange (`impl="per_leaf"`, item 7): bit for
    bit the fused one (f32 and bf16 wires and leaves, with a mask, on views
    of an arena, with its contiguous copies counted) and the reference's
    per-leaf forms, and one step of each mode bit for bit the fused step;
    int8 refused with the reference's ValueError;
  * one step of each of the six modes, and `sync_train_step`: params,
    optimizer state and loss within 1e-5 (f32; the two frameworks sum in
    different orders inside the model);
  * `SyntheticLM` tokens equal for several (seed, step) pairs;
  * the controller: the same loss trace gives the same mode history and
    the same state_dict, through one plateau halve and one reset.
Inputs are made from a seed with numpy."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core import daso as jdaso
from repro.core import schedule as jschedule
from repro.data.synthetic import SyntheticLM as JaxSyntheticLM
from repro.models.lm import init_params as jax_init_params
from repro.optim.optimizers import sgd as jax_sgd
from repro.train.step import make_lm_loss as jax_make_lm_loss
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core import daso, flatbuf, schedule
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.kernels.ref import eq1_merge_ref
from repro_torch.optim.optimizers import sgd
from repro_torch.train.step import make_lm_loss
from repro_torch.tree import leaves, tree_map

R, PER, SEQ = 4, 2, 16
STEP_ATOL = 1e-5
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
            vocab_size=128)


def _cfgs():
    return (jax_get_reduced("llama3.2-1b").replace(**TINY),
            get_reduced("llama3.2-1b").replace(**TINY))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def problem():
    """A JAX carry (params_R, opt_R, inflight) whose replicas and in-flight
    buffer all differ, the port's copy of it, and one replicated batch."""
    jcfg, tcfg = _cfgs()
    p0 = _np_tree(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def spread(scale):
        return jax.tree.map(lambda a: (a[None] + scale * rng.standard_normal(
            (R,) + a.shape)).astype(np.float32), p0)

    params, inflight = spread(0.01), spread(0.02)
    opt = {"mu": jax.tree.map(lambda a: (0.1 * rng.standard_normal(a.shape))
                              .astype(np.float32), params)}
    src = SyntheticLM(vocab_size=tcfg.vocab_size, seq_len=SEQ, seed=1)
    flat = src.batch(R * PER, step=3)
    batch = {k: v.reshape((R, PER, SEQ)).numpy() for k, v in flat.items()}
    return dict(jcfg=jcfg, tcfg=tcfg, jax=(params, opt, inflight), batch=batch)


def _port(tree):
    return state_from_jax(tree, "cpu")


def _assert_tree_close(got, want_jax_np, atol):
    want = _port(want_jax_np)
    g, w = leaves(got), leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape and a.dtype == b.dtype
        if atol == 0:
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=atol, rtol=0)


# -- exchange functions: bit-exact -------------------------------------------

@pytest.mark.parametrize("tree", ["params", "inflight"])
@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_replica_mean_send_and_blocking_bit_exact(problem, wire, tree):
    params = problem["jax"][{"params": 0, "inflight": 2}[tree]]
    jp = jax.tree.map(jnp.asarray, params)
    want = _np_tree(jdaso.replica_mean(jp, wire_format=wire))
    tp = _port(params)
    _assert_tree_close(daso.replica_mean(tp, wire_format=wire), want, 0)
    _assert_tree_close(daso.global_send(tp, wire_format=wire),
                       _np_tree(jdaso.global_send(jp, wire_format=wire)), 0)
    _assert_tree_close(daso.blocking_sync(tp, wire_format=wire),
                       _np_tree(jdaso.blocking_sync(jp, wire_format=wire)), 0)


# P = 5 makes 2S + P a divisor whose reciprocal is inexact in f32
@pytest.mark.parametrize("global_world", [16, 5])
@pytest.mark.parametrize("staleness,extra", [(1, 0), (2, 0), (3, 1)])
def test_global_receive_bit_exact(problem, staleness, extra, global_world):
    params, _, inflight = problem["jax"]
    want = jdaso.global_receive(jax.tree.map(jnp.asarray, params),
                                jax.tree.map(jnp.asarray, inflight),
                                staleness=staleness, global_world=global_world,
                                extra_staleness=extra)
    got = daso.global_receive(_port(params), _port(inflight), staleness=staleness,
                              global_world=global_world, extra_staleness=extra)
    _assert_tree_close(got, _np_tree(want), 0)


def test_receive_output_is_views_of_one_merged_arena(problem):
    params, _, inflight = problem["jax"]
    got = daso.global_receive(_port(params), _port(inflight), staleness=1,
                              global_world=16)
    ptrs = {x.untyped_storage().data_ptr() for x in leaves(got)}
    assert len(ptrs) == 1


def test_exchange_without_kernels_takes_cpu_tensors_only():
    """The exchange has one path, through the kernel wrappers: the plain
    versions for CPU tensors, and no other path on any device."""
    with pytest.raises(ValueError, match="exchange_kernels=False"):
        daso.DasoConfig(n_replicas=4, global_world=16, exchange_kernels=False)
    m = {"w": torch.zeros(4, 3, device="meta")}
    with pytest.raises(ValueError, match="no kernel for device"):
        daso.global_receive(m, m, staleness=1, global_world=16)
    with pytest.raises(ValueError, match="no kernel for device"):
        daso.blocking_sync(m)


@pytest.mark.parametrize("mask", [(1.0, 1.0, 0.0, 1.0), (0.0, 0.0, 1.0, 1.0)],
                         ids=["one_dead", "dead_group"])
@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_masked_level_group_mean_bit_exact(problem, wire, mask):
    """The group mean under a membership mask (elastic membership): each
    pair of replicas averaged over its active rows, a fully dropped pair
    divided by 1, with and without a regrouping, bit for bit the
    reference's on the model's params."""
    params = problem["jax"][0]
    for perm in (None, (3, 1, 0, 2)):
        want = jdaso.level_group_mean(jax.tree.map(jnp.asarray, params), 2, wire_format=wire,
                                      mask=mask, perm=perm)
        got = daso.level_group_mean(_port(params), 2, wire_format=wire, mask=mask, perm=perm)
        _assert_tree_close(got, _np_tree(want), 0)


def test_unported_options_raise_naming_their_roadmap_item():
    """The per-leaf exchange (item 7) is taken on the f32 and bf16 wires;
    with int8 it is refused with the reference's ValueError, in the config
    and in the exchange functions."""
    for wf in (None, "f32", "bf16"):
        assert daso.DasoConfig(n_replicas=4, global_world=16, exchange_impl="per_leaf",
                               wire_format=wf).exchange_impl == "per_leaf"
    with pytest.raises(ValueError, match="fused"):  # as the reference refuses it
        daso.DasoConfig(n_replicas=4, global_world=16, exchange_impl="per_leaf",
                        wire_format="int8")
    x = {"w": torch.ones(4, 3)}
    with pytest.raises(ValueError, match="fused"):
        daso.replica_mean(x, wire_format="int8", impl="per_leaf")
    with pytest.raises(ValueError, match="exchange impl"):
        daso.global_receive(x, x, staleness=1, global_world=16, impl="leafwise")
    cfg = daso.DasoConfig(n_replicas=4, global_world=16)
    assert cfg.exchange_kernels and cfg.wire_format_for(blocking=True) == "bf16"


# -- the fused exchange against the per-leaf one: bit-exact ------------------------

def _tree_of(problem, tree):
    """The carry's params or in-flight buffer, in f32 or cast to bf16."""
    params, _, inflight = problem["jax"]
    t = params if tree.startswith("params") else inflight
    if tree.endswith("bf16"):
        t = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), t)
    return t


def _bits(t):
    t = t.contiguous().reshape(-1)
    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def _assert_same_bits(a_tree, b_tree):
    a, b = leaves(a_tree), leaves(b_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(_bits(x), _bits(y))


def _per_leaf_mean(tree, wire_dtype):
    """The reference's per-leaf mean (`repro/core/daso.py:219-229`) from the
    port's plain pieces: each leaf cast to the wire dtype, reduced by the
    fused path's chain of adds in replica order, cast back."""
    return tree_map(lambda x: flatbuf.masked_axis0_mean(x.to(wire_dtype or x.dtype))
                    .to(x.dtype).expand(x.shape), tree)


@pytest.mark.parametrize("tree", ["params", "inflight", "params_bf16"])
@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_fused_mean_send_and_blocking_equal_the_per_leaf_exchange(problem, wire, tree):
    """The fused `replica_mean`, `global_send` and `blocking_sync` (one
    arena, the wire cast through K3's plain version) against the
    reference's impl="per_leaf" forms and the per-leaf oracle above, bit
    for bit on normal f32 and bf16 leaves."""
    t = _tree_of(problem, tree)
    jp, tp = jax.tree.map(jnp.asarray, t), _port(t)
    oracle = _per_leaf_mean(tp, torch.bfloat16 if wire == "bf16" else None)
    for name in ("replica_mean", "global_send", "blocking_sync"):
        got = getattr(daso, name)(tp, wire_format=wire)
        _assert_same_bits(got, _port(_np_tree(getattr(jdaso, name)(
            jp, wire_format=wire, impl="per_leaf"))))
        _assert_same_bits(got, oracle)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("global_world", [16, 5])
@pytest.mark.parametrize("staleness,extra", [(1, 0), (3, 1)])
def test_fused_receive_equals_the_per_leaf_merge(problem, staleness, extra, global_world,
                                                 dtype):
    """The fused Eq. (1) merge (one K2 plain-version call per arena) against
    the reference's `global_receive_per_leaf` and `eq1_merge_ref` leaf by
    leaf, bit for bit."""
    params, _, inflight = problem["jax"]
    if dtype == "bfloat16":
        params, inflight = (jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), t)
                            for t in (params, inflight))
    kw = dict(staleness=staleness, global_world=global_world, extra_staleness=extra)
    want = jdaso.global_receive_per_leaf(jax.tree.map(jnp.asarray, params),
                                         jax.tree.map(jnp.asarray, inflight), **kw)
    got = daso.global_receive(_port(params), _port(inflight), **kw)
    _assert_same_bits(got, _port(_np_tree(want)))
    _assert_same_bits(got, tree_map(lambda a, b: eq1_merge_ref(a, b, **kw),
                                    _port(params), _port(inflight)))


def test_per_leaf_mean_of_integer_leaves_zeroes_in_the_reference():
    """A reference hazard (ROADMAP §3): on the f32 wire the reference's
    per-leaf mean reduces an integer leaf in its own dtype, where 1 / R
    rounds to 0, so every mean is 0; its fused mean takes it in f32 and
    rounds, as the port's does."""
    i = np.arange(8, dtype=np.int32).reshape(4, 2)
    want_fused = np.broadcast_to(np.int32([3, 4]), (4, 2))
    ref_leaf = np.asarray(jdaso.replica_mean_per_leaf({"i": jnp.asarray(i)})["i"])
    ref_fused = np.asarray(jdaso.replica_mean({"i": jnp.asarray(i)})["i"])
    np.testing.assert_array_equal(ref_leaf, np.zeros((4, 2), np.int32))
    np.testing.assert_array_equal(ref_fused, want_fused)
    got = daso.replica_mean({"i": torch.from_numpy(i)})["i"]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want_fused)


# -- the port's per-leaf exchange (impl="per_leaf") -------------------------------

MASKS = [None, (1.0, 1.0, 0.0, 1.0)]


@pytest.mark.parametrize("mask", MASKS, ids=["all", "masked"])
@pytest.mark.parametrize("tree", ["params", "params_bf16"])
@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_per_leaf_exchange_is_the_fused_exchange_bit_for_bit(problem, wire, tree, mask):
    """`replica_mean`, `global_send`, `blocking_sync` and `global_receive`
    leaf by leaf (one K3 / K2 plain-version call per leaf) against the fused
    ones (one per arena), bit for bit, with and without a mask; the leaves
    given are views of one arena (a fused merge's output), so each is copied
    before its call and the copies are counted."""
    t = _port(_tree_of(problem, tree))
    # broadcast means: views with a stride-0 replica axis
    inflight = daso.replica_mean(_port(_tree_of(problem, tree.replace("params", "inflight"))))
    params = daso.global_receive(t, daso.replica_mean(t), staleness=1, global_world=16)
    assert not any(x.is_contiguous() for x in leaves(params))
    for name in ("replica_mean", "global_send", "blocking_sync"):
        _assert_same_bits(getattr(daso, name)(params, wire_format=wire, mask=mask,
                                              impl="per_leaf"),
                          getattr(daso, name)(params, wire_format=wire, mask=mask))
    ops.CONTIGUOUS_COPIES.reset()
    kw = dict(staleness=3, global_world=12.0, extra_staleness=1, mask=mask)
    got = daso.global_receive(params, inflight, impl="per_leaf", **kw)
    _assert_same_bits(got, daso.global_receive(params, inflight, **kw))
    n = len(leaves(params))
    assert ops.CONTIGUOUS_COPIES.copies == 2 * n
    assert ops.CONTIGUOUS_COPIES.bytes == 2 * sum(x.numel() * x.element_size()
                                                 for x in leaves(params))


@pytest.mark.parametrize("mask", MASKS, ids=["all", "masked"])
@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_per_leaf_exchange_matches_the_reference_per_leaf(problem, wire, mask):
    """The port's per-leaf exchange against the reference's impl="per_leaf"
    forms on the same carry (normal f32 values: away from the integer and
    subnormal hazards of ROADMAP §3), bit for bit."""
    params, _, inflight = problem["jax"]
    jp, jf = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, inflight)
    tp, tf = _port(params), _port(inflight)
    for name in ("replica_mean", "global_send", "blocking_sync"):
        got = getattr(daso, name)(tp, wire_format=wire, mask=mask, impl="per_leaf")
        _assert_same_bits(got, _port(_np_tree(getattr(jdaso, name)(
            jp, wire_format=wire, mask=mask, impl="per_leaf"))))
    kw = dict(staleness=2, global_world=16 * 3 / 4 if mask else 16)
    got = daso.global_receive(tp, tf, impl="per_leaf", mask=mask, **kw)
    _assert_same_bits(got, _port(_np_tree(jdaso.global_receive(
        jp, jf, impl="per_leaf", mask=mask, **kw))))


@pytest.mark.parametrize("mode", jdaso.MODES)
def test_per_leaf_step_of_each_mode_is_the_fused_step(problem, mode):
    """One step of each mode with exchange_impl="per_leaf": the fused
    step's params, optimizer state, in-flight buffer and metrics bit for
    bit (bf16 blocking wire, f32 cycling wire)."""
    params, opt, inflight = problem["jax"]
    batch = {k: torch.from_numpy(v) for k, v in problem["batch"].items()}
    out = []
    for impl in ("fused", "per_leaf"):
        cfg = daso.DasoConfig(n_replicas=R, global_world=R * 4, b_max=4, exchange_impl=impl)
        step = daso.daso_train_step(make_lm_loss(problem["tcfg"]), sgd(0.9, 1e-4), cfg,
                                    mode=mode, staleness=2)
        out.append(step(_port(params), _port(opt), _port(inflight), batch, 0.05))
    for a, b in zip(out[0][:3], out[1][:3]):
        _assert_same_bits(a, b)
    assert sorted(out[0][3]) == sorted(out[1][3])
    for k in out[0][3]:
        assert torch.equal(out[0][3][k], out[1][3][k])


# -- one step of each mode ------------------------------------------------------

@pytest.mark.parametrize("mode", jdaso.MODES)
def test_step_of_each_mode_matches_jax(problem, mode):
    jcfg, tcfg = problem["jcfg"], problem["tcfg"]
    params, opt, inflight = problem["jax"]
    batch = problem["batch"]
    kw = dict(n_replicas=R, global_world=R * 4, b_max=4)
    jstep = jax.jit(jdaso.daso_train_step(jax_make_lm_loss(jcfg), jax_sgd(0.9, 1e-4),
                                          jdaso.DasoConfig(**kw), mode=mode,
                                          staleness=2))
    jp, jo, ji, jm = jstep(*(jax.tree.map(jnp.asarray, t) for t in (params, opt, inflight)),
                           jax.tree.map(jnp.asarray, batch), jnp.float32(0.05))
    tstep = daso.daso_train_step(make_lm_loss(tcfg), sgd(0.9, 1e-4),
                                 daso.DasoConfig(**kw), mode=mode, staleness=2)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tp, to, ti, tm = tstep(_port(params), _port(opt), _port(inflight), tbatch, 0.05)
    _assert_tree_close(tp, _np_tree(jp), STEP_ATOL)
    _assert_tree_close(to, _np_tree(jo), STEP_ATOL)
    _assert_tree_close(ti, _np_tree(ji), STEP_ATOL)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), atol=STEP_ATOL,
                                   rtol=0)


def test_sync_train_step_matches_jax(problem):
    jcfg, tcfg = problem["jcfg"], problem["tcfg"]
    params = jax.tree.map(lambda a: a[0], problem["jax"][0])
    batch = {k: v.reshape((R * PER, SEQ)) for k, v in problem["batch"].items()}
    jopt = jax_sgd(0.9, 1e-4)
    jp, jo, jm = jax.jit(jdaso.sync_train_step(jax_make_lm_loss(jcfg), jopt))(
        jax.tree.map(jnp.asarray, params), jopt.init(jax.tree.map(jnp.asarray, params)),
        jax.tree.map(jnp.asarray, batch), jnp.float32(0.05))
    topt = sgd(0.9, 1e-4)
    tparams = params_from_jax(params)
    tp, to, tm = daso.sync_train_step(make_lm_loss(tcfg), topt)(
        tparams, topt.init(tparams), {k: torch.from_numpy(v) for k, v in batch.items()},
        0.05)
    for a, b in zip(leaves(tp), leaves(params_from_jax(_np_tree(jp)))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=STEP_ATOL, rtol=0)
    for a, b in zip(leaves(to), leaves(state_from_jax(_np_tree(jo)))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=STEP_ATOL, rtol=0)
    assert sorted(tm) == sorted(jm)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), atol=STEP_ATOL)


# -- data -----------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (11, 250)])
def test_synthetic_lm_tokens_equal_jax(seed, step):
    want = JaxSyntheticLM(vocab_size=300, seq_len=40, seed=seed).batch(6, step)
    got = SyntheticLM(vocab_size=300, seq_len=40, seed=seed).batch(6, step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# -- controller -----------------------------------------------------------------

def _loss_trace(n):
    """Falls for 30 steps, then flat: with windows of 5 and patience 2 the
    schedule halves B/W twice (4/1 -> 2/1 -> 1/1), then resets to 4/1."""
    return [5.0 - 0.1 * min(t, 30) + 0.001 * (t % 3) for t in range(n)]


def _controllers():
    kw = dict(n_replicas=4, global_world=16, b_max=4, warmup_steps=3,
              cooldown_steps=4, total_steps=120, plateau_patience=2)
    return (jschedule.DasoController(jdaso.DasoConfig(**kw), loss_window=5),
            schedule.DasoController(daso.DasoConfig(**kw), loss_window=5))


def _json(sd):
    return json.loads(json.dumps(sd))


def test_controller_per_step_matches_jax():
    jc, tc = _controllers()
    seen_b = []
    for t, loss in enumerate(_loss_trace(120)):
        assert tc.mode_for_step(t) == jc.mode_for_step(t)
        jc.observe_loss(loss)
        tc.observe_loss(loss)
        seen_b.append(tc.b)
        assert _json(tc.state_dict()) == _json(jc.state_dict())
    assert [h[1:] for h in tc.history] == [h[1:] for h in jc.history]
    runs = [b for i, b in enumerate(seen_b) if i == 0 or b != seen_b[i - 1]]
    assert runs[:4] == [4, 2, 1, 4]  # halve, halve, reset
    assert tc.global_sync_fraction() == jc.global_sync_fraction()


def test_controller_plan_cycle_matches_jax():
    jc, tc = _controllers()
    losses, t = _loss_trace(120), 0
    while t < 120:
        shape = tc.plan_cycle(t, max_len=8)
        assert shape == jc.plan_cycle(t, max_len=8)
        for loss in losses[t:t + len(shape)]:
            jc.observe_loss(loss)
            tc.observe_loss(loss)
        t += len(shape)
    assert _json(tc.state_dict()) == _json(jc.state_dict())


def test_controller_state_dict_roundtrip():
    _, tc = _controllers()
    for t, loss in enumerate(_loss_trace(40)):
        tc.mode_for_step(t)
        tc.observe_loss(loss)
    fresh = _controllers()[1]
    fresh.load_state_dict(_json(tc.state_dict()))
    assert [fresh.mode_for_step(t) for t in range(40, 60)] == \
        [tc.mode_for_step(t) for t in range(40, 60)]


def test_split_mode():
    assert schedule.split_mode("send+host") == ("send", ("host",))
    assert schedule.split_mode("local") == ("local", ())


def test_steps_leave_no_tensor_in_a_reference_cycle(problem):
    """A tensor held in a reference cycle stays allocated until the garbage
    collector runs: at full width that is gigabytes per step on the card.
    After a warm-up step, a receive and a blocking step free every tensor
    they made by reference counting alone."""
    import gc

    tcfg = problem["tcfg"]
    cfg = daso.DasoConfig(n_replicas=R, global_world=R * 4)
    steps = {m: daso.daso_train_step(make_lm_loss(tcfg), sgd(), cfg, mode=m)
             for m in ("send", "receive", "blocking")}
    params, opt, inflight = (_port(t) for t in problem["jax"])
    batch = {k: torch.from_numpy(v) for k, v in problem["batch"].items()}
    gc.collect()
    was_enabled = gc.isenabled()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        carry = steps["send"](params, opt, inflight, batch, 0.05)[:3]
        gc.collect()
        gc.garbage.clear()
        for mode in ("receive", "blocking"):
            carry = steps[mode](*carry, batch, 0.05)[:3]
        gc.collect()
        cycled = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        if was_enabled:
            gc.enable()
    assert not cycled, f"{len(cycled)} tensors were freed only by the collector"
