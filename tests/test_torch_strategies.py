"""The port's strategy battery (`repro_torch.core.baselines` beside the daso
family), the twin of tests/test_strategies.py, held against the JAX package
on the CPU:

  * the registry: every strategy of the port, the same names as the
    reference's;
  * macro == per-step, bit for bit within the port (losses, per-step
    metrics, the final carry), for sync, daso, local_sgd, gossip, easgd and
    downpour;
  * each baseline's run against the reference's on the same MLP problem:
    the same mode history, losses within rtol 1e-5 / atol 1e-6 and every
    carry slot within rtol 2e-5 / atol 1e-6 (the reference's own tolerances
    between its executors);
  * `gossip_mix` bit for bit the reference's for every shift of R = 2..4,
    on the f32, bf16 and int8 wires (the reference's int8 codec is its
    plain `quantize_int8_block_ref`, the port's CPU path), with f32, bf16
    and int32 leaves, with and without masks;
  * one step of every EASGD and DOWNPOUR mode against the reference's, from
    the same carry, with and without a mask; every baseline's exchange steps
    with the per-leaf exchange bit for bit the fused ones, and EASGD /
    DOWNPOUR runs on both packages' per-leaf exchanges;
  * the periodic schedule's shape, gossip's rotating shift;
  * checkpoint resume bit for bit for every strategy (gossip's `_n_ex`
    included), a reference TrainState of each baseline resumed by the port
    and a port TrainState resumed by the reference, the strategy-mismatch
    refusal;
  * a fault plan's crash and rejoin for every replica-axis strategy, against
    the reference's supervisor on the same plan;
  * gossip keeps the global mean and EASGD's center follows its closed form
    (property tests, few examples);
  * `get_strategy`'s suggestion, the refusals of overlap, R < 2 and an
    unstable alpha; the topology sizing (a 2-level spec sizes R, P and
    b_max, a 3-level one is refused) as the reference's.

The legs of tests/test_strategies.py that need HLO (the one-collective
contract) or two processes are ROADMAP items 21 and 16. Inputs are made from
a seed with numpy."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.checkpoint import io as jio
from repro.core import baselines as jbaselines
from repro.core import daso as jdaso
from repro.core import executor as jexecutor
from repro.optim import optimizers as jopt
from repro.optim.schedules import constant_lr as jax_constant_lr
from repro.resilience.faults import FaultPlan as JaxFaultPlan
from repro.resilience.supervisor import run_with_faults as jax_run_with_faults
from repro.train import loop as jloop
from repro_torch.checkpoint import io
from repro_torch.core import baselines, daso, executor
from repro_torch.core.simulator import run_per_step_training
from repro_torch.optim.optimizers import sgd
from repro_torch.optim.schedules import constant_lr
from repro_torch.resilience import FaultPlan, run_with_faults
from repro_torch.train import loop
from repro_torch.tree import leaves

ALL = ("sync", "daso", "local_sgd", "gossip", "easgd", "downpour")
REPLICA = tuple(s for s in ALL if s != "sync")
NEW = ("gossip", "easgd", "downpour")
D, H, PER = 8, 16, 8
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6      # tests/test_strategies.py
PARAM_RTOL, PARAM_ATOL = 2e-5, 1e-6


def _problem(seed, R):
    """(params0, batch(step, flat)) in numpy: tests/conftest.py's MLP."""
    rng = np.random.default_rng(seed)
    params0 = {"w1": (0.3 * rng.standard_normal((D, H))).astype(np.float32),
               "w2": (0.3 * rng.standard_normal((H, 1))).astype(np.float32)}
    wtrue = (0.5 * rng.standard_normal((D, H))).astype(np.float32)

    def batch(step, flat=False):
        x = np.random.default_rng((seed, step)).standard_normal((R, PER, D)).astype(
            np.float32)
        b = {"x": x, "y": (np.tanh(x @ wtrue).sum(-1, keepdims=True) * 0.3).astype(
            np.float32)}
        return {k: v.reshape((R * PER,) + v.shape[2:]) for k, v in b.items()} if flat else b

    return params0, batch


def _jax_loss(params, b):
    return jnp.mean((jnp.tanh(b["x"] @ params["w1"]) @ params["w2"] - b["y"]) ** 2), {}


def _loss(params, b):
    return torch.mean((torch.tanh(b["x"] @ params["w1"]) @ params["w2"] - b["y"]) ** 2), {}


def _cfg_kw(n_steps, R, b_max=4, **kw):
    return dict(n_replicas=R, global_world=4 * R, b_max=b_max, warmup_steps=n_steps // 10,
                cooldown_steps=n_steps // 10, total_steps=n_steps, **kw)


def _make(package, name, n_steps, *, R=2, loss_window=10, strat_kw=None, **cfg_kw):
    """tests/test_strategies.py::_make in either package."""
    ex, dmod, opt = ((jexecutor, jdaso, jopt.sgd) if package == "jax"
                     else (executor, daso, sgd))
    loss = _jax_loss if package == "jax" else _loss
    o = opt(momentum=0.9, weight_decay=1e-4)
    if name == "sync":
        return ex.make_strategy("sync", loss, o)
    cfg = dmod.DasoConfig(**_cfg_kw(n_steps, R, **cfg_kw))
    cls = ex.get_strategy(name)
    return ex.make_strategy(name, loss, o, cfg, **(strat_kw or {}),
                            controller=cls.make_controller(cfg, loss_window=loss_window))


def _data(package, batch, flat):
    conv = jnp.asarray if package == "jax" else torch.from_numpy
    return lambda step: {k: conv(v) for k, v in batch(step, flat).items()}


def _params(package, params0):
    conv = jnp.asarray if package == "jax" else torch.from_numpy
    return {k: conv(v) for k, v in params0.items()}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _assert_carry_close(tcarry, jcarry):
    got, want = leaves(tcarry), jax.tree.leaves(jcarry)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=PARAM_RTOL, atol=PARAM_ATOL)


def _assert_bit_exact(a, b):
    assert a.losses == b.losses
    assert a.metrics == b.metrics
    ca, cb = leaves(a.carry), leaves(b.carry)
    assert len(ca) == len(cb)
    for x, y in zip(ca, cb):
        assert x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
    for x, y in zip(leaves(a.params), leaves(b.params)):
        assert torch.equal(x, y)


# -- the registry ---------------------------------------------------------------

def test_every_registered_strategy_is_covered():
    """The battery's list is the registry (hier_daso has its own suite,
    tests/test_torch_topology.py), and the registry is the reference's."""
    import repro.topo  # noqa: F401  (registers the reference's hier_daso)
    import repro_torch.topo  # noqa: F401
    assert set(executor.list_strategies()) - {"hier_daso"} == set(ALL)
    assert executor.list_strategies() == jexecutor.list_strategies()


# -- macro == per-step, and against the reference -------------------------------

@pytest.mark.parametrize("name", ALL)
def test_macro_matches_per_step_bit_exact(name):
    n_steps = 30
    params0, batch = _problem(0, 2)
    runs = []
    for kind in ("macro", "per_step"):
        strat = _make("port", name, n_steps)
        args = (strat, _params("port", params0), _data("port", batch, name == "sync"),
                constant_lr(0.1), n_steps)
        runs.append(executor.run_compiled_training(*args) if kind == "macro"
                    else run_per_step_training(*args))
    _assert_bit_exact(*runs)
    if runs[0].controller is not None:
        assert [h[1] for h in runs[0].controller.history] == \
            [h[1] for h in runs[1].controller.history]


def _run_both(name, n_steps, *, R=4, seed=1, lr=0.02, **kw):
    params0, batch = _problem(seed, R)
    out = {}
    for package in ("jax", "port"):
        strat = _make(package, name, n_steps, R=R, **kw)
        ex = jexecutor if package == "jax" else executor
        out[package] = ex.run_compiled_training(
            strat, _params(package, params0), _data(package, batch, False),
            (jax_constant_lr if package == "jax" else constant_lr)(lr), n_steps)
    return out["port"], out["jax"]


@pytest.mark.parametrize("name,wire", [("gossip", None), ("gossip", "int8"), ("easgd", None),
                                       ("downpour", None), ("downpour", "bf16")])
def test_baseline_matches_the_reference(name, wire):
    """40 steps at R = 4 on both packages' macro executors: the same mode
    history and cycle counts, losses and the final params within the
    reference's tolerances between its executors. lr 0.02: a DOWNPOUR push
    adds the sum of R deltas, which at lr 0.05 diverges and grows a
    last-bit difference of the two frameworks' matmuls past any tolerance."""
    tres, jres = _run_both(name, 40, wire_format=wire)
    assert [h[1:] for h in tres.controller.history] == \
        [h[1:] for h in jres.controller.history]
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    for f in ("dispatches", "steps", "cycles", "compiles", "fallback_steps"):
        assert getattr(tres.executor_stats, f) == getattr(jres.executor_stats, f), f
    assert tres.sync_fraction == jres.sync_fraction
    for a, b in zip(leaves(tres.params), jax.tree.leaves(jres.params), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL)


# -- gossip_mix ---------------------------------------------------------------

def _mix_tree(R, seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((R, 5, 3)).astype(np.float32),
            "h": rng.standard_normal((R, 300)).astype(jnp.bfloat16),
            "n": rng.integers(-50, 50, (R, 4)).astype(np.int32)}


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype.kind == "f" else a


def _to_torch(x):
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _from_torch(t):
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
def test_gossip_mix_bit_exact_with_the_reference(wire):
    """Every shift of R = 2, 3, 4, masks None / one dead / a dead pair, the
    int8 tier at block 64 (ragged last blocks on every leaf)."""
    for R in (2, 3, 4):
        tree = _mix_tree(R, R)
        masks = [None] + [tuple(0.0 if i in dead else 1.0 for i in range(R))
                          for dead in ((1,), (0, 2)) if max(dead) < R and len(dead) < R]
        for shift in range(1, R):
            for mask in masks:
                for block in ((64,) if wire == "int8" else (256,)):
                    want = jbaselines.gossip_mix(jax.tree.map(jnp.asarray, tree), shift=shift,
                                                 wire_format=wire, int8_block=block, mask=mask)
                    got = baselines.gossip_mix({k: _to_torch(v) for k, v in tree.items()},
                                               shift=shift, wire_format=wire,
                                               int8_block=block, mask=mask)
                    for k in tree:
                        assert got[k].shape == tree[k].shape
                        np.testing.assert_array_equal(_bits(_from_torch(got[k])),
                                                      _bits(want[k]), err_msg=str(
                                                          (R, shift, mask, block, k)))


def test_gossip_mix_refuses_a_shift_outside_the_ring():
    with pytest.raises(ValueError, match="outside 1..3"):
        baselines.gossip_mix({"w": torch.zeros(4, 2)}, shift=4)


# -- one step of each EASGD / DOWNPOUR mode -----------------------------------

def _carry_np(seed, R):
    """(params, sgd momentum state, center / anchor) with distinct rows, and
    a batch."""
    rng = np.random.default_rng(seed)
    params0, batch = _problem(seed, R)

    def rows(scale=1.0):
        return {k: (scale * v[None] + 0.05 * rng.standard_normal((R,) + v.shape)).astype(
            np.float32) for k, v in params0.items()}
    return (rows(), {"mu": rows(0.0)}, rows()), batch(0)


@pytest.mark.parametrize("mask", [None, (1.0, 0.0, 1.0, 1.0)], ids=["all", "masked"])
@pytest.mark.parametrize("name,mode", [("easgd", "local"), ("easgd", "blocking"),
                                       ("easgd", "elastic"), ("downpour", "local"),
                                       ("downpour", "blocking"), ("downpour", "push")])
def test_baseline_step_matches_the_reference(name, mode, mask):
    """One step from the same carry (params, momentum, center / anchor with
    distinct rows) in both packages: the carry within rtol 2e-5 / atol
    1e-6 (the two frameworks' matmuls differ in the last bits of the local
    step; the exchange arithmetic alone is held bit for bit below), and a
    dropped replica's param and momentum rows bit for bit the ones it
    had."""
    R = 4
    carry, b = _carry_np(7, R)
    kw = dict(alpha=0.1) if name == "easgd" else dict(push_scale=0.5)
    out = {}
    for package in ("jax", "port"):
        if package == "jax":
            fn = getattr(jbaselines, f"{name}_train_step")
            cfg = jdaso.DasoConfig(n_replicas=R, global_world=4 * R)
            step = fn(_jax_loss, jopt.sgd(momentum=0.9), cfg, mode=mode, membership=mask, **kw)
            out[package] = step(*jax.tree.map(jnp.asarray, carry),
                                jax.tree.map(jnp.asarray, b), jnp.asarray(0.1, jnp.float32))
        else:
            fn = getattr(baselines, f"{name}_train_step")
            cfg = daso.DasoConfig(n_replicas=R, global_world=4 * R)
            step = fn(_loss, sgd(momentum=0.9), cfg, mode=mode, membership=mask, **kw)
            out[package] = step(*jax.tree.map(torch.from_numpy, carry),
                                jax.tree.map(torch.from_numpy, b),
                                torch.tensor(0.1, dtype=torch.float32))
    got, want = out["port"], out["jax"]
    for a, w in zip(got[:3], want[:3]):
        _assert_carry_close(a, w)
    np.testing.assert_allclose(float(got[3]["loss"]), float(want[3]["loss"]), rtol=1e-6)
    if mask is not None:
        for slot in range(2):  # params, momentum: the dead row frozen
            for a, c in zip(leaves(got[slot]), jax.tree.leaves(carry[slot]), strict=True):
                np.testing.assert_array_equal(a[1].numpy(), c[1])


@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("mask", [None, (1.0, 0.0, 1.0, 1.0)], ids=["all", "masked"])
@pytest.mark.parametrize("name,mode", [("easgd", "elastic"), ("easgd", "blocking"),
                                       ("downpour", "push"), ("downpour", "blocking"),
                                       ("gossip", "gossip"), ("gossip", "blocking")])
def test_per_leaf_baseline_step_is_the_fused_step(name, mode, mask, wire):
    """One exchange step of each baseline with exchange_impl="per_leaf":
    the fused step's carry and metrics bit for bit (EASGD's and DOWNPOUR's
    means and every blocking step leaf by leaf; gossip's partner copy stays
    fused, as the reference's takes no impl)."""
    R = 4
    carry, b = _carry_np(3, R)
    kw = {"easgd": dict(alpha=0.1), "downpour": dict(push_scale=0.5),
          "gossip": dict(shift=1)}[name]
    out = []
    for impl in ("fused", "per_leaf"):
        cfg = daso.DasoConfig(n_replicas=R, global_world=4 * R, wire_format=wire,
                              exchange_impl=impl)
        step = getattr(baselines, f"{name}_train_step")(_loss, sgd(momentum=0.9), cfg,
                                                       mode=mode, membership=mask, **kw)
        slots = carry[:2] if name == "gossip" else carry
        out.append(step(*jax.tree.map(torch.from_numpy, slots),
                        jax.tree.map(torch.from_numpy, b),
                        torch.tensor(0.1, dtype=torch.float32)))
    for a, c in zip(leaves(out[0][:-1]), leaves(out[1][:-1]), strict=True):
        assert torch.equal(a, c)
    assert {k: v.tolist() for k, v in out[0][-1].items()} == \
        {k: v.tolist() for k, v in out[1][-1].items()}


@pytest.mark.parametrize("name,wire", [("easgd", None), ("downpour", "bf16")])
def test_per_leaf_baseline_matches_the_reference(name, wire):
    """EASGD and DOWNPOUR with both packages' per-leaf exchanges: the
    reference's mode history, losses and params within its tolerances."""
    tres, jres = _run_both(name, 24, wire_format=wire, exchange_impl="per_leaf")
    assert [h[1:] for h in tres.controller.history] == \
        [h[1:] for h in jres.controller.history]
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    for a, b in zip(leaves(tres.params), jax.tree.leaves(jres.params), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL)


@pytest.mark.parametrize("mask", [None, (1.0, 0.0, 1.0, 1.0)], ids=["all", "masked"])
def test_elastic_and_push_arithmetic_bit_exact_with_the_reference(mask):
    """The exchange alone: a loss without gradient and sgd without momentum
    or decay leave the local step exact, so the elastic pull and center
    update ``(1-a) x + a c`` and the push ``a + s n d`` are compared bit for
    bit (the reference's XLA does not contract them to an FMA on the
    CPU)."""
    R, rng = 4, np.random.default_rng(9)
    params, center = ({"w": rng.standard_normal((R, 700)).astype(np.float32)}
                      for _ in range(2))
    opt, b = {"mu": {"w": np.zeros((R, 700), np.float32)}}, {"x": np.zeros((R, 1), np.float32)}
    for name, mode, kw in (("easgd", "elastic", dict(alpha=0.1)),
                           ("downpour", "push", dict(push_scale=0.7))):
        out = []
        for mod, dm, opt_fn, loss, conv, lr in (
                (jbaselines, jdaso, jopt.sgd, lambda p, _: (jnp.sum(p["w"]) * 0.0, {}),
                 jnp.asarray, jnp.float32(0.1)),
                (baselines, daso, sgd, lambda p, _: (torch.sum(p["w"]) * 0.0, {}),
                 torch.from_numpy, torch.tensor(0.1))):
            step = getattr(mod, f"{name}_train_step")(
                loss, opt_fn(momentum=0.0, weight_decay=0.0),
                dm.DasoConfig(n_replicas=R, global_world=4 * R), mode=mode, membership=mask,
                **kw)
            out.append(step(*(jax.tree.map(conv, t) for t in (params, opt, center, b)), lr))
        for slot in (0, 2):
            np.testing.assert_array_equal(_bits(out[1][slot]["w"].numpy()),
                                          _bits(out[0][slot]["w"]))


# -- the schedule ---------------------------------------------------------------

@pytest.mark.parametrize("name", NEW)
def test_new_strategies_schedule_shape(name):
    """Blocking warm-up / cool-down, one exchange token every B cycling
    steps, locals between, gossip's shift rotating 1, 2, 3 at R = 4."""
    n_steps = 40
    params0, batch = _problem(1, 4)
    strat = _make("port", name, n_steps, R=4)
    executor.run_compiled_training(strat, _params("port", params0), _data("port", batch, False),
                                   constant_lr(0.05), n_steps)
    modes = [h[1] for h in strat.controller.history]
    warm = n_steps // 10
    assert modes[:warm] == ["blocking"] * warm and modes[-warm:] == ["blocking"] * warm
    cycling = modes[warm:-warm]
    token = {"gossip": "gossip~", "easgd": "elastic", "downpour": "push"}[name]
    exchanges = [m for m in cycling if m.startswith(token)]
    assert exchanges and all(m.startswith(token) or m == "local" for m in cycling)
    assert [m.startswith(token) for m in cycling[:8]] == [True, False, False, False] * 2
    if name == "gossip":
        assert [int(m.split("~")[1]) for m in exchanges][:3] == [1, 2, 3]
        assert strat.controller.state_dict()["_n_ex"] == len(exchanges)
    assert 0.0 < strat.sync_fraction() < 1.0


# -- checkpoints ------------------------------------------------------------------

def _loop_run(package, name, n_steps, tmp=None, *, seed=2, R=2, **kw):
    params0, batch = _problem(seed, R)
    loop_kw = dict(strategy=name, n_steps=n_steps, n_replicas=R, local_world=2, b_max=4,
                   lr=0.1, loss_window=10, **kw)
    if package == "jax":
        return jloop.run_training(_jax_loss, _params("jax", params0),
                                  _data("jax", batch, name == "sync"),
                                  jloop.TrainLoopConfig(**loop_kw), log=None)
    return loop.run_training(_loss, _params("port", params0),
                             _data("port", batch, name == "sync"),
                             loop.TrainLoopConfig(device="cpu", **loop_kw), log=None)


@pytest.mark.parametrize("name", ALL)
def test_checkpoint_resume_bit_exact(name, tmp_path):
    """A run resumed from its first TrainState gives the uninterrupted
    run's losses and final carry bit for bit (gossip's ring shift goes on
    from the checkpoint's `_n_ex`)."""
    full = _loop_run("port", name, 24)
    ck = _loop_run("port", name, 24, ckpt_every=8, ckpt_dir=str(tmp_path))
    assert full.losses == ck.losses
    saved = sorted(os.listdir(tmp_path))
    assert saved
    resumed = _loop_run("port", name, 24, resume_from=str(tmp_path / saved[0]))
    assert resumed.losses == full.losses
    for a, b in zip(leaves(resumed.carry), leaves(full.carry), strict=True):
        assert torch.equal(a, b)
    if name == "gossip":
        sd = io.load_train_state(str(tmp_path / saved[0]), device="cpu").controller
        assert sd["_n_ex"] > 0
        assert [h[1] for h in resumed.controller.history] == \
            [h[1] for h in full.controller.history]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("name", NEW)
def test_baseline_train_state_resumes_in_the_other_package(name, writer, tmp_path):
    """A TrainState of each baseline written by one package and resumed by
    the other: the resumed run's mode history is the writer's uninterrupted
    one, and its losses and params agree with it within the executors'
    tolerances (the reference copies the center / anchor, the port
    aliases the params; either layout loads)."""
    reader = "port" if writer == "jax" else "jax"
    fresh = _loop_run(writer, name, 24)
    _loop_run(writer, name, 24, ckpt_every=9, ckpt_dir=str(tmp_path))
    path = (jio if writer == "jax" else io).list_train_state_dirs(str(tmp_path))[-1]
    resumed = _loop_run(reader, name, 24, resume_from=path)
    assert [h[1] for h in resumed.controller.history] == \
        [h[1] for h in fresh.controller.history]
    np.testing.assert_allclose(resumed.losses, fresh.losses, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    got = leaves(resumed.params) if reader == "port" else jax.tree.leaves(resumed.params)
    want = leaves(fresh.params) if writer == "port" else jax.tree.leaves(fresh.params)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(_np(a), _np(b), rtol=PARAM_RTOL, atol=PARAM_ATOL)


def test_checkpoint_rejects_strategy_mismatch(tmp_path):
    _loop_run("port", "gossip", 12, ckpt_every=4, ckpt_dir=str(tmp_path))
    saved = sorted(os.listdir(tmp_path))[0]
    with pytest.raises(ValueError, match="gossip"):
        _loop_run("port", "easgd", 12, resume_from=str(tmp_path / saved))


# -- fault plans ------------------------------------------------------------------

PLAN = [{"step": 8, "kind": "crash", "replica": 3}, {"step": 16, "kind": "rejoin", "replica": 3}]


@pytest.mark.parametrize("name", REPLICA)
def test_fault_plan_crash_rejoin_matches_the_reference(name):
    """tests/test_strategies.py:164 in both packages: 32 steps at R = 4,
    replica 3 down from step 8 to 16. The same membership timeline,
    invalidations, history and applied events; losses and params within
    the executors' tolerances (lr 0.02, as in
    `test_baseline_matches_the_reference`)."""
    n_steps = 32
    params0, batch = _problem(4, 4)
    out = {}
    for package in ("jax", "port"):
        strat = _make(package, name, n_steps, R=4)
        run, plan = ((jax_run_with_faults, JaxFaultPlan) if package == "jax"
                     else (run_with_faults, FaultPlan))
        out[package] = run(strat, _params(package, params0), _data(package, batch, False),
                           (jax_constant_lr if package == "jax" else constant_lr)(0.02),
                           n_steps, plan.from_dicts(PLAN))
    got, want = out["port"], out["jax"]
    assert got.invalidations == want.invalidations == 2
    assert got.membership_timeline == want.membership_timeline == [
        (0, (1.0,) * 4), (8, (1.0, 1.0, 1.0, 0.0)), (16, (1.0,) * 4)]
    assert [(e["step"], e["kind"], e["replica"]) for e in got.applied] == \
        [(e["step"], e["kind"], e["replica"]) for e in want.applied]
    assert [h[1] for h in got.result.controller.history] == \
        [h[1] for h in want.result.controller.history]
    np.testing.assert_allclose(got.result.losses, want.result.losses, rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    for a, b in zip(leaves(got.result.params), jax.tree.leaves(want.result.params),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=PARAM_RTOL, atol=PARAM_ATOL)


def test_fault_plan_rejects_sync():
    params0, batch = _problem(5, 2)
    strat = _make("port", "sync", 8)
    with pytest.raises(ValueError, match="replica-axis"):
        run_with_faults(strat, _params("port", params0), _data("port", batch, True),
                        constant_lr(0.05), 8, FaultPlan())


# -- property tests ---------------------------------------------------------------

@settings(max_examples=8, deadline=None)
@given(r=st.integers(2, 5), n_rounds=st.integers(1, 6), seed=st.integers(0, 99))
def test_gossip_preserves_global_mean(r, n_rounds, seed):
    """Pairwise gossip keeps the exact global mean under any shift
    schedule: on eighths every f32 add and halving is exact, so the mean is
    compared bit for bit in f64."""
    rng = np.random.default_rng(seed)
    shifts = rng.integers(1, r, size=n_rounds)
    tree = {"w": torch.from_numpy(rng.integers(-64, 64, size=(r, 5, 3)).astype(np.float32) / 8),
            "b": torch.from_numpy(rng.integers(-64, 64, size=(r, 7)).astype(np.float32) / 8)}
    want = {k: v.double().mean(0) for k, v in tree.items()}
    for s in shifts:
        tree = baselines.gossip_mix(tree, shift=int(s), wire_format="f32")
    for k in want:
        assert torch.equal(tree[k].double().mean(0), want[k])


@settings(max_examples=6, deadline=None)
@given(alpha=st.sampled_from([0.25, 0.125, 0.0625]), b_max=st.integers(1, 4),
       grad=st.sampled_from([0.5, -0.25, 1.5]))
def test_easgd_center_closed_form(alpha, b_max, grad):
    """For a constant gradient EASGD's params and center follow the scalar
    f32 recursion bit for bit (R = 2 with identical rows, so the mean is
    the row)."""
    R, n_steps, lr = 2, 16, 0.25
    cfg = daso.DasoConfig(n_replicas=R, global_world=4 * R, b_max=b_max, warmup_steps=0,
                          cooldown_steps=0, total_steps=n_steps, wire_format="f32")

    def loss_fn(params, batch):
        return torch.sum(params["w"]) * grad, {}

    cls = executor.get_strategy("easgd")
    strat = executor.make_strategy("easgd", loss_fn, sgd(momentum=0.0, weight_decay=0.0),
                                   cfg, alpha=alpha, controller=cls.make_controller(cfg))
    carry = strat.init_carry({"w": torch.tensor([1.0])})
    batch = {"x": torch.zeros(R, 1, 1)}
    for t in range(n_steps):
        mode, stale = strat.next_mode(t)
        carry, _ = strat.step_fn(mode, stale)(carry, batch, torch.tensor(lr))
    a32, beta32 = np.float32(alpha), np.float32(alpha * R)
    p = c = np.float32(1.0)
    g, lr32 = np.float32(grad), np.float32(lr)
    last_ex = -10 ** 9
    for t in range(n_steps):
        p = np.float32(p - lr32 * g)
        if t - last_ex >= b_max:
            last_ex = t
            m = p
            p = np.float32((np.float32(1.0) - a32) * p + a32 * c)
            c = np.float32((np.float32(1.0) - beta32) * c + beta32 * m)
    np.testing.assert_array_equal(carry[0]["w"].numpy(), np.full((R, 1), p, np.float32))
    np.testing.assert_array_equal(carry[2]["w"].numpy(), np.full((R, 1), c, np.float32))


# -- refusals and sizing -------------------------------------------------------

def test_get_strategy_suggests_closest():
    with pytest.raises(KeyError) as ei:
        executor.get_strategy("gosip")
    assert str(sorted(executor.list_strategies())) in str(ei.value)
    assert "did you mean 'gossip'?" in str(ei.value)
    with pytest.raises(KeyError) as ei:
        executor.get_strategy("qqqqqq")
    assert "did you mean" not in str(ei.value)


def test_new_strategies_reject_overlap_and_tiny_worlds():
    opt = sgd()
    cfg = daso.DasoConfig(n_replicas=2, global_world=8, b_max=4, overlap="one_cycle")
    for name in NEW:
        with pytest.raises(ValueError, match="overlap"):
            executor.make_strategy(name, _loss, opt, cfg)
    cfg1 = daso.DasoConfig(n_replicas=1, global_world=4, b_max=4)
    for name in NEW:
        with pytest.raises(ValueError, match="n_replicas"):
            executor.make_strategy(name, _loss, opt, cfg1)
    cfg4 = daso.DasoConfig(n_replicas=4, global_world=16, b_max=4)
    with pytest.raises(ValueError, match="alpha"):
        executor.make_strategy("easgd", _loss, opt, cfg4, alpha=0.5)
    with pytest.raises(ValueError, match="push_scale"):
        executor.make_strategy("downpour", _loss, opt, cfg4, push_scale=0.0)
    with pytest.raises(TypeError, match="periodic controller"):
        executor.make_strategy("gossip", _loss, opt, cfg4,
                               controller=executor.get_strategy("daso").make_controller(cfg4))
    assert executor.make_strategy("easgd", _loss, opt, cfg4).alpha == 0.5 / 4


@pytest.mark.parametrize("name", NEW)
def test_topology_sizes_the_baselines_as_the_reference(name):
    """A 2-level spec gives R, P and b_max (a pinned %period); a spec with
    an intermediate level is refused with the reference's message."""
    two = "chip:2 x pod:3%2"
    t = loop.build_strategy(_loss, loop.TrainLoopConfig(strategy=name, topology=two), sgd())
    j = jloop.build_strategy(_jax_loss, jloop.TrainLoopConfig(strategy=name, topology=two),
                             jopt.sgd())
    assert type(t).__name__ == type(j).__name__ and t.name == name
    assert (t.cfg.n_replicas, t.cfg.global_world, t.cfg.b_max) == \
        (j.cfg.n_replicas, j.cfg.global_world, j.cfg.b_max) == (3, 6, 2)
    three = "chip:2 x host:2 x pod:2"
    msgs = []
    for mod, loss, opt in ((loop, _loss, sgd()), (jloop, _jax_loss, jopt.sgd())):
        with pytest.raises(ValueError, match="intermediate levels") as ei:
            mod.build_strategy(loss, mod.TrainLoopConfig(strategy=name, topology=three), opt)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="does not take one"):
        loop.build_strategy(_loss, loop.TrainLoopConfig(strategy="local_sgd", topology=two),
                            sgd())


def test_launcher_trains_a_baseline_on_a_topology(tmp_path):
    """`--strategy gossip --topology` (2 levels) runs and writes its
    metrics; `--topology` with three levels is refused."""
    from repro_torch.launch import train as launch_train
    out = tmp_path / "m.json"
    res = launch_train.main(["--tiny", "--device", "cpu", "--strategy", "gossip",
                             "--topology", "chip:2 x pod:3", "--steps", "12",
                             "--per-node-batch", "2", "--seq-len", "16",
                             "--metrics-out", str(out)])
    m = json.loads(out.read_text())
    assert len(m["losses"]) == 12 and res.controller.cfg.n_replicas == 3
    assert any(h[1].startswith("gossip~") for h in res.controller.history)
    with pytest.raises(ValueError, match="intermediate levels"):
        launch_train.main(["--tiny", "--device", "cpu", "--strategy", "easgd",
                           "--topology", "chip:2 x host:2 x pod:2", "--steps", "4"])
