"""The port's macro-cycle executor held against the JAX package on the CPU
(twins of tests/test_executor.py and of the executor tests of
tests/test_overlap.py), and against the port's own per-step path:

  * macro against the JAX macro path for daso, sync and local_sgd: the
    same mode history and ExecutorStats counts, losses within rtol 1e-5 /
    atol 1e-6, params within rtol 2e-5 / atol 1e-6 (the reference's own
    tolerances between its two executors);
  * port macro == port per-step, bit for bit, carry included, for daso,
    sync, local_sgd, daso under one_cycle (f32 and int8 wires) and daso
    with n_micro = 2;
  * one dispatch per cycling cycle, one program per shape, the tail
    fallback and `invalidate`, each count equal to the reference's;
  * `plan_cycle` against the JAX controller's over whole runs (warm-up,
    cycling, plateau window cuts, cool-down; overlap off and on);
  * the overlap dispatch: `overlap_cycle` against the JAX strategy's, the
    timing legs partitioning the wall with and without `serial_exchange`,
    and `serial_exchange` changing no number;
  * `microbatched_value_and_grad` at n_micro 1, 2 and 4 and
    `replica_divergence` against JAX's within 1e-6, `track_divergence` on
    both executors;
  * the port's fused exchange on a 5-leaf model against JAX's per-leaf
    exchange (`exchange_impl="per_leaf"`, the reference's oracle) on both
    executors, overlap off and one_cycle: losses within rtol 1e-4, the
    same mode history; the port's per-leaf exchange against its fused one
    bit for bit (both executors, overlap off and one_cycle) and against
    JAX's per-leaf one within those tolerances, and a per-leaf run resumed
    from a TrainState bit for bit.

The problem is tests/conftest.py's MLP made with numpy: params {"w1",
"w2"}, batches drawn per step from a seeded generator, the same arrays
into both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import daso as jdaso
from repro.core import executor as jexecutor
from repro.core import schedule as jschedule
from repro.core.simulator import run_per_step_training as jax_run_per_step
from repro.optim import optimizers as jopt
from repro.optim.schedules import constant_lr as jax_constant_lr
from repro_torch.core import daso, executor, schedule
from repro_torch.core.simulator import run_per_step_training
from repro_torch.optim.optimizers import sgd
from repro_torch.optim.schedules import constant_lr
from repro_torch.tree import leaves

D, H, PER = 8, 16, 16
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6      # tests/test_executor.py
PARAM_RTOL, PARAM_ATOL = 2e-5, 1e-6
STAT_FIELDS = ("dispatches", "steps", "cycles", "compiles", "fallback_steps",
               "invalidations", "overlap_cycles")


def _problem(seed, R=2):
    """(params0 numpy, batch(step, flat) numpy): tests/conftest.py's MLP."""
    rng = np.random.default_rng(seed)
    params0 = {"w1": (0.3 * rng.standard_normal((D, H))).astype(np.float32),
               "w2": (0.3 * rng.standard_normal((H, 1))).astype(np.float32)}
    wtrue = (0.5 * rng.standard_normal((D, H))).astype(np.float32)

    def batch(step, flat=False):
        x = np.random.default_rng((seed, step)).standard_normal(
            (R, PER, D)).astype(np.float32)
        y = (np.tanh(x @ wtrue).sum(-1, keepdims=True) * 0.3).astype(np.float32)
        b = {"x": x, "y": y}
        return {k: v.reshape((R * PER,) + v.shape[2:]) for k, v in b.items()} if flat else b

    return params0, batch


def _jax_loss(params, batch):
    pred = jnp.tanh(batch["x"] @ params["w1"]) @ params["w2"]
    return jnp.mean((pred - batch["y"]) ** 2), {}


def _loss(params, batch):
    pred = torch.tanh(batch["x"] @ params["w1"]) @ params["w2"]
    return torch.mean((pred - batch["y"]) ** 2), {}


def _kw(n_steps, R=2, b_max=4, warm=True, **kw):
    base = dict(n_replicas=R, global_world=4 * R, b_max=b_max)
    if warm:
        base.update(warmup_steps=n_steps // 10, cooldown_steps=n_steps // 10,
                    total_steps=n_steps)
    base.update(kw)
    return base


def _strategies(name, n_steps, *, loss_window=10, n_micro=1, **cfg_kw):
    """The same strategy in both packages (tests/test_executor.py::_make)."""
    jo, to = jopt.sgd(momentum=0.9, weight_decay=1e-4), sgd(momentum=0.9, weight_decay=1e-4)
    if name == "sync":
        return (jexecutor.make_strategy("sync", _jax_loss, jo, n_micro=n_micro),
                executor.make_strategy("sync", _loss, to, n_micro=n_micro))
    jcfg, tcfg = jdaso.DasoConfig(**_kw(n_steps, **cfg_kw)), daso.DasoConfig(**_kw(n_steps, **cfg_kw))
    return (jexecutor.make_strategy(name, _jax_loss, jo, jcfg, n_micro=n_micro,
                                    controller=jschedule.DasoController(
                                        jcfg, loss_window=loss_window)),
            executor.make_strategy(name, _loss, to, tcfg, n_micro=n_micro,
                                   controller=schedule.DasoController(
                                       tcfg, loss_window=loss_window)))


def _data(batch, flat, framework):
    conv = jnp.asarray if framework == "jax" else torch.from_numpy
    return lambda step: {k: conv(v) for k, v in batch(step, flat).items()}


def _run_jax(name, n_steps, *, seed=0, ex_kw=None, **kw):
    params0, batch = _problem(seed)
    jstrat, _ = _strategies(name, n_steps, **kw)
    ex = jexecutor.MacroCycleExecutor(jstrat, **(ex_kw or {}))
    return jexecutor.run_compiled_training(
        jstrat, jax.tree.map(jnp.asarray, params0), _data(batch, name == "sync", "jax"),
        jax_constant_lr(0.1), n_steps, executor=ex)


def _run(name, n_steps, executor_kind="macro", *, seed=0, ex_kw=None,
         track_divergence=False, **kw):
    params0, batch = _problem(seed)
    _, strat = _strategies(name, n_steps, **kw)
    args = (strat, {k: torch.from_numpy(v) for k, v in params0.items()},
            _data(batch, name == "sync", "torch"), constant_lr(0.1), n_steps)
    if executor_kind == "per_step":
        return run_per_step_training(*args, track_divergence=track_divergence)
    ex = executor.MacroCycleExecutor(strat, **(ex_kw or {}))
    return executor.run_compiled_training(*args, executor=ex,
                                          track_divergence=track_divergence)


def _stats(s):
    return {f: getattr(s, f) for f in STAT_FIELDS}


def _assert_close_to_jax(tres, jres):
    np.testing.assert_allclose(np.asarray(tres.losses, np.float32),
                               np.asarray(jres.losses, np.float32),
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    got, want = leaves(tres.params), jax.tree.leaves(jres.params)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL)
    if jres.controller is not None:
        assert [h[1:] for h in tres.controller.history] == \
            [h[1:] for h in jres.controller.history]


def _assert_bit_exact(a, b):
    assert a.losses == b.losses
    assert a.metrics == b.metrics
    ca, cb = leaves(a.carry), leaves(b.carry)
    assert len(ca) == len(cb)
    for x, y in zip(ca, cb):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)
    for x, y in zip(leaves(a.params), leaves(b.params)):
        assert torch.equal(x, y)


# -- equivalence ------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["daso", "sync", "local_sgd"])
def test_macro_matches_jax_macro(strategy):
    """tests/test_executor.py:37, held across the two packages: the same
    schedule and executor counts, numbers within the reference's tolerances
    between its executors."""
    jres = _run_jax(strategy, 60)
    tres = _run(strategy, 60)
    _assert_close_to_jax(tres, jres)
    assert _stats(tres.executor_stats) == _stats(jres.executor_stats)
    assert tres.executor_stats.dispatches < 60


@pytest.mark.parametrize("strategy,kw", [
    ("daso", {}), ("sync", {}), ("local_sgd", {}),
    ("daso", {"overlap": "one_cycle"}),
    ("daso", {"overlap": "one_cycle", "wire_format": "int8", "int8_block": 64}),
    ("daso", {"n_micro": 2})],
    ids=["daso", "sync", "local_sgd", "overlap", "overlap_int8", "n_micro2"])
def test_macro_matches_per_step_bit_exact(strategy, kw):
    """The macro path changes how steps are dispatched, not what they
    compute: losses, per-step metrics, the final carry and params bit for
    bit equal to the per-step path's."""
    macro = _run(strategy, 40, **kw)
    ref = _run(strategy, 40, "per_step", **kw)
    _assert_bit_exact(macro, ref)
    if "overlap" in kw:
        assert macro.executor_stats.overlap_cycles > 0
        assert len(macro.carry) == 4


def test_n_micro_daso_run_matches_jax():
    """A DASO run with n_micro = 2 on both packages' macro paths."""
    jres = _run_jax("daso", 40, n_micro=2)
    tres = _run("daso", 40, n_micro=2)
    _assert_close_to_jax(tres, jres)
    assert _stats(tres.executor_stats) == _stats(jres.executor_stats)


# -- the fused exchange against JAX's per-leaf exchange ---------------------------------

def _multi_leaf_problem(seed, R=2, per=8, d=6):
    """tests/test_executor.py::_multi_leaf_problem made with numpy: 5 leaves
    in 2 nested dicts, so the fused arena coalesces leaves."""
    rng = np.random.default_rng(seed)

    def w(*shape, s=0.3):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    params0 = {"emb": w(d, 12), "mlp": {"w1": w(12, 8), "b1": w(8, s=0.1), "w2": w(8, 1)},
               "scale": w(1, s=0.1)}
    wtrue = w(d, 1, s=1.0)

    def batch(step):
        x = np.random.default_rng((seed, step)).standard_normal((R, per, d)).astype(np.float32)
        return {"x": x, "y": (np.tanh(x @ wtrue) * 0.5).astype(np.float32)}

    def jloss(params, b):
        h = jnp.tanh(b["x"] @ params["emb"])
        h = jnp.tanh(h @ params["mlp"]["w1"] + params["mlp"]["b1"])
        return jnp.mean((h @ params["mlp"]["w2"] * (1.0 + params["scale"]) - b["y"]) ** 2), {}

    def tloss(params, b):
        h = torch.tanh(b["x"] @ params["emb"])
        h = torch.tanh(h @ params["mlp"]["w1"] + params["mlp"]["b1"])
        return torch.mean((h @ params["mlp"]["w2"] * (1.0 + params["scale"]) - b["y"]) ** 2), {}

    return params0, batch, jloss, tloss


def _run_multi_leaf(framework, executor_kind, overlap, n_steps=40, impl="fused"):
    """JAX with its per-leaf exchange, the port with `impl`."""
    params0, batch, jloss, tloss = _multi_leaf_problem(7)
    kw = dict(n_replicas=2, global_world=8, b_max=4, warmup_steps=4, cooldown_steps=4,
              total_steps=n_steps, overlap=overlap)
    if framework == "jax":
        cfg = jdaso.DasoConfig(exchange_impl="per_leaf", **kw)
        strat = jexecutor.make_strategy("daso", jloss, jopt.sgd(momentum=0.9, weight_decay=1e-4),
                                        cfg, controller=jschedule.DasoController(
                                            cfg, loss_window=10))
        args = (strat, jax.tree.map(jnp.asarray, params0), _data(lambda t, f: batch(t), False,
                                                                 "jax"),
                jax_constant_lr(0.1), n_steps)
        return (jax_run_per_step(*args) if executor_kind == "per_step"
                else jexecutor.run_compiled_training(*args))
    cfg = daso.DasoConfig(exchange_impl=impl, **kw)
    strat = executor.make_strategy("daso", tloss, sgd(momentum=0.9, weight_decay=1e-4), cfg,
                                   controller=schedule.DasoController(cfg, loss_window=10))
    args = (strat, {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else
                        {kk: torch.from_numpy(vv) for kk, vv in v.items()})
                    for k, v in params0.items()},
            _data(lambda t, f: batch(t), False, "torch"), constant_lr(0.1), n_steps)
    return (run_per_step_training(*args) if executor_kind == "per_step"
            else executor.run_compiled_training(*args))


@pytest.mark.parametrize("overlap", ["off", "one_cycle"])
@pytest.mark.parametrize("executor_kind", ["macro", "per_step"])
def test_per_leaf_training_is_the_fused_training_bit_for_bit(executor_kind, overlap):
    """The port's per-leaf exchange (`exchange_impl="per_leaf"`) on the
    5-leaf model: the fused run's losses, metrics, whole carry and params
    bit for bit, on both executors and under one_cycle (the macro
    executor's overlap exchange and merge leaf by leaf)."""
    per_leaf = _run_multi_leaf("torch", executor_kind, overlap, impl="per_leaf")
    _assert_bit_exact(per_leaf, _run_multi_leaf("torch", executor_kind, overlap))
    if overlap == "one_cycle" and executor_kind == "macro":
        assert per_leaf.executor_stats.overlap_cycles > 0


@pytest.mark.parametrize("overlap", ["off", "one_cycle"])
def test_per_leaf_training_matches_jax_per_leaf_training(overlap):
    """Both packages' per-leaf exchanges on the macro executor: losses
    within rtol 1e-4, params within the reference's tolerances, the same
    mode history."""
    got = _run_multi_leaf("torch", "macro", overlap, impl="per_leaf")
    jres = _run_multi_leaf("jax", "macro", overlap)
    np.testing.assert_allclose(np.asarray(got.losses, np.float32),
                               np.asarray(jres.losses, np.float32), rtol=1e-4)
    for a, b in zip(leaves(got.params), jax.tree.leaves(jres.params), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=PARAM_RTOL, atol=PARAM_ATOL)
    assert [h[1:] for h in got.controller.history] == \
        [h[1:] for h in jres.controller.history]


def test_per_leaf_resume_is_bit_exact(tmp_path):
    """A per-leaf one_cycle run through `run_training` with TrainStates, resumed
    from the middle one: the uninterrupted run's losses and carry bit for
    bit (the carry's in-flight and pending slots hold the per-leaf mean's
    broadcast views when saved)."""
    from repro_torch.train.loop import TrainLoopConfig, run_training

    params0, batch = _problem(4)
    base = dict(strategy="daso", n_steps=32, n_replicas=2, loss_window=10, device="cpu",
                exchange_impl="per_leaf", overlap="one_cycle")

    def run(**kw):
        return run_training(_loss, {k: torch.from_numpy(v) for k, v in params0.items()},
                            _data(batch, False, "torch"), TrainLoopConfig(**base, **kw),
                            log=None)
    fresh = run()
    run(ckpt_every=8, ckpt_dir=str(tmp_path))
    from repro_torch.checkpoint import io
    states = io.list_train_state_dirs(str(tmp_path))
    resumed = run(resume_from=states[len(states) // 2])
    assert resumed.losses == fresh.losses
    for a, b in zip(leaves(resumed.carry), leaves(fresh.carry), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("overlap", ["off", "one_cycle"])
@pytest.mark.parametrize("executor_kind", ["macro", "per_step"])
def test_fused_training_matches_jax_per_leaf_training(executor_kind, overlap):
    """tests/test_executor.py:91's twin across the packages: on a 5-leaf
    model, with the default wire tiers (f32 cycling, bf16 blocking), the
    port's fused training gives JAX's per-leaf run within rtol 1e-4 (the
    loss trace) and the reference's parameter tolerances, with the same
    mode history."""
    fused = _run_multi_leaf("torch", executor_kind, overlap)
    jres = _run_multi_leaf("jax", executor_kind, overlap)
    np.testing.assert_allclose(np.asarray(fused.losses, np.float32),
                               np.asarray(jres.losses, np.float32), rtol=1e-4)
    for a, b in zip(leaves(fused.params), jax.tree.leaves(jres.params), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=PARAM_RTOL, atol=PARAM_ATOL)
    assert [h[1:] for h in fused.controller.history] == \
        [h[1:] for h in jres.controller.history]


# -- dispatch reduction -----------------------------------------------------------------

def test_cycling_phase_one_dispatch_per_cycle():
    """tests/test_executor.py:168: pure cycling, B = 4, W = 1: each
    (send, receive, local, local) cycle is one dispatch."""
    kw = dict(warm=False, loss_window=10 ** 9)
    tres = _run("daso", 40, **kw)
    jres = _run_jax("daso", 40, **kw)
    st = tres.executor_stats
    assert st.steps + st.fallback_steps == 40
    assert st.cycles == 10 and st.dispatches == st.cycles
    assert st.dispatches_per_step() == pytest.approx(0.25)
    assert _stats(st) == _stats(jres.executor_stats)
    assert tres.metrics[0].keys() == {"loss"}
    assert len(tres.cycles) == 10 and all(len(s) == 4 for s, _ in tres.cycles)


def test_compile_cache_one_program_per_shape():
    """tests/test_executor.py:188: one program per distinct shape, reused."""
    params0, batch = _problem(2)
    jstrat, strat = _strategies("daso", 80)
    ex = executor.MacroCycleExecutor(strat)
    executor.run_compiled_training(strat, {k: torch.from_numpy(v) for k, v in params0.items()},
                                   _data(batch, False, "torch"), constant_lr(0.1), 80,
                                   executor=ex)
    jex = jexecutor.MacroCycleExecutor(jstrat)
    jexecutor.run_compiled_training(jstrat, jax.tree.map(jnp.asarray, params0),
                                    _data(batch, False, "jax"), jax_constant_lr(0.1), 80,
                                    executor=jex)
    shapes = set(ex.cached_shapes)
    assert ex.stats.compiles == len(shapes)
    assert ex.stats.cycles > len(shapes)
    assert shapes == set(jex.cached_shapes)
    assert _stats(ex.stats) == _stats(jex.stats)


def test_tail_fallback_avoids_single_use_program():
    """tests/test_executor.py:203: 10 cycles of 4 and a 2-step tail of a
    new shape, run step by step."""
    kw = dict(warm=False, loss_window=10 ** 9)
    tres = _run("daso", 42, **kw)
    jres = _run_jax("daso", 42, **kw)
    assert tres.executor_stats.fallback_steps == 2
    assert _stats(tres.executor_stats) == _stats(jres.executor_stats)
    _assert_bit_exact(tres, _run("daso", 42, "per_step", **kw))


def test_invalidate_drops_every_cached_part():
    """invalidate() drops programs, fallbacks and overlap parts; later
    cycles build them again and compute the same numbers."""
    params0, batch = _problem(4)
    n_steps = 24
    tp = {k: torch.from_numpy(v) for k, v in params0.items()}
    results, counts = [], []
    for framework in ("jax", "torch"):
        jstrat, strat = _strategies("daso", n_steps, overlap="one_cycle", loss_window=50)
        mod = jexecutor if framework == "jax" else executor
        s = jstrat if framework == "jax" else strat
        ex = mod.MacroCycleExecutor(s)
        p0 = jax.tree.map(jnp.asarray, params0) if framework == "jax" else tp
        lr = jax_constant_lr(0.1) if framework == "jax" else constant_lr(0.1)
        mod.run_compiled_training(s, p0, _data(batch, False, framework), lr, n_steps,
                                  executor=ex)
        dropped = ex.invalidate()
        assert not ex.cached_shapes and ex.stats.invalidations == 1
        counts.append(dropped)
        results.append(ex)
    assert counts[0] == counts[1] > 0
    # a second run on a rebuilt cache gives the first run's numbers
    first = _run("daso", n_steps, overlap="one_cycle", loss_window=50, seed=4)
    _, strat = _strategies("daso", n_steps, overlap="one_cycle", loss_window=50)
    ex = executor.MacroCycleExecutor(strat)
    ex.invalidate()
    again = executor.run_compiled_training(strat, tp, _data(batch, False, "torch"),
                                           constant_lr(0.1), n_steps, executor=ex)
    _assert_bit_exact(first, again)
    assert ex.stats.compiles == results[1].stats.compiles


def test_resume_from_a_cycle_boundary_is_bit_exact():
    """start_step and carry continue a run: 20 steps, then 20 more from the
    first call's carry with the same strategy (its controller at step 20),
    give the uninterrupted run's losses and carry."""
    kw = dict(overlap="one_cycle", loss_window=50)
    whole = _run("daso", 40, **kw)
    params0, batch = _problem(0)
    _, strat = _strategies("daso", 40, **kw)
    args = (strat, {k: torch.from_numpy(v) for k, v in params0.items()},
            _data(batch, False, "torch"), constant_lr(0.1))
    first = executor.run_compiled_training(*args, 20)
    rest = executor.run_compiled_training(*args, 40, start_step=20, carry=first.carry)
    assert first.losses + rest.losses == whole.losses
    for a, b in zip(leaves(rest.carry), leaves(whole.carry), strict=True):
        assert torch.equal(a, b)


# -- planning and the registry ----------------------------------------------------------

def _plateau_loss(t):
    return 5.0 - 0.1 * min(t, 30) + 0.001 * (t % 3)


@pytest.mark.parametrize("overlap", ["off", "one_cycle"])
@pytest.mark.parametrize("b_max", [2, 4, 8])
def test_plan_cycle_matches_jax_over_whole_runs(overlap, b_max):
    """Both controllers plan a 160-step run cycle by cycle, fed the same
    losses after each cycle: warm-up, cycling through plateau halvings and
    resets, window cuts and cool-down give the same shapes and state dicts,
    and the plan is the per-step sequence (tests/test_executor.py:226)."""
    kw = dict(n_replicas=4, global_world=16, b_max=b_max, warmup_steps=6,
              cooldown_steps=7, total_steps=160, plateau_patience=2, overlap=overlap)
    jc = jschedule.DasoController(jdaso.DasoConfig(**kw), loss_window=5)
    tc = schedule.DasoController(daso.DasoConfig(**kw), loss_window=5)
    stepwise = schedule.DasoController(daso.DasoConfig(**kw), loss_window=5)
    step, shapes = 0, []
    while step < 160:
        shape = tc.plan_cycle(step, max_len=min(7, 160 - step))
        assert shape == jc.plan_cycle(step, max_len=min(7, 160 - step))
        assert shape and len(shape) <= 5
        shapes.append(shape)
        for i in range(len(shape)):
            assert stepwise.mode_for_step(step + i) == shape[i]
        for t in range(step, step + len(shape)):
            for c in (jc, tc, stepwise):
                c.observe_loss(_plateau_loss(t))
        step += len(shape)
        assert tc.state_dict() == jc.state_dict()
    assert tc.history == stepwise.history
    assert len(set(shapes)) > 2
    assert len({h[2] for h in tc.history}) > 1  # the plateaus moved B


def test_plan_respects_loss_window_boundary():
    """tests/test_executor.py:245."""
    c = schedule.DasoController(daso.DasoConfig(n_replicas=4, global_world=16, b_max=8),
                                loss_window=5)
    c.observe_loss(1.0)
    c.observe_loss(1.0)
    assert len(c.plan_cycle(0, max_len=32)) <= 3


def test_group_runs():
    shape = (("send", 1), ("receive", 1), ("local", 1), ("local", 1))
    assert executor._group_runs(shape) == jexecutor._group_runs(shape) == [
        ("send", 1, 0, 1), ("receive", 1, 1, 1), ("local", 1, 2, 2)]


def test_registry_surface():
    import repro.topo  # noqa: F401  (registers the reference's hier_daso)
    import repro_torch.topo  # noqa: F401  (registers hier_daso)
    assert executor.list_strategies() == ["daso", "downpour", "easgd", "gossip",
                                          "hier_daso", "local_sgd", "sync"]
    assert jexecutor.list_strategies() == executor.list_strategies()
    assert executor.get_strategy("local_sgd").name == "local_sgd"
    with pytest.raises(KeyError, match="did you mean 'daso'"):
        executor.get_strategy("dasoo")
    assert [f.name for f in dataclasses.fields(executor.ExecutorStats)] == \
        [f.name for f in dataclasses.fields(jexecutor.ExecutorStats)]
    assert executor.OVERLAP_COMPUTE_PREFIX == jexecutor.OVERLAP_COMPUTE_PREFIX
    for shape in ((("send", 1), ("receive", 2), ("ovc:local", 1)),
                  (("ov_sync~3", 1), ("blocking", 1), ("hard_avg", 1))):
        assert executor.shape_sync_counts(shape) == jexecutor.shape_sync_counts(shape)


def test_local_sgd_plan_shape():
    """tests/test_executor.py:265."""
    jstrat, strat = _strategies("local_sgd", 40)
    plan = strat.plan_cycle(0, 32)
    assert isinstance(plan, executor.CyclePlan)
    assert plan.shape == jstrat.plan_cycle(0, 32).shape
    assert plan.shape[0][0] == schedule.Mode.HARD_AVG
    assert all(m == schedule.Mode.LOCAL for m, _ in plan.shape[1:])
    assert len(plan) == 4


# -- the overlap dispatch -----------------------------------------------------------------

OV_SHAPES = [(("local", 1), ("local", 1), ("ov_sync~2", 1)),
             (("ov_sync", 1),), (("ov_start", 1),),
             (("blocking", 1), ("ov_sync", 1)), (("local", 1), ("local", 1)), ()]


def test_overlap_cycle_recognition_matches_jax():
    """tests/test_overlap.py:226-246."""
    jstrat, strat = _strategies("daso", 16, overlap="one_cycle")
    def fields(ov):  # two packages' dataclasses never compare equal
        return None if ov is None else dataclasses.astuple(ov)

    for shape in OV_SHAPES:
        assert fields(strat.overlap_cycle(shape)) == fields(jstrat.overlap_cycle(shape))
    ov = strat.overlap_cycle(OV_SHAPES[0])
    assert (ov.staleness, ov.extra_staleness) == (1, 2)
    assert all(m.startswith(executor.OVERLAP_COMPUTE_PREFIX) for m, _ in ov.compute_shape)
    assert strat.overlap_cycle(OV_SHAPES[2]) is None
    _, off = _strategies("daso", 16)
    assert off.overlap_cycle(OV_SHAPES[0]) is None
    params0, _ = _problem(0)
    p0 = {k: torch.from_numpy(v) for k, v in params0.items()}
    assert len(strat.init_carry(p0)) == 4 and len(off.init_carry(p0)) == 3


def test_overlap_macro_matches_jax_macro():
    kw = dict(overlap="one_cycle", loss_window=50)
    jres = _run_jax("daso", 24, **kw)
    tres = _run("daso", 24, **kw)
    _assert_close_to_jax(tres, jres)
    assert _stats(tres.executor_stats) == _stats(jres.executor_stats)
    assert tres.executor_stats.overlap_cycles > 0


@pytest.mark.parametrize("serial", [False, True])
def test_overlap_stats_legs_partition_wall(serial):
    """tests/test_overlap.py:277: compute + visible (or blocking) + merge
    == wall. On the CPU the exchange runs when it is called, before the
    local steps, so the visible leg is only the gap between two clock
    reads."""
    st = _run("daso", 24, overlap="one_cycle", loss_window=50,
              ex_kw={"serial_exchange": serial}).executor_stats
    assert st.overlap_cycles > 0 and st.overlap_wall_s > 0.0
    legs = (st.overlap_compute_s + st.overlap_exchange_visible_s
            + st.overlap_exchange_blocking_s + st.overlap_merge_s)
    assert legs == pytest.approx(st.overlap_wall_s, rel=1e-9, abs=1e-9)
    assert st.overlap_compute_s > 0.0 and st.overlap_merge_s > 0.0
    if serial:
        assert st.overlap_exchange_blocking_s > 0.0
        assert st.overlap_exchange_visible_s == 0.0
    else:
        assert st.overlap_exchange_visible_s >= 0.0
        assert st.overlap_exchange_blocking_s == 0.0


def test_serial_exchange_identical_numerics():
    """tests/test_overlap.py:299."""
    kw = dict(overlap="one_cycle", loss_window=50)
    a = _run("daso", 24, ex_kw={"serial_exchange": False}, **kw)
    b = _run("daso", 24, ex_kw={"serial_exchange": True}, **kw)
    _assert_bit_exact(a, b)
    assert a.executor_stats.overlap_cycles == b.executor_stats.overlap_cycles


# -- the executor's inputs: micro-batches and divergence ---------------------------------

def _jax_aux_loss(params, batch):
    loss, _ = _jax_loss(params, batch)
    return loss, {"mse": loss, "count": jnp.int32(batch["x"].shape[0]),
                  "pred_mean": jnp.mean(jnp.tanh(batch["x"] @ params["w1"]))}


def _aux_loss(params, batch):
    loss, _ = _loss(params, batch)
    return loss, {"mse": loss, "count": torch.tensor(batch["x"].shape[0], dtype=torch.int32),
                  "pred_mean": torch.mean(torch.tanh(batch["x"] @ params["w1"]))}


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_microbatched_value_and_grad_matches_jax(n_micro):
    params0, batch = _problem(5)
    b = batch(0, flat=True)
    (jl, jaux), jg = jax.jit(jdaso.microbatched_value_and_grad(_jax_aux_loss, n_micro))(
        jax.tree.map(jnp.asarray, params0), jax.tree.map(jnp.asarray, b))
    (tl, taux), tg = daso.microbatched_value_and_grad(_aux_loss, n_micro)(
        {k: torch.from_numpy(v) for k, v in params0.items()},
        {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6, rtol=0)
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        assert taux[k].dtype == getattr(torch, str(jaux[k].dtype))
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]), atol=1e-6, rtol=0)
    assert int(taux["count"]) == len(b["x"])  # integer aux: the chunks' sum
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), atol=1e-6, rtol=0)


def test_replica_divergence_matches_jax():
    rng = np.random.default_rng(6)
    tree = {"a": rng.standard_normal((4, 5, 3)).astype(np.float32),
            "b": [(3 * rng.standard_normal((4, 7))).astype(np.float32)]}
    want = jdaso.replica_divergence(jax.tree.map(jnp.asarray, tree))
    got = daso.replica_divergence(jax.tree.map(torch.from_numpy, tree))
    assert got.dim() == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    same = {"a": np.broadcast_to(tree["a"][:1], (4, 5, 3)).copy()}
    assert float(daso.replica_divergence(jax.tree.map(torch.from_numpy, same))) == 0.0


@pytest.mark.parametrize("executor_kind", ["macro", "per_step"])
def test_track_divergence_lengths(executor_kind):
    """One sample per step on both executors (the macro path repeats its
    cycle's), as the reference's; the per-step samples match JAX's."""
    res = _run("daso", 30, executor_kind, track_divergence=True)
    assert len(res.divergence) == 30
    assert all(d >= 0.0 for d in res.divergence)
    if executor_kind == "per_step":
        params0, batch = _problem(0)
        jstrat, _ = _strategies("daso", 30)
        jres = jax_run_per_step(jstrat, jax.tree.map(jnp.asarray, params0),
                                _data(batch, False, "jax"), jax_constant_lr(0.1), 30,
                                track_divergence=True)
        np.testing.assert_allclose(res.divergence, jres.divergence, rtol=1e-4, atol=1e-6)
    else:
        per_step = _run("daso", 30, "per_step", track_divergence=True)
        ends = np.cumsum([len(s) for s, _ in res.cycles]) - 1
        assert [res.divergence[i] for i in ends] == [per_step.divergence[i] for i in ends]


@pytest.mark.parametrize("kernels, want", [
    # main stream 7: [0, 10) and [20, 30) us; exchange stream 14: [5, 25) us
    ([(7, 0, 10), (7, 20, 5), (7, 25, 5), (14, 5, 12), (14, 15, 10)],
     {"main_busy_ms": 0.02, "exchange_busy_ms": 0.02, "concurrent_ms": 0.01}),
    ([], {"main_busy_ms": "not measured", "exchange_busy_ms": "not measured",
          "concurrent_ms": "not measured"}),
])
def test_stream_overlap_reads_concurrent_kernel_time(tmp_path, kernels, want):
    """profile_train's reading of a cycle's trace: each stream's kernel
    spans as a union, and the time both streams ran a kernel; a trace
    without kernels (the CPU) measures nothing."""
    import json

    from repro_torch.launch.profile_train import stream_overlap
    events = [{"cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 40}]
    events += [{"cat": "kernel", "name": "k", "ts": ts, "dur": dur, "args": {"stream": s}}
               for s, ts, dur in kernels]
    path = tmp_path / "cycle.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = stream_overlap(str(path))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == (pytest.approx(v) if isinstance(v, float) else v)
