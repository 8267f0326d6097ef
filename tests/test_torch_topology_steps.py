"""The port's inner-level syncs in the DASO step functions and in training,
held against the JAX package on the CPU:

  * `daso_train_step`, `daso_overlap_step` and `daso_overlap_compute_step`
    with ``inner_syncs=(("host", 2),)`` (and once with a regrouping) on
    tests/conftest.py's MLP with R = 4: params, optimizer state, buffers and
    metrics within 1e-5 of the reference's (tests/test_torch_daso.py's
    tolerance);
  * `run_training` with the 3-level spec ``chip:4 x host:2@50e9 x
    pod:2@25e9`` on a tiny llama3.2-1b-family model, overlap off and
    one_cycle: the history tokens identical to the JAX package's, the
    losses within RTOL of its run (overlap off), and the port's macro and
    per-step runs identical bit for bit (carry included);
  * a 2-level spec gives the legacy run bit for bit;
  * `set_group_permutation` on the MLP problem against the reference's:
    the same history, losses and params within tests/test_executor.py's
    tolerances, and the step cache dropped.
Inputs are made from a seed with numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core import daso as jdaso
from repro.core import executor as jexecutor
from repro.data.synthetic import SyntheticLM as JaxSyntheticLM
from repro.models.lm import init_params as jax_init_params
from repro.optim import optimizers as jopt
from repro.optim.schedules import constant_lr as jax_constant_lr
from repro.topo import TopologySpec as JaxTopologySpec
from repro.topo import build_topology_strategy as jax_build_topology_strategy
from repro.train.loop import TrainLoopConfig as JaxTrainLoopConfig
from repro.train.loop import build_strategy as jax_build_strategy
from repro.train.loop import run_training as jax_run_training
from repro.train.step import make_lm_loss as jax_make_lm_loss
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.core import daso, executor
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.optim.optimizers import sgd
from repro_torch.optim.schedules import constant_lr
from repro_torch.topo import TopologySpec, build_topology_strategy
from repro_torch.train.loop import TrainLoopConfig, run_training
from repro_torch.train.step import make_lm_loss
from repro_torch.tree import leaves

R, PER, SEQ = 4, 2, 16
STEP_ATOL = 1e-5                 # tests/test_torch_daso.py
RTOL = 1e-4                      # tests/test_torch_train.py
SPEC = "chip:4 x host:2@50e9 x pod:2@25e9"
HOST = (("host", 2),)
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
            vocab_size=128)
CFG = dict(n_replicas=R, global_world=4 * R, b_max=4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models' ops are too small to split across threads; beside
    the suite's other workers, torch's thread pool only contends for the
    cores. One thread for this module, then the worker's setting back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the step functions, on tests/conftest.py's MLP at R = 4 ---------------------------

D, H, MLP_PER = 8, 16, 16


def _mlp(seed=0):
    rng = np.random.default_rng(seed)
    params0 = {"w1": (0.3 * rng.standard_normal((D, H))).astype(np.float32),
               "w2": (0.3 * rng.standard_normal((H, 1))).astype(np.float32)}
    wtrue = (0.5 * rng.standard_normal((D, H))).astype(np.float32)

    def batch(step):
        x = np.random.default_rng((seed, step)).standard_normal((R, MLP_PER, D)).astype(np.float32)
        return {"x": x, "y": (np.tanh(x @ wtrue).sum(-1, keepdims=True) * 0.3).astype(np.float32)}

    return params0, batch


def _jax_loss(params, batch):
    pred = jnp.tanh(batch["x"] @ params["w1"]) @ params["w2"]
    return jnp.mean((pred - batch["y"]) ** 2), {}


def _loss(params, batch):
    pred = torch.tanh(batch["x"] @ params["w1"]) @ params["w2"]
    return torch.mean((pred - batch["y"]) ** 2), {}


@pytest.fixture(scope="module")
def problem():
    """A carry (params_R, opt_R, inflight, pending) whose replicas and
    buffers all differ, and one batch."""
    p0, batch = _mlp()
    rng = np.random.default_rng(1)

    def spread(scale):
        return {k: (v[None] + scale * rng.standard_normal((R,) + v.shape)).astype(np.float32)
                for k, v in p0.items()}

    params, inflight, pending = spread(0.01), spread(0.02), spread(0.015)
    opt = {"mu": {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
                  for k, v in params.items()}}
    return dict(carry=(params, opt, inflight, pending), batch=batch(3))


def _assert_close(got, want):
    g, w = leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=STEP_ATOL, rtol=0)


def _run_both(problem, jbuild, tbuild, n_carry):
    carry, batch = problem["carry"][:n_carry], problem["batch"]
    jout = jax.jit(jbuild(_jax_loss, jopt.sgd(0.9, 1e-4)))(
        *(jax.tree.map(jnp.asarray, t) for t in carry), jax.tree.map(jnp.asarray, batch),
        jnp.float32(0.05))
    tout = tbuild(_loss, sgd(0.9, 1e-4))(
        *(jax.tree.map(torch.from_numpy, t) for t in carry),
        jax.tree.map(torch.from_numpy, batch), 0.05)
    return tout, jout


@pytest.mark.parametrize("mode,perm", [("local", None), ("send_receive", None),
                                       ("send", (2, 0, 3, 1)), ("blocking", None)])
def test_train_step_with_inner_sync_matches_jax(problem, mode, perm):
    kw = dict(mode=mode, staleness=2, inner_syncs=HOST, group_perm=perm)
    tout, jout = _run_both(
        problem,
        lambda loss, opt: jdaso.daso_train_step(loss, opt, jdaso.DasoConfig(**CFG), **kw),
        lambda loss, opt: daso.daso_train_step(loss, opt, daso.DasoConfig(**CFG), **kw), 3)
    for got, want in zip(tout, jout):
        _assert_close(got, want)
    # the host pairs {0, 1} and {2, 3} (or the permuted pairs) hold one row
    slots = perm or (0, 1, 2, 3)
    for x in leaves(tout[0]):
        assert torch.equal(x[slots[0]], x[slots[1]]) and torch.equal(x[slots[2]], x[slots[3]])


@pytest.mark.parametrize("mode,extra", [("local", 0), ("ov_start", 0), ("ov_sync", 1)])
def test_overlap_step_with_inner_sync_matches_jax(problem, mode, extra):
    kw = dict(mode=mode, staleness=1, extra_staleness=extra, inner_syncs=HOST)
    cfg = dict(CFG, overlap="one_cycle")
    tout, jout = _run_both(
        problem,
        lambda loss, opt: jdaso.daso_overlap_step(loss, opt, jdaso.DasoConfig(**cfg), **kw),
        lambda loss, opt: daso.daso_overlap_step(loss, opt, daso.DasoConfig(**cfg), **kw), 4)
    for got, want in zip(tout, jout):
        _assert_close(got, want)


def test_overlap_compute_step_with_inner_sync_matches_jax(problem):
    cfg = dict(CFG, overlap="one_cycle")
    tout, jout = _run_both(
        problem,
        lambda loss, opt: jdaso.daso_overlap_compute_step(
            loss, opt, jdaso.DasoConfig(**cfg), inner_syncs=HOST),
        lambda loss, opt: daso.daso_overlap_compute_step(
            loss, opt, daso.DasoConfig(**cfg), inner_syncs=HOST), 2)
    for got, want in zip(tout, jout):
        _assert_close(got, want)


# -- run_training with a 3-level spec ----------------------------------------------

STEPS = 16


@pytest.fixture(scope="module", params=["off", "one_cycle"])
def topo_runs(request):
    """The port's macro and per-step runs of the 3-level spec and, from the
    same initial params and tokens, the JAX package's per-step run (overlap
    off); under one_cycle, whose steps the step tests above hold to the
    reference's, the JAX lowering's controller alone gives the schedule
    (16 steps fill two loss windows, fewer than a plateau decision needs,
    so the schedule does not depend on the losses)."""
    overlap = request.param
    jcfg = jax_get_reduced("llama3.2-1b").replace(**TINY)
    tcfg = get_reduced("llama3.2-1b").replace(**TINY)
    params = _np_tree(jax_init_params(jcfg, jax.random.PRNGKey(1)))

    def data(src):
        def fn(step):
            b = src.batch(R * PER, step)
            return {k: v.reshape((R, PER) + v.shape[1:]) for k, v in b.items()}
        return fn

    kw = dict(strategy="daso", n_steps=STEPS, topology=SPEC, lr=0.05, loss_window=8,
              overlap=overlap)
    tres = {ex: run_training(make_lm_loss(tcfg), params_from_jax(params),
                             data(SyntheticLM(vocab_size=TINY["vocab_size"], seq_len=SEQ,
                                              seed=2)),
                             TrainLoopConfig(executor=ex, device="cpu", **kw), log=None)
            for ex in ("macro", "per_step")}
    if overlap == "off":
        jres = jax_run_training(
            jax_make_lm_loss(jcfg), jax.tree.map(jnp.asarray, params),
            data(JaxSyntheticLM(vocab_size=TINY["vocab_size"], seq_len=SEQ, seed=2)),
            JaxTrainLoopConfig(executor="per_step", **kw), log=None)
        return overlap, jres.controller, jres.losses, tres
    jc = jax_build_strategy(None, JaxTrainLoopConfig(**kw), None).controller
    for t in range(STEPS):
        jc.mode_for_step(t)
    return overlap, jc, None, tres


def test_topology_run_schedule_identical_to_jax(topo_runs):
    overlap, jc, _, tres = topo_runs
    want = [h[1:] for h in jc.history]
    for res in tres.values():
        assert type(res.controller).__name__ == "HierDasoController"
        assert [h[1:] for h in res.controller.history] == want
        assert res.controller.level_sync_counts() == jc.level_sync_counts()
        assert res.sync_fraction == jc.global_sync_fraction()
    # B_host = 2: the odd steps sync the host pairs (blocking ones aside),
    # outer syncs among them
    modes = {h[1] for h in tres["macro"].controller.history}
    assert {"blocking", "local", "local+host"} <= modes
    assert ({"ov_start+host", "ov_sync~3+host"} if overlap == "one_cycle"
            else {"send+host", "receive"}) <= modes


def test_topology_run_losses_match_jax(topo_runs):
    _, _, jlosses, tres = topo_runs
    if jlosses is not None:
        for res in tres.values():
            np.testing.assert_allclose(res.losses, jlosses, rtol=RTOL)
    assert tres["macro"].losses[-1] < tres["macro"].losses[0]


def test_topology_run_macro_is_per_step_bit_for_bit(topo_runs):
    tres = topo_runs[-1]
    macro, per_step = tres["macro"], tres["per_step"]
    assert macro.losses == per_step.losses
    # an overlap cycle's compute steps drop the aux metrics (their means
    # reduce over the replicas); what the macro path reports is the same
    for m, p in zip(macro.metrics, per_step.metrics, strict=True):
        assert m == {k: p[k] for k in m}
    for a, b in zip(leaves(macro.carry), leaves(per_step.carry), strict=True):
        assert torch.equal(a, b)
    assert macro.executor_stats.dispatches < STEPS


@pytest.mark.parametrize("executor_kind", ["macro", "per_step"])
def test_two_level_spec_is_the_legacy_run_bit_for_bit(executor_kind):
    cfg = get_reduced("llama3.2-1b").replace(**TINY)
    params = params_from_jax(_np_tree(jax_init_params(
        jax_get_reduced("llama3.2-1b").replace(**TINY), jax.random.PRNGKey(3))))
    src = SyntheticLM(vocab_size=TINY["vocab_size"], seq_len=SEQ, seed=4)

    def data(step):
        b = src.batch(R * PER, step)
        return {k: v.reshape((R, PER) + v.shape[1:]) for k, v in b.items()}

    kw = dict(strategy="daso", n_steps=16, lr=0.05, loss_window=8, executor=executor_kind,
              device="cpu")
    legacy = run_training(make_lm_loss(cfg), params, data,
                          TrainLoopConfig(n_replicas=R, local_world=4, **kw), log=None)
    lowered = run_training(make_lm_loss(cfg), params, data,
                           TrainLoopConfig(topology="chip:4 x pod:4", **kw), log=None)
    assert type(lowered.controller).__name__ == "DasoController"
    assert lowered.controller.history == legacy.controller.history
    assert lowered.losses == legacy.losses
    for a, b in zip(leaves(lowered.carry), leaves(legacy.carry), strict=True):
        assert torch.equal(a, b)


# -- the regrouping ----------------------------------------------------------------

def test_group_permutation_matches_jax_and_drops_the_step_cache():
    params0, batch = _mlp()
    kw = dict(warmup_steps=2, cooldown_steps=2, total_steps=30)
    jstrat = jax_build_topology_strategy(_jax_loss, jopt.sgd(momentum=0.9),
                                         JaxTopologySpec.parse(SPEC), loss_window=10, **kw)
    tstrat = build_topology_strategy(_loss, sgd(momentum=0.9), TopologySpec.parse(SPEC),
                                     loss_window=10, **kw)
    tstrat.step_fn("local+host", 1)
    for strat in (jstrat, tstrat):
        strat.set_group_permutation((3, 1, 0, 2))
    assert tstrat.group_perm == jstrat.group_perm == (3, 1, 0, 2) and not tstrat._steps
    jres = jexecutor.run_compiled_training(
        jstrat, jax.tree.map(jnp.asarray, params0),
        lambda s: jax.tree.map(jnp.asarray, batch(s)), jax_constant_lr(0.1), 30)
    tres = executor.run_compiled_training(
        tstrat, {k: torch.from_numpy(v) for k, v in params0.items()},
        lambda s: {k: torch.from_numpy(v) for k, v in batch(s).items()}, constant_lr(0.1), 30)
    assert [h[1:] for h in tres.controller.history] == [h[1:] for h in jres.controller.history]
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-5, atol=1e-6)
    for a, b in zip(leaves(tres.params), jax.tree.leaves(jres.params), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=1e-6)
    tstrat.set_group_permutation((0, 1, 2, 3))
    assert tstrat.group_perm is None
