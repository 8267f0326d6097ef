"""The port's training path held against the JAX package on the CPU: the
loss, the optimizers and schedules, and `run_training` end to end at the
quickstart scale (2 layers, d_model 64, R = 4, 60 steps) against the
reference's per-step executor: identical mode history and sync fraction,
loss trace within RTOL. Also the launcher and the quickstart twin. Inputs
are made from a seed with numpy; both sides train on the same synthetic
tokens from the same initial parameters."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.data.synthetic import SyntheticLM as JaxSyntheticLM
from repro.models.common import cross_entropy_loss as jax_cross_entropy
from repro.models.lm import init_params as jax_init_params
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.train.loop import TrainLoopConfig as JaxTrainLoopConfig
from repro.train.loop import run_training as jax_run_training
from repro.train.step import make_lm_loss as jax_make_lm_loss
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch import quickstart
from repro_torch.launch import train as launch_train
from repro_torch.models.common import cross_entropy_loss
from repro_torch.obs import meters
from repro_torch.obs.trace import RUN_METADATA, load_events, validate_event
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.train.loop import TrainLoopConfig, run_training
from repro_torch.train.step import make_lm_loss
from repro_torch.tree import leaves

QUICK = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
             vocab_size=256)
# loss traces of 60 steps: the two frameworks sum in different orders inside
# the model (~1e-7 relative per step in f32) and SGD carries the difference
# forward; the largest relative difference measured over the 60 steps is
# 6.3e-6
RTOL = 1e-4


def _rng(seed):
    return np.random.default_rng(seed)


# -- loss -----------------------------------------------------------------------

def test_cross_entropy_matches_jax_and_ignores_minus_one():
    logits = 4 * _rng(0).standard_normal((3, 7, 50), dtype=np.float32)
    labels = _rng(1).integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :3] = -1
    want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_lm_loss_matches_jax():
    jcfg = jax_get_reduced("llama3.2-1b").replace(**QUICK)
    tcfg = get_reduced("llama3.2-1b").replace(**QUICK)
    params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(1)))
    b = SyntheticLM(vocab_size=256, seq_len=24, seed=2).batch(3, 0)
    jtot, jaux = jax.jit(jax_make_lm_loss(jcfg))(jax.tree.map(jnp.asarray, params),
                                        {k: jnp.asarray(v.numpy()) for k, v in b.items()})
    ttot, taux = make_lm_loss(tcfg)(params_from_jax(params), b)
    np.testing.assert_allclose(ttot.item(), float(jtot), atol=1e-5)
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), atol=1e-5)


# -- optimizers and schedules ----------------------------------------------------

def _tree(seed):
    r = _rng(seed)
    return {"a": r.standard_normal((5, 3), dtype=np.float32),
            "b": [r.standard_normal(7, dtype=np.float32)]}


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("sgd", {"nesterov": True}), ("sgd", {"momentum": 0.0}),
    ("adamw", {}), ("adamw", {"weight_decay": 0.0})])
def test_optimizer_matches_jax_after_steps(name, kw):
    """Five updates on random gradients: elementwise f32 arithmetic in the
    same order, within 1e-6."""
    jo, to = getattr(jopt, name)(**kw), getattr(topt, name)(**kw)
    jp = jax.tree.map(jnp.asarray, _tree(0))
    tp = jax.tree.map(torch.from_numpy, _tree(0))
    js, ts = jo.init(jp), to.init(tp)
    for i in range(5):
        g = _tree(10 + i)
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp, jnp.float32(0.05))
        tp, ts = to.update(jax.tree.map(torch.from_numpy, g), ts, tp, 0.05)
    for a, b in zip(leaves(tp) + leaves(ts), jax.tree.leaves(jp) + jax.tree.leaves(js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)


def _sgd_formula(grads, state, params, lr, momentum=0.9, weight_decay=1e-4,
                 nesterov=False):
    """sgd's update as its formula reads, one new tensor per operation."""
    new_p, new_mu = [], []
    mus = leaves(state["mu"]) if momentum else [None] * len(leaves(grads))
    for g, p, mu in zip(leaves(grads), leaves(params), mus):
        g = g.float()
        if weight_decay:
            g = g + weight_decay * p.float()
        if momentum:
            mu = momentum * mu + g
            g = g + momentum * mu if nesterov else mu
        new_p.append((p.float() - lr * g).to(p.dtype))
        new_mu.append(mu)
    return new_p, new_mu


@pytest.mark.parametrize("kw,dtype,lr", [
    ({}, torch.float32, 0.05), ({"nesterov": True}, torch.float32, 0.05),
    ({"momentum": 0.0}, torch.float32, 0.05), ({"weight_decay": 0.0}, torch.float32, 0.05),
    ({}, torch.bfloat16, 0.05), ({}, torch.float32, torch.tensor(0.0123))])
def test_sgd_rounds_as_its_formula(kw, dtype, lr):
    """sgd's update, which reuses its own temporaries in place, gives the
    bits of its formula computed one new tensor per operation, for f32 and
    bf16 params and a float or tensor lr, and leaves its inputs as given."""
    r = _rng(5)
    shapes = [(64, 33), (1000,), (3, 5, 7)]
    params = [torch.from_numpy(r.standard_normal(s, dtype=np.float32)).to(dtype)
              for s in shapes]
    grads = [torch.from_numpy(r.standard_normal(s, dtype=np.float32)).to(dtype)
             for s in shapes]
    opt = topt.sgd(**kw)
    state = opt.init(params)
    if state:
        state = {"mu": [torch.from_numpy(r.standard_normal(s, dtype=np.float32))
                        for s in shapes]}
    given = [x.clone() for x in params + grads + (state["mu"] if state else [])]
    new_p, new_s = opt.update(grads, state, params, lr)
    want_p, want_mu = _sgd_formula(grads, state, params, lr, **kw)
    got = leaves(new_p) + (leaves(new_s["mu"]) if state else [])
    want = want_p + (want_mu if state else [])
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want, strict=True))
    now = params + grads + (state["mu"] if state else [])
    assert all(torch.equal(a, b) for a, b in zip(now, given, strict=True))


def test_global_norm_and_clip_match_jax():
    g = _tree(3)
    jn = jopt.global_norm(jax.tree.map(jnp.asarray, g))
    tn = topt.global_norm(jax.tree.map(torch.from_numpy, g))
    np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
    for max_norm in (0.5, 1e3):
        jc, _ = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
        tc, _ = topt.clip_by_global_norm(jax.tree.map(torch.from_numpy, g), max_norm)
        for a, b in zip(leaves(tc), jax.tree.leaves(jc)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("name,args", [
    ("constant_lr", (0.05,)), ("warmup_cosine", (0.1, 10, 100, 0.001)),
    ("warmup_linear_scaled", (0.05 / 16, 16, 6))])
def test_schedules_match_jax(name, args):
    jf, tf = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(tf(step), float(jf(step)), rtol=1e-6)


# -- run_training end to end ------------------------------------------------------

R, PER, SEQ, STEPS = 4, 4, 32, 60


@pytest.fixture(scope="module")
def quickstart_runs():
    jcfg = jax_get_reduced("llama3.2-1b").replace(**QUICK)
    tcfg = get_reduced("llama3.2-1b").replace(**QUICK)
    params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    jsrc = JaxSyntheticLM(vocab_size=256, seq_len=SEQ, seed=0)
    tsrc = SyntheticLM(vocab_size=256, seq_len=SEQ, seed=0)

    def jdata(step):
        b = jsrc.batch(R * PER, step)
        return {k: v.reshape((R, PER) + v.shape[1:]) for k, v in b.items()}

    def tdata(step):
        b = tsrc.batch(R * PER, step)
        return {k: v.reshape((R, PER) + v.shape[1:]) for k, v in b.items()}

    kw = dict(strategy="daso", n_steps=STEPS, n_replicas=R, local_world=4, b_max=4,
              lr=0.05)
    jres = jax_run_training(jax_make_lm_loss(jcfg), jax.tree.map(jnp.asarray, params),
                            jdata, JaxTrainLoopConfig(executor="per_step", **kw),
                            log=None)
    tres = run_training(make_lm_loss(tcfg), params_from_jax(params), tdata,
                        TrainLoopConfig(device="cpu", **kw), log=None)
    return jres, tres


def test_run_training_schedule_identical_to_jax(quickstart_runs):
    """60 steps at loss_window 20 and plateau_patience 5 fill three windows,
    fewer than the five a plateau decision needs, so the mode history does
    not depend on the losses and no decision sits near its threshold."""
    jres, tres = quickstart_runs
    assert [h[1:] for h in tres.controller.history] == \
        [h[1:] for h in jres.controller.history]
    assert tres.sync_fraction == jres.sync_fraction
    modes = {h[1] for h in tres.controller.history}
    assert modes == {"blocking", "send", "receive", "local"}


def test_run_training_loss_trace_matches_jax(quickstart_runs):
    jres, tres = quickstart_runs
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=RTOL)
    assert tres.losses[-1] < tres.losses[0]
    assert len(tres.step_seconds) == STEPS


def test_run_training_refusals(monkeypatch):
    cfg = get_reduced("llama3.2-1b").replace(**QUICK)
    with pytest.raises(ValueError, match="unknown executor 'compiled'"):
        run_training(make_lm_loss(cfg), {}, None,
                     TrainLoopConfig(executor="compiled", device="cpu"))
    with pytest.raises(ValueError, match="params on"):
        run_training(make_lm_loss(cfg), {"w": torch.zeros(2, device="meta")}, None,
                     TrainLoopConfig(device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_training(make_lm_loss(cfg), {}, None, TrainLoopConfig())


def test_sync_strategy_matches_jax():
    jcfg = jax_get_reduced("llama3.2-1b").replace(**QUICK)
    tcfg = get_reduced("llama3.2-1b").replace(**QUICK)
    params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(2)))
    jsrc = JaxSyntheticLM(vocab_size=256, seq_len=SEQ, seed=1)
    tsrc = SyntheticLM(vocab_size=256, seq_len=SEQ, seed=1)
    jres = jax_run_training(jax_make_lm_loss(jcfg), jax.tree.map(jnp.asarray, params),
                            lambda s: jsrc.batch(8, s),
                            JaxTrainLoopConfig(strategy="sync", n_steps=10,
                                               executor="per_step"), log=None)
    tres = run_training(make_lm_loss(tcfg), params_from_jax(params),
                        lambda s: tsrc.batch(8, s),
                        TrainLoopConfig(strategy="sync", n_steps=10, device="cpu"),
                        log=None)
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=RTOL)
    assert tres.sync_fraction == jres.sync_fraction == 1.0


def test_state_from_jax_converts_an_optimizer_state():
    jcfg = jax_get_reduced("llama3.2-1b").replace(**QUICK)
    p = jax_init_params(jcfg, jax.random.PRNGKey(0))
    st = jax.tree.map(np.asarray, jopt.adamw().init(p))
    out = state_from_jax(st)
    assert sorted(out) == ["m", "t", "v"] and out["t"].dtype == torch.int32
    assert out["m"]["blocks"][0]["attn"]["wq"].shape[0] == 2  # stacked layers


# -- launcher and quickstart ------------------------------------------------------

def test_launcher_trains_on_the_cpu(tmp_path):
    out = tmp_path / "m.json"
    res = launch_train.main(["--tiny", "--device", "cpu", "--steps", "6", "--nodes", "2",
                             "--per-node-batch", "2", "--seq-len", "16",
                             "--metrics-out", str(out)])
    m = json.loads(out.read_text())
    assert len(m["losses"]) == 6 and m["device"] == "cpu"
    assert m["sync_fraction"] == res.sync_fraction


@pytest.mark.parametrize("argv,say", [
    (["--autotune"], "[train] autotune: no topology spec to probe"),
    (["--autotune", "--autotune-every", "3", "--topology", "chip:2 x host:2@50e9 x pod:2@25e9"],
     "[train] autotune probe: measured"),
    (["--distributed", "--topology", "chip:4 x pod:2"], "[train] strategy=daso"),
    (["--exchange-impl", "per_leaf"], "wire=auto/per_leaf"),
])
def test_launcher_refuses_unported_flags(argv, say, capsys):
    """Every flag of the reference's launcher is ported (items 7, 16 and 18
    were the last): each parses and runs, and prints its line."""
    res = launch_train.main(["--tiny", "--device", "cpu", "--steps", "2", "--per-node-batch",
                             "2", "--seq-len", "16"] + argv)
    assert len(res.losses) == 2
    assert say in capsys.readouterr().out
    if "--distributed" in argv:
        assert res.placement.n_procs == 1
    assert launch_train.parse_args(argv).exchange_impl == (
        "per_leaf" if "per_leaf" in argv else "fused")
    assert not hasattr(launch_train, "LATER_FLAGS")


def test_launcher_takes_every_reference_flag():
    """The port's launcher has every flag of the reference's (and adds
    --device, --layers, --dtype and --proc-report)."""
    import re

    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")

    def flags(path):
        with open(os.path.join(root, path)) as f:
            return set(re.findall(r'add_argument\("(--[a-z-]+)"', f.read()))
    ref, port = flags("repro/launch/train.py"), flags("repro_torch/launch/train.py")
    assert "--autotune-every" in ref and "--exchange-impl" in ref
    assert port - ref == {"--device", "--layers", "--dtype", "--proc-report"}
    assert ref <= port


FAULT_PLAN = json.dumps({"events": [{"step": 4, "kind": "crash", "replica": 2},
                                     {"step": 6, "kind": "degrade_dcn", "factor": 0.5},
                                     {"step": 9, "kind": "rejoin", "replica": 2}]})


def test_launcher_runs_a_fault_plan_on_the_cpu(tmp_path, capsys):
    """--fault-plan (inline JSON) through the resilience supervisor: one
    line per event, the "resilience" record in --metrics-out with the
    reference launcher's keys, a TrainState taken while replica 2 is down
    keeps its mask, and --resume from it gives the uninterrupted losses bit
    for bit. The flags the reference refuses with a plan are refused."""
    base = ["--tiny", "--device", "cpu", "--steps", "12", "--nodes", "4",
            "--per-node-batch", "2", "--seq-len", "16", "--fault-plan", FAULT_PLAN]
    out, ck = tmp_path / "m.json", tmp_path / "ck"
    full = launch_train.main(base + ["--metrics-out", str(out), "--ckpt", str(ck),
                                     "--ckpt-every", "6"])
    text = capsys.readouterr().out
    assert "[train] fault plan: 3 events, 2 cycle-cache invalidations" in text
    assert "crash        replica=2" in text and "rejoin       replica=2" in text
    m = json.loads(out.read_text())
    res = m["resilience"]
    assert sorted(res) == ["events", "invalidations", "reshuffles", "retunes",
                           "simulated_time_s", "wasted_wait_s"]
    assert [(e["step"], e["kind"]) for e in res["events"]] == \
        [(4, "crash"), (6, "degrade_dcn"), (9, "rejoin")]
    assert res["invalidations"] == 2 and len(m["losses"]) == 12
    states = sorted(d for d in os.listdir(ck) if d.startswith("step_"))
    mid = str(ck / states[0])
    from repro_torch.checkpoint.io import load_train_state
    ts = load_train_state(mid, device="cpu")
    assert 4 <= ts.step < 9 and ts.membership == [1.0, 1.0, 0.0, 1.0]
    # a resumed run replays the plan's events still ahead of the checkpoint
    ahead = json.dumps({"events": [e for e in json.loads(FAULT_PLAN)["events"]
                                   if e["step"] >= ts.step]})
    resumed = launch_train.main(base[:-1] + [ahead, "--resume", mid])
    assert resumed.losses == full.losses
    with pytest.raises(ValueError, match="before resume step"):
        launch_train.main(base + ["--resume", mid])
    for argv, match in ((["--strategy", "sync"], "replica-axis"),
                        (["--executor", "per_step"], "per_step"),
                        (["--overlap", "one_cycle"], "--overlap")):
        with pytest.raises(SystemExit, match=match):
            launch_train.main(base + argv)


@pytest.mark.parametrize("argv,dispatches,fallback", [
    # one warm-up and one cool-down step; B = 4 cycles cut at 3 steps:
    # (blocking), 2 x ((send, receive, local), (local)), (blocking)
    (["--executor", "macro", "--max-cycle-len", "3", "--b-max", "4"], 6, 0),
    # the default executor, B = 2 under one_cycle: (blocking), (ov_start),
    # 3 overlap cycles (local, ov_sync~1) of three dispatches each (the
    # exchange, the local steps, the merge), (local) cut by the cool-down,
    # (blocking)
    (["--overlap", "one_cycle", "--overlap-serial-exchange", "--b-max", "2"], 13, 0),
    (["--executor", "per_step"], None, None),
])
def test_launcher_runs_the_executors(tmp_path, capsys, argv, dispatches, fallback):
    """The executor line and `executor_stats` in --metrics-out; the macro
    executor is the default, as the reference launcher's."""
    out = tmp_path / "m.json"
    res = launch_train.main(["--tiny", "--device", "cpu", "--steps", "10", "--nodes", "2",
                             "--per-node-batch", "2", "--seq-len", "16",
                             "--metrics-out", str(out)] + argv)
    text = capsys.readouterr().out
    m = json.loads(out.read_text())
    assert len(m["losses"]) == 10
    if dispatches is None:
        assert "[train] executor:" not in text and "executor_stats" not in m
        assert res.executor_stats is None
        return
    st = m["executor_stats"]
    assert (st["dispatches"], st["fallback_steps"]) == (dispatches, fallback)
    assert st["steps"] + st["fallback_steps"] == 10
    assert f"[train] executor: {dispatches} host dispatches for 10 steps" in text
    assert f"dispatches={dispatches}/10" in text
    if "one_cycle" in argv:
        assert st["overlap_cycles"] == 3 and st["overlap_exchange_blocking_s"] > 0.0
        assert st["overlap_exchange_visible_s"] == 0.0


@pytest.fixture
def one_torch_thread():
    """One torch thread for a tiny model's run (its ops are too small to
    split; beside the suite's other workers the pool only contends), then
    the worker's setting back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_launcher_trains_a_topology_on_the_cpu(tmp_path, capsys, one_torch_thread):
    """--topology sizes the run from the spec and prints the reference's
    topology line; the 3-level spec runs hier_daso's host syncs."""
    out = tmp_path / "m.json"
    res = launch_train.main(["--tiny", "--device", "cpu", "--steps", "8", "--nodes", "9",
                             "--per-node-batch", "2", "--seq-len", "16",
                             "--topology", "chip:4 x host:2@50e9 x pod:2@25e9",
                             "--metrics-out", str(out)])
    text = capsys.readouterr().out
    assert ("[train] topology: chip:4@6e+11/1e-06 x host:2@5e+10/1e-05 x "
            "pod:2@2.5e+10/3e-05 -> R=4 world=16 inner_periods={'host': 2}") in text
    assert type(res.controller).__name__ == "HierDasoController"
    assert res.controller.level_sync_counts()["host"] > 0
    assert res.carry[0]["final_norm"]["scale"].shape[0] == 4
    assert len(json.loads(out.read_text())["losses"]) == 8


# the run_metadata keys of the reference launcher (src/repro/launch/train.py:306-316)
RUN_METADATA_KEYS = {"arch", "strategy", "steps", "topology", "n_replicas", "local_world",
                     "b_max", "wire_format", "exchange_impl", "overlap", "param_bytes",
                     "procs", "seed", "tiny"}


@pytest.mark.parametrize("executor", ["macro", "per_step"])
def test_launcher_writes_a_run_trace(tmp_path, capsys, one_torch_thread, executor):
    """--trace-out: the merged trace with one run_metadata event in the
    reference launcher's keys and one comm_meters counter, the same meters
    in --metrics-out, and cycle spans on the macro executor only (the
    per-step path stays untraced, as in the reference)."""
    path, out = tmp_path / "t.jsonl", tmp_path / "m.json"
    res = launch_train.main(["--tiny", "--device", "cpu", "--steps", "10", "--nodes", "2",
                             "--per-node-batch", "2", "--seq-len", "16", "--executor", executor,
                             "--trace-out", str(path), "--metrics-out", str(out)])
    text = capsys.readouterr().out
    assert path.exists() and (tmp_path / "t.jsonl.e0p0.jsonl").exists()
    assert "[train] trace events=" in text and text.rstrip().endswith(f"-> {path}")
    evs = load_events(str(path))
    assert all(validate_event(ev) is None for ev in evs)
    assert [ev["ts"] for ev in evs] == sorted(ev["ts"] for ev in evs)
    meta = [ev for ev in evs if ev["name"] == RUN_METADATA]
    assert len(meta) == 1 and set(meta[0]["args"]) == RUN_METADATA_KEYS
    args = meta[0]["args"]
    assert (args["exchange_impl"], args["procs"], args["n_replicas"], args["tiny"]) == (
        "fused", 1, 2, True)
    assert args["param_bytes"] == sum(x.numel() * x.element_size() for x in leaves(res.params))
    comm = [ev for ev in evs if ev["name"] == "comm_meters"]
    assert len(comm) == 1 and comm[0]["ph"] == "C"
    ctrl = res.controller
    rows = meters.level_bytes_report(res.params, ctrl.level_sync_counts(), ctrl.cfg,
                                     outer_split=meters.outer_sync_split(ctrl.history))
    assert comm[0]["args"] == meters.rows_as_counter(rows)
    assert json.loads(out.read_text())["comm_meters"] == [
        {**dataclasses.asdict(r), "total_bytes": r.total_bytes} for r in rows]
    cycles = [ev for ev in evs if ev["name"] == "cycle"]
    if executor == "macro":
        assert sum(ev["args"]["steps"] for ev in cycles) == 10
    else:
        assert cycles == [] and res.executor_stats is None


def test_launcher_refuses_to_train_the_ssm_family(one_torch_thread):
    """The launcher that once refused the SSM family trains falcon-mamba-7b
    (`--tiny`) on the CPU, K7's backward in its plain version: finite
    losses."""
    res = launch_train.main(["--arch", "falcon-mamba-7b", "--tiny", "--device", "cpu",
                             "--steps", "4", "--nodes", "2", "--per-node-batch", "2",
                             "--seq-len", "16"])
    assert len(res.losses) == 4 and np.isfinite(res.losses).all()


def test_quickstart_twin_runs(capsys):
    sync, daso = quickstart.main(["--device", "cpu", "--steps", "4"])
    text = capsys.readouterr().out
    assert "sync  final loss" in text and "DASO  final loss" in text
    assert "relative quality gap" in text and len(daso.losses) == 4
