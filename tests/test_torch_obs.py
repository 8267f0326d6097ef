"""The port's telemetry plane (`repro_torch/obs/`, the macro executor's and
the controller's events, the launcher's comm meters) held against the JAX
package's on the CPU:

  * tracer twins of tests/test_obs.py's unit contract: valid JSONL, an
    idempotent close, a complete NULL_TRACER, `validate_event`'s
    rejections (the reference's messages word for word), extra keys
    tolerated, the merge order across processes, `stream_path`, the
    Chrome wrapper;
  * cross-reading: a stream of either package loads, validates and merges
    with the other's reader, to the same file;
  * meters on the same parameter tree (numpy, passed to the reference as
    jnp arrays and to the port as tensors; f32, bf16 and int32 leaves):
    `level_bytes_report` rows and `rows_as_counter` equal the reference's
    for each wire tier, split and unsplit outer rows, no spec, 2-, 3- and
    4-level specs, orphan levels; `outer_sync_split`, `crosscheck_hlo`
    and `level_cost_samples` equal the reference's on the same histories
    and dictionaries, and so do the cycle spans' `shape_sync_counts`;
  * the controller's `bw_change` events equal the reference's, args
    included, on the same Python floats; the tracer never enters
    `state_dict`;
  * traced runs of both packages (a DASO run, one_cycle on the f32 and
    int8 wires, a 3-level hier_daso run, a checkpointed run, a run whose
    tail falls back and is then invalidated) emit the same events in the
    same order, with the same integer, boolean and string args (timings
    and float args are not compared);
  * tools/trace_report.py builds a report from a trace of the port's
    launcher without an edit.
Inputs are made from a seed with numpy."""
import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import daso as jdaso
from repro.core import executor as jexecutor
from repro.core import schedule as jschedule
from repro.obs import meters as jmeters
from repro.obs import trace as jtrace
from repro.optim import optimizers as jopt
from repro.optim.schedules import constant_lr as jax_constant_lr
from repro.topo import TopologySpec as JaxTopologySpec
from repro.train import loop as jloop
from repro_torch.core import daso, executor, schedule
from repro_torch.launch import train as launch_train
from repro_torch.obs import meters, trace
from repro_torch.obs.trace import (NULL_TRACER, RUN_METADATA, Tracer, load_events,
                                   merge_streams, stream_path, to_chrome, validate_event)
from repro_torch.optim.optimizers import sgd
from repro_torch.optim.schedules import constant_lr
from repro_torch.topo import TopologySpec
from repro_torch.train import loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC3 = "chip:4 x host:2@50e9 x pod:2@25e9"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models' ops are too small to split across threads; beside
    the suite's other workers, torch's thread pool only contends for the
    cores. One thread for this module, then the worker's setting back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# -- the tracer's unit contract (tests/test_obs.py:57-160) ------------------------------

def test_tracer_events_are_valid_jsonl(tmp_path):
    p = str(tmp_path / "t.e0p0.jsonl")
    tr = Tracer(p, proc_id=0, flush_every=4)
    with tr.span("cycle", cat="executor", steps=3):
        pass
    tr.instant("compile", cat="executor", shape_len=2)
    tr.counter("comm_meters", {"_outer.syncs": 4.0})
    tr.metadata(arch="mlp", param_bytes=123)
    tr.close()
    evs = _events(p)
    assert len(evs) == 6                     # process_name + 4 + tracer_self
    assert all(validate_event(ev) is None for ev in evs)
    assert [ev["name"] for ev in evs] == ["process_name", "cycle", "compile", "comm_meters",
                                          RUN_METADATA, "tracer_self"]
    assert [ev["ph"] for ev in evs] == ["M", "X", "i", "C", "i", "C"]
    span = evs[1]
    assert span["dur"] >= 0 and span["args"] == {"steps": 3}
    assert evs[-1]["args"]["events"] == tr.n_events - 1
    assert tr.overhead_s > 0.0


def test_tracer_close_is_idempotent_and_final(tmp_path):
    p = str(tmp_path / "t.e0p0.jsonl")
    tr = Tracer(p)
    tr.instant("x")
    tr.close()
    n = len(_events(p))
    tr.close()
    tr.instant("after_close")  # dropped, not an error
    assert len(_events(p)) == n == 3


def test_null_tracer_is_api_complete_noop():
    with NULL_TRACER.span("cycle", steps=1) as sp:
        assert sp is NULL_TRACER.span("again")  # one shared instance
    NULL_TRACER.instant("x")
    NULL_TRACER.counter("c", {"v": 1.0})
    NULL_TRACER.metadata(a=1)
    NULL_TRACER.flush()
    NULL_TRACER.close()
    assert NULL_TRACER.enabled is False and NULL_TRACER.n_events == 0
    assert NULL_TRACER.overhead_s == 0.0
    # the reference's method set, nothing missing
    want = {n for n in dir(jtrace.NullTracer) if not n.startswith("__")}
    assert want <= {n for n in dir(trace.NullTracer) if not n.startswith("__")}


@pytest.mark.parametrize("ev,frag", [
    ("nope", "not an object"),
    ({"ph": "X", "ts": 0, "pid": 0}, "missing required key 'name'"),
    ({"name": "", "ph": "i", "ts": 0, "pid": 0}, "non-empty"),
    ({"name": "a", "ph": "Z", "ts": 0, "pid": 0}, "unknown phase"),
    ({"name": "a", "ph": "i", "ts": -1, "pid": 0}, "non-negative"),
    ({"name": "a", "ph": "X", "ts": 0, "pid": 0}, "dur"),
    ({"name": "a", "ph": "X", "ts": 0, "pid": 0, "dur": -5}, "dur"),
    ({"name": "a", "ph": "i", "ts": 0, "pid": 0, "args": [1]}, "args"),
])
def test_validate_event_rejects_as_the_reference(ev, frag):
    err = validate_event(ev)
    assert err is not None and frag in err
    assert err == jtrace.validate_event(ev)


def test_validate_event_tolerates_extra_keys():
    ev = {"name": "a", "ph": "i", "ts": 1, "pid": 0, "future_field": {"anything": True}}
    assert validate_event(ev) is None
    assert (trace.PHASES, trace.RUN_METADATA) == (jtrace.PHASES, jtrace.RUN_METADATA)


def test_merge_streams_sorts_across_processes(tmp_path):
    base = str(tmp_path / "trace.jsonl")
    for proc in (0, 1):
        tr = Tracer(stream_path(base, proc), proc_id=proc)
        for i in range(3):
            tr.instant(f"p{proc}e{i}")
        tr.close()
    assert merge_streams(base) == base
    evs = _events(base)
    assert [ev["ts"] for ev in evs] == sorted(ev["ts"] for ev in evs)
    assert {ev["pid"] for ev in evs} == {0, 1} and len(evs) == 10
    assert load_events(base) == evs
    os.remove(base)
    assert load_events(base) == evs          # merged in memory from the streams
    assert merge_streams(str(tmp_path / "other.jsonl")) is None
    with pytest.raises(FileNotFoundError):
        load_events(str(tmp_path / "other.jsonl"))


@pytest.mark.parametrize("base,proc,epoch", [("/r/t.jsonl", 3, 0), ("/r/t.jsonl", 1, 2),
                                             ("runs/a b.jsonl", 0, 7)])
def test_stream_path_is_the_references(base, proc, epoch):
    assert stream_path(base, proc, epoch=epoch) == jtrace.stream_path(base, proc, epoch=epoch)
    assert stream_path(base, proc, epoch=epoch).endswith(f".e{epoch}p{proc}.jsonl")


def test_chrome_export_wraps_all_events(tmp_path):
    p = str(tmp_path / "t.e0p0.jsonl")
    tr = Tracer(p)
    tr.instant("x")
    tr.close()
    evs = _events(p)
    doc = to_chrome(evs)
    assert doc == jtrace.to_chrome(evs) and doc["traceEvents"] == evs
    json.dumps(doc)


# -- cross-reading -------------------------------------------------------------------------

def _write_stream(tracer_cls, path, proc):
    tr = tracer_cls(path, proc_id=proc, flush_every=3)
    with tr.span("cycle", cat="executor", start_step=0, steps=4, syncs={"_outer": 1}):
        tr.instant("compile", cat="executor", shape_len=4, modes=["send", "local"])
    tr.counter("comm_meters", {"_outer.syncs": 2.0})
    tr.metadata(arch="mlp", param_bytes=4096, topology=None)
    tr.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_stream_reads_the_same_in_the_other_package(tmp_path, writer):
    w_cls, r_mod = (Tracer, jtrace) if writer == "port" else (jtrace.Tracer, trace)
    p = str(tmp_path / "t.e0p0.jsonl")
    _write_stream(w_cls, p, 0)
    evs = r_mod.load_events(p)
    assert evs == _events(p) and len(evs) == 6
    assert all(r_mod.validate_event(ev) is None for ev in evs)


def test_both_packages_merge_mixed_streams_alike(tmp_path):
    """A port stream (proc 0) and a reference stream (proc 1) of one run
    merge into the same file by either package's `merge_streams`."""
    base = str(tmp_path / "trace.jsonl")
    _write_stream(Tracer, stream_path(base, 0), 0)
    _write_stream(jtrace.Tracer, stream_path(base, 1), 1)
    assert trace.merge_streams(base) == base
    first = _events(base)
    assert jtrace.merge_streams(base) == base
    assert _events(base) == first and len(first) == 12
    assert {ev["pid"] for ev in first} == {0, 1}
    assert [ev["ts"] for ev in first] == sorted(ev["ts"] for ev in first)


# -- meters ---------------------------------------------------------------------------------

def _param_trees(seed):
    """One replica's params, in both packages: f32 leaves of odd sizes, a
    bf16 leaf and an int32 leaf."""
    rng = np.random.default_rng(seed)
    t = {"w": rng.standard_normal((33, 7)).astype(np.float32),
         "b": rng.standard_normal((5,)).astype(np.float32),
         "h": rng.standard_normal((300,)).astype(np.float32),
         "n": np.arange(6, dtype=np.int32)}
    jt = {k: jnp.asarray(v) for k, v in t.items()}
    tt = {k: torch.from_numpy(v) for k, v in t.items()}
    jt["h"], tt["h"] = jt["h"].astype(jnp.bfloat16), tt["h"].to(torch.bfloat16)
    return jt, tt


def _rows(rows):
    return [{**dataclasses.asdict(r), "total_bytes": r.total_bytes,
             "implied_gbps": r.implied_gbps()} for r in rows]


SPECS = [None, "chip:4 x pod:2", "chip:1 x host:2 x pod:2", "chip:2 x host:2 x rack:2 x pod:2"]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("wire", [None, "f32", "bf16", "int8"])
def test_level_bytes_report_equals_the_references(wire, spec):
    jt, tt = _param_trees(0)
    kw = dict(n_replicas=4, global_world=16, wire_format=wire, int8_block=64)
    jcfg, tcfg = jdaso.DasoConfig(**kw), daso.DasoConfig(**kw)
    jspec = JaxTopologySpec.load(spec) if spec else None
    tspec = TopologySpec.load(spec) if spec else None
    # "zone" is a level no spec names (an orphan row)
    counts = {"_outer": 7, "host": 9, "rack": 3, "zone": 2}
    for split in (None, {"blocking": 2, "nonblocking": 5}, {"blocking": 11}):
        for inner_wire in ("f32", "bf16"):
            want = jmeters.level_bytes_report(jt, counts, jcfg, topo=jspec, outer_split=split,
                                              inner_wire=inner_wire)
            got = meters.level_bytes_report(tt, counts, tcfg, topo=tspec, outer_split=split,
                                            inner_wire=inner_wire)
            assert _rows(got) == _rows(want)
            assert meters.rows_as_counter(got) == jmeters.rows_as_counter(want)
    # the unsplit run: one outer row, every inner level the spec names
    rows = meters.level_bytes_report(tt, {"_outer": 3}, tcfg, topo=tspec)
    assert [r.level for r in rows] == ["_outer"] + list(tspec.inner_names() if spec else ())


TOKENS = ["local", "send", "receive", "send_receive", "blocking", "hard_avg", "ov_start",
          "ov_sync", "ov_sync~2", "gossip~1", "gossip~3", "elastic", "push", "local+host",
          "send+host", "receive+host,rack", "ov_sync~1+host", "gossip~2+host"]


@pytest.mark.parametrize("seed", range(4))
def test_outer_sync_split_equals_the_references(seed):
    rng = np.random.default_rng(seed)
    history = [(i, TOKENS[j], 4, 1) for i, j in enumerate(rng.integers(0, len(TOKENS), 60))]
    assert meters.outer_sync_split(history) == jmeters.outer_sync_split(history)
    assert meters.outer_sync_split([]) == {"blocking": 0, "nonblocking": 0}
    assert (schedule.Mode.GOSSIP, schedule.Mode.ELASTIC, schedule.Mode.PUSH) == (
        jschedule.Mode.GOSSIP, jschedule.Mode.ELASTIC, jschedule.Mode.PUSH)


@pytest.mark.parametrize("seed", range(3))
def test_shape_sync_counts_equal_the_references(seed):
    """The per-level syncs a cycle span carries, on shapes of every token,
    the overlap compute prefix included."""
    rng = np.random.default_rng(seed)
    for n in (1, 4, 9):
        shape = tuple((("ovc:" if rng.random() < 0.2 else "") + TOKENS[j], 1)
                      for j in rng.integers(0, len(TOKENS), n))
        assert executor.shape_sync_counts(shape) == jexecutor.shape_sync_counts(shape)


# (level, syncs, wire, group size, bytes per sync, variant, measured seconds)
METER_ROWS = [("_outer", 2, "bf16", 4, 544, "blocking", None),
              ("_outer", 3, "f32", 4, 1088, "nonblocking", 2e-3),
              ("chip", 9, "f32", 2, 1088, "", 5e-4),
              ("host", 4, "f32", 2, 2000, "", 0.0),
              ("rack", 0, "bf16", 0, 100, "", None)]
HLO = [{"all-reduce@pod": {"bytes": 2176, "count": 2}, "all-reduce@chip": {"bytes": 9792, "count": 9},
        "_total": {"bytes": 0, "count": 0}},
       {"all-reduce@pod": {"bytes": 1088, "count": 1}, "all-reduce@chip": {"bytes": 9792, "count": 9},
        "all-reduce@host": {"bytes": 6000, "count": 3}, "noaxis": {"bytes": 5, "count": 1}},
       {}]


@pytest.mark.parametrize("hlo", range(len(HLO)))
@pytest.mark.parametrize("axes", [None, {"_outer": "pod", "chip": "chip", "host": "host"}])
def test_crosscheck_hlo_and_cost_samples_equal_the_references(hlo, axes):
    jrows = [jmeters.LevelMeter(*r[:5], variant=r[5], measured_sync_s=r[6]) for r in METER_ROWS]
    trows = [meters.LevelMeter(*r[:5], variant=r[5], measured_sync_s=r[6]) for r in METER_ROWS]
    for tol in (0.05, 1.0):
        assert (meters.crosscheck_hlo(trows, HLO[hlo], axes, tol=tol)
                == jmeters.crosscheck_hlo(jrows, HLO[hlo], axes, tol=tol))
    assert meters.level_cost_samples(trows) == jmeters.level_cost_samples(jrows)
    assert meters.level_cost_samples(trows) == [("_outer", 0.002), ("chip", 0.0005)]


# -- the controller's decision events -------------------------------------------------------

def _controllers(tmp_path, **kw):
    cfg = dict(n_replicas=2, global_world=4, b_max=8, warmup_steps=0, cooldown_steps=0,
               total_steps=10_000, **kw)
    out = []
    for name, sched, cfg_mod, tr_cls in (("port", schedule, daso, Tracer),
                                         ("reference", jschedule, jdaso, jtrace.Tracer)):
        c = sched.DasoController(cfg_mod.DasoConfig(**cfg), loss_window=3)
        c.tracer = tr_cls(str(tmp_path / f"{name}.e0p0.jsonl"))
        out.append(c)
    return out


def _decisions(c):
    c.tracer.close()
    return [{k: ev[k] for k in ("name", "cat", "ph", "args")} for ev in _events(c.tracer.path)
            if ev["name"] not in ("process_name", "tracer_self")]


@pytest.mark.parametrize("losses", ["constant", "noisy"])
@pytest.mark.parametrize("patience", [1, 2])
def test_bw_change_events_equal_the_references(tmp_path, losses, patience):
    rng = np.random.default_rng(patience)
    seq = ([1.0] * 90 if losses == "constant"
           else [float(x) for x in 2.0 + 0.05 * rng.standard_normal(90)])
    port, ref = _controllers(tmp_path, plateau_patience=patience)
    for x in seq:
        port.observe_loss(x)
        ref.observe_loss(x)
    got, want = _decisions(port), _decisions(ref)
    assert got == want
    assert {ev["args"]["reason"] for ev in got} <= {"plateau_halve", "plateau_reset"}
    if losses == "constant":   # B halves 8 -> 4 -> 2 -> 1, then resets
        assert [ev["args"]["reason"] for ev in got][:4] == ["plateau_halve"] * 3 + [
            "plateau_reset"]
    assert all(ev["cat"] == "schedule" and ev["ph"] == "i" for ev in got)


def test_controller_tracer_never_enters_checkpoints(tmp_path):
    port, ref = _controllers(tmp_path, plateau_patience=1)
    for _ in range(7):
        port.observe_loss(1.0)
        ref.observe_loss(1.0)
    sd = port.state_dict()
    assert "tracer" not in sd and "tracer" not in schedule.DasoController._STATE_FIELDS
    assert json.loads(json.dumps(sd)) == json.loads(json.dumps(ref.state_dict()))
    fresh = schedule.DasoController(port.cfg, loss_window=3)
    fresh.load_state_dict(sd)
    assert fresh.tracer is None and fresh.state_dict() == sd
    port.tracer.close()
    ref.tracer.close()


# -- traced runs in both packages ------------------------------------------------------------

D, H, PER = 8, 16, 16


def _problem(seed, R):
    """tests/conftest.py's MLP made with numpy: (params0, batch(step))."""
    rng = np.random.default_rng(seed)
    params0 = {"w1": (0.3 * rng.standard_normal((D, H))).astype(np.float32),
               "w2": (0.3 * rng.standard_normal((H, 1))).astype(np.float32)}
    wtrue = (0.5 * rng.standard_normal((D, H))).astype(np.float32)

    def batch(step):
        x = np.random.default_rng((seed, step)).standard_normal((R, PER, D)).astype(np.float32)
        return {"x": x, "y": (np.tanh(x @ wtrue).sum(-1, keepdims=True) * 0.3).astype(np.float32)}

    return params0, batch


def _jax_loss(params, batch):
    pred = jnp.tanh(batch["x"] @ params["w1"]) @ params["w2"]
    return jnp.mean((pred - batch["y"]) ** 2), {}


def _loss(params, batch):
    pred = torch.tanh(batch["x"] @ params["w1"]) @ params["w2"]
    return torch.mean((pred - batch["y"]) ** 2), {}


def _plain_args(args):
    """The args a traced run of either package must agree on: everything
    but floats (timings, loss means), at one level of nesting."""
    out = {}
    for k, v in args.items():
        if isinstance(v, dict):
            v = {kk: vv for kk, vv in v.items() if not isinstance(vv, float)}
        elif isinstance(v, float):
            continue
        out[k] = v
    return out


def _signature(path):
    """(name, cat, ph, plain args) of a stream's events, in the order they
    were emitted (a merge sorts by microsecond timestamps, which can tie)."""
    return [(ev["name"], ev.get("cat"), ev["ph"], _plain_args(ev.get("args", {})))
            for ev in _events(path)]


RUNS = {
    "daso": dict(n_steps=24),
    "one_cycle": dict(n_steps=24, overlap="one_cycle"),
    "int8_one_cycle": dict(n_steps=24, overlap="one_cycle", wire_format="int8"),
    "hier_daso": dict(n_steps=16, topology=SPEC3),
    "ckpt_every": dict(n_steps=24, ckpt_every=8),
}


def _traced_run(pkg, tmp_path, name):
    kw = dict(RUNS[name])
    R = 4 if "topology" in kw else 2
    params0, batch = _problem(3, R)
    if "ckpt_every" in kw:
        kw["ckpt_dir"] = str(tmp_path / f"ck_{pkg}")
    base = str(tmp_path / f"{pkg}.jsonl")
    if pkg == "port":
        tr = Tracer(stream_path(base, 0))
        res = loop.run_training(
            _loss, {k: torch.from_numpy(v) for k, v in params0.items()},
            lambda s: {k: torch.from_numpy(v) for k, v in batch(s).items()},
            loop.TrainLoopConfig(strategy="daso", n_replicas=R, b_max=4, loss_window=50,
                                 device="cpu", **kw),
            optimizer=sgd(momentum=0.9), lr_fn=constant_lr(0.05), log=None, tracer=tr)
    else:
        tr = jtrace.Tracer(stream_path(base, 0))
        res = jloop.run_training(
            _jax_loss, jax.tree.map(jnp.asarray, params0),
            lambda s: jax.tree.map(jnp.asarray, batch(s)),
            jloop.TrainLoopConfig(strategy="daso", n_replicas=R, b_max=4, loss_window=50, **kw),
            optimizer=jopt.sgd(momentum=0.9), lr_fn=jax_constant_lr(0.05), log=None,
            tracer=tr)
    tr.close()
    return res, tr.path


@pytest.fixture(scope="module", params=list(RUNS))
def traced_runs(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(request.param)
    return (request.param,) + tuple(_traced_run(pkg, tmp, request.param)
                                    for pkg in ("port", "reference"))


def test_traced_run_emits_the_references_events(traced_runs):
    _, (_, path), (_, jpath) = traced_runs
    got, want = _signature(path), _signature(jpath)
    assert [e[:3] for e in got] == [e[:3] for e in want]
    assert got == want


def test_traced_run_events_hold_the_run(traced_runs):
    name, (res, path), _ = traced_runs
    evs = _events(path)
    assert all(validate_event(ev) is None for ev in evs)
    cycles = [ev for ev in evs if ev["name"] == "cycle"]
    assert sum(ev["args"]["steps"] for ev in cycles) == RUNS[name]["n_steps"]
    counts = res.controller.level_sync_counts()
    for level in counts:
        assert sum(ev["args"]["syncs"].get(level, 0) for ev in cycles) == counts[level]
    stats = res.executor_stats
    assert sum(ev["name"] == "compile" for ev in evs) == stats.compiles
    assert sum(ev["args"]["fresh_compile"] for ev in cycles) == stats.compiles
    legs = {n: sum(ev["name"] == n for ev in evs)
            for n in ("ov_compute", "ov_exchange_visible", "ov_merge")}
    assert set(legs.values()) == {stats.overlap_cycles}
    # a save lands on a cycle boundary at or past each multiple of 8
    ends = np.cumsum([ev["args"]["steps"] for ev in cycles]).tolist()
    saves = [ev["args"]["step"] for ev in evs if ev["name"] == "checkpoint_save"]
    want = sorted({min(e for e in ends if e >= k) for k in range(8, ends[-1] + 1, 8)})
    assert saves == (want if name == "ckpt_every" else [])
    # the cycle span holds the seconds SimResult.cycles gives its cycle
    for ev, (_, sec) in zip(cycles, res.cycles, strict=True):
        assert ev["dur"] >= int(sec * 1e6)


def test_fallback_and_invalidate_count_as_the_reference(tmp_path):
    """A run whose 2-step tail has a new shape runs it step by step; then
    `invalidate` drops the programs and the tail's step variants. The
    port's `dropped` is the reference's, which counts its cache of the
    fallback's step variants (1 program + 2 variants)."""
    params0, batch = _problem(5, 2)
    cfg = dict(strategy="daso", n_steps=42, n_replicas=2, b_max=4, warmup_frac=0.0,
               cooldown_frac=0.0, loss_window=10 ** 9)
    paths, dropped = [], []
    for pkg in ("port", "reference"):
        base = str(tmp_path / f"{pkg}.jsonl")
        if pkg == "port":
            tr = Tracer(stream_path(base, 0))
            strat = loop.build_strategy(_loss, loop.TrainLoopConfig(device="cpu", **cfg),
                                        sgd(momentum=0.9))
            ex = executor.MacroCycleExecutor(strat, tracer=tr)
            executor.run_compiled_training(
                strat, {k: torch.from_numpy(v) for k, v in params0.items()},
                lambda s: {k: torch.from_numpy(v) for k, v in batch(s).items()},
                constant_lr(0.05), 42, executor=ex)
        else:
            tr = jtrace.Tracer(stream_path(base, 0))
            strat = jloop.build_strategy(_jax_loss, jloop.TrainLoopConfig(**cfg),
                                         jopt.sgd(momentum=0.9))
            ex = jexecutor.MacroCycleExecutor(strat, tracer=tr)
            jexecutor.run_compiled_training(
                strat, jax.tree.map(jnp.asarray, params0),
                lambda s: jax.tree.map(jnp.asarray, batch(s)), jax_constant_lr(0.05), 42,
                executor=ex)
        assert ex.stats.fallback_steps == 2
        dropped.append(ex.invalidate())
        tr.close()
        paths.append(tr.path)
    assert dropped == [3, 3]
    got, want = _signature(paths[0]), _signature(paths[1])
    assert got == want
    assert got[-2] == ("invalidate", "executor", "i", {"dropped": 3})
    assert [e[3]["fallback"] for e in got if e[0] == "cycle"] == [False] * 10 + [True]


# -- tools/trace_report.py on a port trace ---------------------------------------------------

def _trace_report():
    spec = importlib.util.spec_from_file_location(
        "trace_report", os.path.join(REPO, "tools", "trace_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trace_report_reads_a_port_trace(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    launch_train.main(["--tiny", "--device", "cpu", "--steps", "40", "--per-node-batch", "2",
                       "--seq-len", "16", "--topology", SPEC3, "--trace-out", path])
    tr = _trace_report()
    evs = tr.load_events(path)
    assert evs == load_events(path)
    rep = tr.build_report(evs)
    assert rep["schema_errors"] == [] and tr.validate(evs) == []
    assert rep["metadata"]["topology"] == TopologySpec.load(SPEC3).to_str()
    assert rep["summary"]["executor"]["spans"] > 0 and rep["summary"]["_tracer"]["events"] > 0
    fit = rep["cycle_fit"]
    assert fit["samples"] > 0 and set(fit["levels"]) == {"_outer", "host"}
    drift = {row["level"] for row in rep["drift"]}
    assert drift == {"host", "pod"}
    json.dumps(rep)


@pytest.mark.parametrize("name", ["gossip", "downpour"])
def test_meters_account_baseline_strategy_traffic(name):
    """tests/test_obs.py:273 in both packages: every exchange a baseline's
    controller emits lands in the outer meter row (its own token at the
    nonblocking tier, warm-up / cool-down at the blocking one), the row's
    syncs are the history's non-local steps, and the rows equal the
    reference's for the reference's run of the same problem."""
    params0, batch = _problem(11, 2)
    kw = dict(strategy=name, n_steps=20, n_replicas=2, local_world=2, b_max=4, lr=0.1,
              loss_window=10)
    res = loop.run_training(_loss, {k: torch.from_numpy(v) for k, v in params0.items()},
                            lambda s: {k: torch.from_numpy(v) for k, v in batch(s).items()},
                            loop.TrainLoopConfig(device="cpu", **kw), log=None)
    jres = jloop.run_training(_jax_loss, jax.tree.map(jnp.asarray, params0),
                              lambda s: jax.tree.map(jnp.asarray, batch(s)),
                              jloop.TrainLoopConfig(**kw), log=None)
    ctl = res.controller
    n_exchanges = sum(1 for (_, m, _, _) in ctl.history if m != "local")
    assert n_exchanges > 0
    split = meters.outer_sync_split(ctl.history)
    assert split["nonblocking"] > 0 and split["blocking"] > 0
    assert split["blocking"] + split["nonblocking"] == n_exchanges
    counts = ctl.level_sync_counts()
    assert counts == {"_outer": n_exchanges} == jres.controller.level_sync_counts()
    rows = meters.level_bytes_report(res.params, counts, ctl.cfg, outer_split=split)
    assert sum(r.syncs for r in rows) == n_exchanges
    assert all(r.bytes_per_sync > 0 for r in rows)
    flat = meters.rows_as_counter(rows)
    assert sum(v for k, v in flat.items() if k.endswith(".syncs")) == n_exchanges
    jrows = jmeters.level_bytes_report(jres.params, counts, jres.controller.cfg,
                                       outer_split=jmeters.outer_sync_split(
                                           jres.controller.history))
    assert _rows(rows) == _rows(jrows)
