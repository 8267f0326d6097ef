"""The placement contracts of the port's multi-process runtime
(repro_torch/launch/distributed.py), on a real two-process gloo group over
localhost: `put_carry` / `fetch` / `row` round trips, `gather_rows` bit for
bit on every wire dtype, and every cross-row operation and DASO / baseline
step variant placed over two processes against the same call on one
process, bit for bit, with the gathers each issues (the exchange steps
gather, local steps and process-local inner syncs do not; the per-leaf
exchange gathers once per leaf and gives the fused numbers).

The group runs once per module (`group` fixture, two subprocesses that run
this file as a script, each bounded by a timeout); each case is checked on
both processes and reported here as its own test. Also: `initialize`'s retry
on a transient connect race only, and the launcher's refusals that come
before the group does (`--dispatch overlap` without overlap, a process
count the topology cannot take)."""
import json
import os
import subprocess
import sys

import pytest

TOPOLOGY = "chip:1 x host:2 x pod:2"   # R = 4; the host pairs lie in a process
R, D, PER = 4, 8, 4


# -- the group's cases (run in the worker processes) ----------------------------

def _cases():
    """name -> fn(placement, rng) -> (ok, detail); each fn runs on every
    process, the one-process call on full tensors beside the placed one."""
    import torch

    from repro_torch.core import baselines, daso
    from repro_torch.core.daso import DasoConfig
    from repro_torch.core.flatbuf import normalize_membership
    from repro_torch.optim.optimizers import sgd
    from repro_torch.tree import leaves, tree_map

    def bits(x):
        x = x.contiguous().reshape(-1)
        return x.view(torch.uint8) if x.dtype.is_floating_point else x

    def same(a, b):
        """Bit for bit (NaN payloads and signed zeros included)."""
        la, lb = leaves(a), leaves(b)
        return len(la) == len(lb) and all(
            x.dtype == y.dtype and x.shape == y.shape and torch.equal(bits(x), bits(y))
            for x, y in zip(la, lb))

    def rows(pl, tree):
        return tree_map(lambda x: x[pl.rows.start:pl.rows.stop], tree)

    def rand_tree(g, dtypes=("float32",)):
        t = {"w": torch.randn(R, D, 3, generator=g), "b": torch.randn(R, 5, generator=g)}
        if "bfloat16" in dtypes:
            t["h"] = torch.randn(R, 7, generator=g).to(torch.bfloat16)
        if "int32" in dtypes:
            t["n"] = torch.randint(-50, 50, (R, 6), generator=g, dtype=torch.int32)
        return t

    def loss_fn(params, batch):
        pred = torch.tanh(batch["x"] @ params["w"]).sum(-1) + params["b"].sum()
        loss = ((pred - batch["y"]) ** 2).mean()
        return loss, {"ce": loss.detach(), "moe_z_loss": torch.zeros(())}

    def problem(g):
        params = {"w": torch.randn(R, D, 3, generator=g) * 0.5,
                  "b": torch.randn(R, 5, generator=g) * 0.1}
        opt = {"mu": {"w": torch.randn(R, D, 3, generator=g) * 0.01,
                      "b": torch.zeros(R, 5)}}
        inflight = tree_map(lambda x: x + 0.01 * torch.randn(x.shape, generator=g), params)
        batch = {"x": torch.randn(R, PER, D, generator=g), "y": torch.randn(R, PER, generator=g)}
        return params, opt, inflight, batch

    def exchange_calls(pl):
        return pl.stats["exchange"].calls

    def placed_metrics(pl, cfg, mask, m):
        keys = [k for k in m if k == "loss_per_replica" or k.startswith(daso.AUX_ROWS)]
        full = pl.gather_metrics({k: m[k][None] for k in keys}, keys)
        n_active = R if mask is None else int(sum(mask))
        return {k: v[0] for k, v in daso.reduce_step_metrics(cfg, mask, n_active,
                                                              full).items()}

    def step_case(mode, *, wire=None, membership=None, inner=(), perm=None,
                  overlap=False, impl="fused", want_gathers):
        def run(pl, g):
            cfg = DasoConfig(n_replicas=R, global_world=4 * R, b_max=4,
                             wire_format=wire, overlap="one_cycle" if overlap else "off",
                             exchange_impl=impl)
            params, opt, inflight, batch = problem(g)
            kw = dict(mode=mode, staleness=2, membership=membership, inner_syncs=inner,
                      group_perm=perm)
            build = daso.daso_overlap_step if overlap else daso.daso_train_step
            one = build(loss_fn, sgd(momentum=0.9), cfg, **kw)
            placed = build(loss_fn, sgd(momentum=0.9), cfg, placement=pl, **kw)
            args = (params, opt, inflight) + ((params,) if overlap else ())
            *out_full, m_full = one(*args, batch, 0.1)
            before = exchange_calls(pl)
            *out_loc, m_loc = placed(*pl.put_carry(args), pl.place_batch(batch), 0.1)
            gathers = exchange_calls(pl) - before
            mask = normalize_membership(membership, R)
            m_loc = placed_metrics(pl, cfg, mask, m_loc)
            ok = (same(rows(pl, tuple(out_full)), tuple(out_loc))
                  and same(m_full["loss"], m_loc["loss"])
                  and same(m_full["ce"], m_loc["ce"]) and gathers == want_gathers)
            return ok, {"gathers": gathers}
        return run

    def gather_case(pl, g):
        fulls = [torch.randn(R, 33, generator=g),
                 torch.randn(R, 9, generator=g).to(torch.bfloat16),
                 torch.randint(-2 ** 40, 2 ** 40, (R, 3), generator=g),
                 (torch.randint(-127, 128, (R, 300), generator=g, dtype=torch.int8),
                  torch.rand(R, 2, generator=g))]
        fulls[0][0, 0] = float("nan")
        fulls[0][-1, -1] = -0.0
        ok = True
        for f in fulls:
            loc = tuple(x[pl.rows.start:pl.rows.stop] for x in f) if isinstance(f, tuple) \
                else f[pl.rows.start:pl.rows.stop]
            got = pl.gather_rows(loc)
            ok &= same(got, f)
        return ok, {"calls": pl.stats["exchange"].calls}

    def put_fetch_case(pl, g):
        p = rand_tree(g, ("float32", "bfloat16", "int32"))
        mean_row = torch.randn(1, D, 3, generator=g)
        carry = (p, p, {"m": mean_row.expand(R, D, 3)}, torch.tensor(3))
        placed = pl.put_carry(carry)
        # leaves that are one tensor stay one tensor
        ok = placed[0]["w"] is placed[1]["w"] and placed[3] is carry[3]
        ok &= all(x.shape[0] == pl.local_rows for x in leaves(placed[0]))
        ok &= pl.put_carry(placed)[0]["w"].shape[0] == pl.local_rows or pl.n_procs == 1
        back = pl.fetch(placed)
        ok &= back[0]["w"] is back[1]["w"] and same(back, carry)
        return ok, {}

    def row_case(pl, g):
        p = rand_tree(g, ("float32", "bfloat16"))
        placed = pl.put_carry(p)
        return all(same(pl.row(placed, i), tree_map(lambda x: x[i], p))
                   for i in range(R)), {}

    def mean_case(wire, membership=None, impl="fused"):
        """The placed mean against the one-process fused one: one gather per
        dtype arena (3), or per leaf (4) under impl="per_leaf"."""
        def run(pl, g):
            t = rand_tree(g, ("float32", "bfloat16", "int32"))
            mask = normalize_membership(membership, R)
            want = daso.replica_mean(t, wire_format=wire, mask=mask)
            before = exchange_calls(pl)
            got = daso.replica_mean(pl.put_carry(t), wire_format=wire, mask=mask,
                                    placement=pl, impl=impl)
            n = exchange_calls(pl) - before
            return same(rows(pl, want), got) and n == (4 if impl == "per_leaf" else 3), \
                {"gathers": n}
        return run

    def group_case(gsize, *, wire="f32", membership=None, perm=None, want_gathers):
        def run(pl, g):
            t = rand_tree(g, ("float32", "int32"))
            mask = normalize_membership(membership, R)
            want = daso.level_group_mean(t, gsize, wire_format=wire, mask=mask, perm=perm)
            before = exchange_calls(pl)
            got = daso.level_group_mean(pl.put_carry(t), gsize, wire_format=wire,
                                        mask=mask, perm=perm, placement=pl)
            n = exchange_calls(pl) - before
            return same(rows(pl, want), got) and n == want_gathers, {"gathers": n}
        return run

    def gossip_case(shift, wire, membership=None):
        def run(pl, g):
            t = rand_tree(g, ("float32", "int32"))
            mask = normalize_membership(membership, R)
            want = baselines.gossip_mix(t, shift=shift, wire_format=wire, mask=mask)
            got = baselines.gossip_mix(pl.put_carry(t), shift=shift, wire_format=wire,
                                       mask=mask, placement=pl)
            return same(rows(pl, want), got), {}
        return run

    def baseline_case(name, mode):
        def run(pl, g):
            cfg = DasoConfig(n_replicas=R, global_world=4 * R, b_max=4,
                             wire_format="int8" if name == "easgd" else "bf16")
            params, opt, other, batch = problem(g)
            if name == "easgd":
                kw, build = dict(alpha=0.1), baselines.easgd_train_step
            else:
                kw, build = dict(push_scale=0.5), baselines.downpour_train_step
            kw.update(mode=mode, membership=(1, 0, 1, 1))
            one = build(loss_fn, sgd(momentum=0.9), cfg, **kw)
            placed = build(loss_fn, sgd(momentum=0.9), cfg, placement=pl, **kw)
            *full, m_full = one(params, opt, other, batch, 0.1)
            *loc, m_loc = placed(*pl.put_carry((params, opt, other)),
                                 pl.place_batch(batch), 0.1)
            m_loc = placed_metrics(pl, cfg, (1.0, 0.0, 1.0, 1.0), m_loc)
            return same(rows(pl, tuple(full)), tuple(loc)) and \
                same(m_full["loss"], m_loc["loss"]), {}
        return run

    cases = {"gather_rows": gather_case, "put_fetch": put_fetch_case, "row": row_case}
    for mode, gathers in (("local", 0), ("send", 1), ("receive", 0), ("send_receive", 1),
                          ("blocking", 1), ("hard_avg", 1)):
        cases[f"daso_{mode}"] = step_case(mode, want_gathers=gathers)
    cases["daso_send_int8"] = step_case("send", wire="int8", want_gathers=1)
    cases["daso_blocking_masked"] = step_case("blocking", membership=(1, 1, 0, 1),
                                              want_gathers=1)
    cases["daso_receive_masked"] = step_case("receive", membership=(0, 1, 1, 1),
                                             want_gathers=0)
    cases["daso_local_host_sync_in_process"] = step_case(
        "local", inner=(("host", 2),), want_gathers=0)
    cases["daso_send_host_sync_in_process_masked"] = step_case(
        "send", inner=(("host", 2),), membership=(1, 0, 1, 1), want_gathers=1)
    cases["daso_local_host_sync_regrouped"] = step_case(
        "local", inner=(("host", 2),), perm=(0, 2, 1, 3), want_gathers=1)
    for mode, gathers in (("local", 0), ("ov_start", 0), ("ov_sync", 1), ("blocking", 1)):
        cases[f"overlap_{mode}_int8"] = step_case(mode, wire="int8", overlap=True,
                                                  want_gathers=gathers)
    for wire in ("f32", "bf16", "int8"):
        cases[f"replica_mean_{wire}"] = mean_case(wire)
    cases["replica_mean_int8_masked"] = mean_case("int8", (1, 0, 0, 1))
    # the per-leaf exchange: one gather per leaf (the problem's params: 2)
    cases["replica_mean_per_leaf_f32"] = mean_case("f32", impl="per_leaf")
    cases["replica_mean_per_leaf_bf16_masked"] = mean_case("bf16", (1, 0, 1, 1),
                                                           impl="per_leaf")
    for mode in ("send", "blocking"):
        cases[f"daso_{mode}_per_leaf"] = step_case(mode, impl="per_leaf", want_gathers=2)
    cases["overlap_ov_sync_per_leaf"] = step_case("ov_sync", overlap=True, impl="per_leaf",
                                                  want_gathers=2)
    cases["group_mean_in_process"] = group_case(2, want_gathers=0)
    cases["group_mean_in_process_bf16_masked"] = group_case(
        2, wire="bf16", membership=(0, 0, 1, 1), want_gathers=0)
    cases["group_mean_whole_axis"] = group_case(4, want_gathers=2)
    cases["group_mean_regrouped_masked"] = group_case(
        2, membership=(1, 0, 1, 1), perm=(3, 0, 2, 1), want_gathers=2)
    for shift in (1, 2, 3):
        cases[f"gossip_shift{shift}_int8"] = gossip_case(shift, "int8")
    cases["gossip_bf16_masked"] = gossip_case(1, "bf16", (1, 1, 0, 1))
    cases["gossip_f32"] = gossip_case(2, "f32")
    cases["easgd_elastic"] = baseline_case("easgd", "elastic")
    cases["downpour_push"] = baseline_case("downpour", "push")
    return cases


def _worker(rank: int, world: int, port: int, out_dir: str) -> None:
    import torch

    from repro_torch.launch import distributed as D
    from repro_torch.topo import TopologySpec

    D.initialize(D.DistributedConfig(coordinator=f"127.0.0.1:{port}",
                                     num_processes=world, process_id=rank))
    pl = D.ProcessPlacement(TopologySpec.load(TOPOLOGY), device="cpu")
    results = {}
    for i, (name, fn) in enumerate(sorted(_cases().items())):
        g = torch.Generator().manual_seed(1000 + i)  # the same on every process
        try:
            ok, detail = fn(pl, g)
            results[name] = {"ok": bool(ok), **detail}
        except Exception as e:  # recorded, so one case's fault names itself
            results[name] = {"ok": False, "error": f"{type(e).__name__}: {e}"}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    D.shutdown()


CASE_NAMES = sorted([
    "gather_rows", "put_fetch", "row",
    "daso_local", "daso_send", "daso_receive", "daso_send_receive", "daso_blocking",
    "daso_hard_avg", "daso_send_int8", "daso_blocking_masked", "daso_receive_masked",
    "daso_local_host_sync_in_process", "daso_send_host_sync_in_process_masked",
    "daso_local_host_sync_regrouped",
    "overlap_local_int8", "overlap_ov_start_int8", "overlap_ov_sync_int8",
    "overlap_blocking_int8",
    "replica_mean_f32", "replica_mean_bf16", "replica_mean_int8",
    "replica_mean_int8_masked", "replica_mean_per_leaf_f32",
    "replica_mean_per_leaf_bf16_masked", "daso_send_per_leaf", "daso_blocking_per_leaf",
    "overlap_ov_sync_per_leaf",
    "group_mean_in_process", "group_mean_in_process_bf16_masked", "group_mean_whole_axis",
    "group_mean_regrouped_masked",
    "gossip_shift1_int8", "gossip_shift2_int8", "gossip_shift3_int8", "gossip_bf16_masked",
    "gossip_f32", "easgd_elastic", "downpour_push"])


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Run every case on a 2-process gloo group; {rank: {case: result}}."""
    from repro_torch.launch.distributed import process_env
    from repro_torch.launch.procs import free_port

    out = tmp_path_factory.mktemp("dist_group")
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), "2", str(port), str(out)],
        env=process_env(2, r, f"127.0.0.1:{port}"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return {r: json.loads((out / f"rank{r}.json").read_text()) for r in range(2)}


def test_every_case_ran(group):
    assert sorted(group[0]) == sorted(group[1]) == CASE_NAMES


@pytest.mark.parametrize("case", CASE_NAMES)
def test_placed_matches_one_process(group, case):
    """Bit for bit on both processes, with the expected gathers."""
    for rank in (0, 1):
        assert group[rank][case]["ok"], (rank, group[rank][case])


# -- the runtime's start-up, without a group -------------------------------------

def test_initialize_retries_transient_connect_race(monkeypatch):
    """Twin of the reference's test: a bind race is retried with
    exponential backoff, anything else raises on the first attempt."""
    from repro_torch.launch import distributed as dmod

    calls, sleeps = [], []
    monkeypatch.setattr(dmod, "_initialized", False)
    monkeypatch.setattr(dmod, "_config", None)

    def fake_init(*a, **kw):
        calls.append(kw)
        if len(calls) < 3:
            raise RuntimeError("The server socket has failed to listen on any local "
                               "network address. port: 1, code: -98, name: EADDRINUSE")

    monkeypatch.setattr(dmod.dist, "init_process_group", fake_init)
    monkeypatch.setattr(dmod.dist, "destroy_process_group", lambda: None)
    monkeypatch.setattr(dmod.time, "sleep", sleeps.append)
    cfg = dmod.DistributedConfig(coordinator="127.0.0.1:1", num_processes=2,
                                 process_id=0)
    dmod.initialize(cfg, backoff_s=0.5)
    assert len(calls) == 3 and sleeps == [0.5, 1.0]
    assert calls[-1]["world_size"] == 2 and calls[-1]["rank"] == 0
    assert dmod._initialized and dmod._config == cfg

    monkeypatch.setattr(dmod, "_initialized", False)
    calls.clear()

    def fake_boom(*a, **kw):
        calls.append(kw)
        raise RuntimeError("invalid coordinator address")

    monkeypatch.setattr(dmod.dist, "init_process_group", fake_boom)
    with pytest.raises(RuntimeError, match="invalid coordinator"):
        dmod.initialize(cfg, backoff_s=0.5)
    assert len(calls) == 1


@pytest.mark.parametrize("extra,match", [
    (["--dispatch", "overlap"], "requires --overlap one_cycle"),
    (["--procs", "3"], "divide"),
    (["--procs", "4", "--wire-format", "int8", "--overlap", "one_cycle",
      "--dispatch", "overlap"], "'host'"),
    # a fault plan's reshuffling autotune could put an inner group across
    # the processes
    (["--wire-format", "int8", "--overlap", "one_cycle", "--dispatch", "overlap",
      "--autotune", "--fault-plan", '{"events": []}'], "--dispatch serial"),
])
def test_launcher_refuses_before_the_group_comes_up(monkeypatch, extra, match):
    from repro_torch.launch import distributed as dmod
    from repro_torch.launch import train as launch_train

    def no_group(*a, **kw):
        raise AssertionError("the process group came up")

    monkeypatch.setattr(dmod.dist, "init_process_group", no_group)
    monkeypatch.setenv("DASO_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("DASO_NUM_PROCS", "2")
    monkeypatch.setenv("DASO_PROC_ID", "0")
    with pytest.raises(SystemExit, match=match):
        launch_train.main(["--tiny", "--device", "cpu", "--steps", "2", "--distributed",
                           "--topology", TOPOLOGY] + extra)


def test_distributed_needs_a_topology():
    from repro_torch.launch import train as launch_train

    with pytest.raises(SystemExit, match="--topology"):
        launch_train.main(["--tiny", "--device", "cpu", "--steps", "2", "--distributed"])


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
