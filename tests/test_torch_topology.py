"""The port's topology subsystem (`repro_torch.topo`, the N-level controller
and the group mean) held against the JAX package on the CPU:

  * the spec: `to_str` and `to_json` equal the reference's for a list of
    specs (defaults, `%period` pins, names with x and digits, a fanout-1
    level), the same parse errors, the same structure and node paths;
  * the lowering: `derive_inner_periods` with and without `bandwidths=`,
    `daso_config_from` field by field, `make_controller`'s type;
  * `HierDasoController`: the same mode history, `level_sync_counts` and
    state_dict as the reference's for the same loss stream, per step and
    through `plan_cycle`, and a state_dict round trip;
  * `level_group_mean`: bit for bit the reference's, in both of its tiers
    (`deterministic` off and on), over groups 2..4 x per 1..3, f32 and
    int32 leaves, the f32 and bf16 wires, with and without a permutation,
    and bit for bit an explicit numpy per-group chain oracle; the global
    mean kept under every permutation of 4 replicas;
  * the masked group mean (elastic membership) bit for bit the
    reference's over the same cases, and `build_topology_strategy` taking a
    membership mask;
  * the refusals: the int8 wire, a group size that does not divide R,
    `hier_daso` without a spec; retune answering as the reference's.
Inputs are made from a seed with numpy."""
import dataclasses
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import daso as jdaso
from repro.core import schedule as jschedule
from repro.topo import lower as jlower
from repro.topo import spec as jspec
from repro.train import loop as jloop
from repro_torch.core import daso, schedule
from repro_torch.topo import lower, spec
from repro_torch.train import loop

# defaults, %period pins (inner and outer), explicit bandwidth / latency, a
# fanout-1 level, names with x and digits, the three separators, 2 to 5 levels
SPECS = [
    "chip:4 x pod:4",
    "chip:4 x host:2 x pod:2",
    "chip:4 x host:2@50e9 x pod:2@25e9",
    "chip:4 × host:2@5e10/1e-5%3, pod:2",
    "chip:4 x host:2@50e9%1 x pod:2@25e9%8",
    "chip:4 x host:1 x pod:2",
    "proxy:4 x box:2 x pod:2",
    "chip:2 × tier2:2 × pod:2",
    "gpu:8,host:4,rack:2,pod:3",
    "chip:1 x host:2 x rack:2 x pod:2 x dc:2@1e9/0.001",
]
BAD_SPECS = ["chip:4", "chip:4 x chip:2", "chip:0 x pod:2", "Chip:4 x pod:2", "",
             "chip:4 x pod", "chip:4 x pod:2@", "chip:4 x pod:2%0", "chip:4x pod:2"]


@pytest.mark.parametrize("text", SPECS)
def test_spec_round_trips_as_the_reference(text, tmp_path):
    want, got = jspec.TopologySpec.parse(text), spec.TopologySpec.parse(text)
    assert got.to_str() == want.to_str()
    assert got.to_json() == want.to_json()
    # the string keeps 6 digits (`:g`): a 4th level's default latency
    # (30e-6 * 10 = 0.00030000000000000003) comes back as 0.0003 in both
    # packages (ROADMAP §3, reference hazards); JSON keeps every digit
    again = spec.TopologySpec.parse(got.to_str())
    assert (again == got) == (jspec.TopologySpec.parse(want.to_str()) == want)
    assert again.to_str() == got.to_str()
    assert (again == got) or got.n_levels >= 4
    assert spec.TopologySpec.from_json(got.to_json()) == got
    path = tmp_path / "topo.json"
    path.write_text(want.to_json())
    assert spec.TopologySpec.load(str(path)) == got == spec.TopologySpec.load(got.to_json())
    assert (got.n_levels, got.local_world, got.n_replicas, got.world, got.inner_names(),
            got.mesh_axis_names(), got.mesh_shape(), got.inner_periods_explicit()) == \
        (want.n_levels, want.local_world, want.n_replicas, want.world, want.inner_names(),
         want.mesh_axis_names(), want.mesh_shape(), want.inner_periods_explicit())
    for lvl in got.levels[1:]:
        assert got.group_size(lvl.name) == want.group_size(lvl.name)


@pytest.mark.parametrize("text", BAD_SPECS)
def test_spec_parse_errors_as_the_reference(text):
    with pytest.raises(ValueError) as want:
        jspec.TopologySpec.parse(text)
    with pytest.raises(ValueError) as got:
        spec.TopologySpec.parse(text)
    assert str(got.value) == str(want.value)


def test_spec_node_paths_and_two_level_as_the_reference():
    text = "chip:2 × tier2:2 × pod:3"
    want, got = jspec.TopologySpec.parse(text), spec.TopologySpec.parse(text)
    for node in ("pod0", "pod2", "pod1/tier21", "pod2/tier20"):
        assert got.replicas_of(node) == want.replicas_of(node)
    for node in ("tier21", "pod1/chip0", "pod3", "pod1/tier22", "rack1", "chip0"):
        with pytest.raises(ValueError) as w:
            want.replicas_of(node)
        with pytest.raises(ValueError) as g:
            got.replicas_of(node)
        assert str(g.value) == str(w.value)
    with pytest.raises(ValueError):
        got.group_size("chip")
    assert spec.TopologySpec.two_level(local_world=4, n_replicas=4).to_str() == \
        jspec.TopologySpec.two_level(local_world=4, n_replicas=4).to_str()
    assert [spec.default_bandwidth(i) for i in range(5)] == \
        [jspec.default_bandwidth(i) for i in range(5)]
    assert [spec.default_latency(i) for i in range(5)] == \
        [jspec.default_latency(i) for i in range(5)]


# -- lowering ---------------------------------------------------------------------

@pytest.mark.parametrize("text", SPECS)
@pytest.mark.parametrize("b_max", [1, 4, 8])
def test_lowering_matches_the_reference(text, b_max):
    want, got = jspec.TopologySpec.parse(text), spec.TopologySpec.parse(text)
    assert lower.derive_inner_periods(got, b_max=b_max) == \
        jlower.derive_inner_periods(want, b_max=b_max)
    measured = {lvl.name: lvl.bandwidth / 4 for lvl in got.levels[1::2]}
    assert lower.derive_inner_periods(got, b_max=b_max, bandwidths=measured) == \
        jlower.derive_inner_periods(want, b_max=b_max, bandwidths=measured)
    kw = dict(b_max=b_max, warmup_steps=2, cooldown_steps=3, total_steps=40)
    tcfg, jcfg = lower.daso_config_from(got, **kw), jlower.daso_config_from(want, **kw)
    # exchange_kernels: the port's one exchange path runs through the
    # kernels, where the reference defaults to jnp (core/daso.py DasoConfig)
    assert tcfg.exchange_kernels and not jcfg.exchange_kernels
    for f in dataclasses.fields(tcfg):
        if f.name != "exchange_kernels":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    tc, jc = lower.make_controller(got, tcfg), jlower.make_controller(want, jcfg)
    assert type(tc).__name__ == type(jc).__name__
    if isinstance(tc, schedule.HierDasoController):
        assert (tc.inner_periods, tc.pinned_periods) == (jc.inner_periods, jc.pinned_periods)


def test_lowering_refusals():
    s = spec.TopologySpec.parse("chip:4 x host:2 x pod:2")
    with pytest.raises(ValueError, match="b_max"):
        lower.derive_inner_periods(s, b_max=0)
    with pytest.raises(ValueError, match="does not match"):
        lower.make_controller(s, daso.DasoConfig(n_replicas=2, global_world=8))


# -- the N-level controller -------------------------------------------------------

def _loss_trace(n):
    """Falls for 30 steps, then flat: windows of 5 at patience 2 halve B/W
    twice and then reset them (tests/test_torch_daso.py)."""
    return [5.0 - 0.1 * min(t, 30) + 0.001 * (t % 3) for t in range(n)]


def _hier_controllers(text="chip:4 x host:2@50e9 x pod:2@25e9", overlap="off"):
    kw = dict(warmup_steps=3, cooldown_steps=4, total_steps=120, plateau_patience=2,
              overlap=overlap)
    jsp, tsp = jspec.TopologySpec.parse(text), spec.TopologySpec.parse(text)
    return (jlower.make_controller(jsp, jlower.daso_config_from(jsp, **kw), loss_window=5),
            lower.make_controller(tsp, lower.daso_config_from(tsp, **kw), loss_window=5))


def _json(sd):
    return json.loads(json.dumps(sd))


@pytest.mark.parametrize("text,overlap", [
    ("chip:4 x host:2@50e9 x pod:2@25e9", "off"),
    ("chip:4 x host:2@50e9 x pod:2@25e9", "one_cycle"),
    ("chip:2 x host:2@100e9%1 x rack:2@50e9 x pod:2@25e9", "off")])
def test_hier_controller_matches_the_reference(text, overlap):
    jc, tc = _hier_controllers(text, overlap)
    assert isinstance(tc, schedule.HierDasoController)
    for t, loss in enumerate(_loss_trace(120)):
        assert tc.mode_for_step(t) == jc.mode_for_step(t)
        jc.observe_loss(loss)
        tc.observe_loss(loss)
        assert _json(tc.state_dict()) == _json(jc.state_dict())
    assert tc.history == [tuple(h) for h in jc.history]
    assert tc.level_sync_counts() == jc.level_sync_counts()
    assert tc.global_sync_fraction() == jc.global_sync_fraction()
    counts = tc.level_sync_counts()
    for name in tc.inner_periods:
        assert counts[name] == sum(name in h[1].partition("+")[2].split(",")
                                   for h in tc.history) > 0
    assert not any("+" in h[1] for h in tc.history if h[1] == "blocking")


def test_hier_controller_plan_cycle_matches_the_reference():
    jc, tc = _hier_controllers()
    losses, t = _loss_trace(120), 0
    while t < 120:
        shape = tc.plan_cycle(t, max_len=8)
        assert shape == jc.plan_cycle(t, max_len=8)
        for loss in losses[t:t + len(shape)]:
            jc.observe_loss(loss)
            tc.observe_loss(loss)
        t += len(shape)
    assert _json(tc.state_dict()) == _json(jc.state_dict())


def test_level_sync_counts_of_the_base_controller_match_the_reference():
    kw = dict(n_replicas=4, global_world=16, warmup_steps=3, cooldown_steps=4,
              total_steps=60)
    jc = jschedule.DasoController(jdaso.DasoConfig(**kw), loss_window=5)
    tc = schedule.DasoController(daso.DasoConfig(**kw), loss_window=5)
    for t, loss in enumerate(_loss_trace(60)):
        tc.mode_for_step(t)
        jc.mode_for_step(t)
        tc.observe_loss(loss)
        jc.observe_loss(loss)
    assert tc.level_sync_counts() == jc.level_sync_counts()
    tc.history.append((60, "hard_avg", 4, 1))
    jc.history.append((60, "hard_avg", 4, 1))
    assert tc.level_sync_counts() == jc.level_sync_counts()


def test_hier_controller_state_round_trip_keeps_the_periods():
    _, tc = _hier_controllers()
    for t, loss in enumerate(_loss_trace(40)):
        tc.mode_for_step(t)
        tc.observe_loss(loss)
    sd = _json(tc.state_dict())
    assert sd["inner_periods"] == {"host": 2}
    sd["inner_periods"] = {"host": 3}
    fresh = _hier_controllers()[1]
    fresh.load_state_dict(sd)
    assert fresh.inner_periods == {"host": 3}
    tc.inner_periods = {"host": 3}
    assert [fresh.mode_for_step(t) for t in range(40, 70)] == \
        [tc.mode_for_step(t) for t in range(40, 70)]
    # a state dict without the key keeps the lowered periods, as the reference
    del sd["inner_periods"]
    fresh = _hier_controllers()[1]
    fresh.load_state_dict(sd)
    assert fresh.inner_periods == {"host": 2}
    with pytest.raises(ValueError, match="period"):
        schedule.HierDasoController(daso.DasoConfig(n_replicas=4, global_world=16),
                                    inner_periods={"host": 0})


# -- the group mean ---------------------------------------------------------------

def _group_tree(R, seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((R, 3, 2)).astype(np.float32),
            "b": {"w": (100 * rng.standard_normal((R, 5))).astype(np.float32),
                  "n": rng.integers(-50, 50, (R, 4)).astype(np.int32)}}


def _oracle(x, per, perm, wire):
    """The explicit per-group mean in numpy: each group's rows in slot
    order, added one by one in the wire's dtype, times 1/g rounded to that
    dtype; integer leaves in f32, rounded half to even."""
    R = x.shape[0]
    slots = list(perm) if perm is not None else list(range(R))
    if x.dtype.kind == "f":
        dt = jnp.bfloat16 if wire == "bf16" else np.float32
    else:
        dt = np.float32
    w = x.astype(dt)
    out = np.empty_like(x)
    inv = np.asarray(1.0 / per, dtype=dt)
    for j in range(R // per):
        members = slots[j * per:(j + 1) * per]
        acc = w[members[0]]
        for rep in members[1:]:
            acc = (acc + w[rep]).astype(dt)
        m = (acc * inv).astype(dt)
        m = np.round(m.astype(np.float32)) if x.dtype.kind != "f" else m
        out[members] = m.astype(x.dtype)
    return out


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype.kind == "f" else a


@pytest.mark.parametrize("groups,per", list(itertools.product(range(2, 5), range(1, 4))))
def test_level_group_mean_bit_exact_with_the_reference_and_the_oracle(groups, per):
    R = groups * per
    for seed, det, wire, permuted in itertools.product(
            (0, 1), (False, True), ("f32", "bf16"), (False, True)):
        tree = _group_tree(R, seed)
        perm = tuple(np.random.default_rng(seed).permutation(R)) if permuted else None
        want = jdaso.level_group_mean(jax.tree.map(jnp.asarray, tree), per,
                                      wire_format=wire, deterministic=det, perm=perm)
        got = daso.level_group_mean(jax.tree.map(torch.from_numpy, tree), per,
                                    wire_format=wire, perm=perm)
        for x, w, g in zip(jax.tree.leaves(tree), jax.tree.leaves(want),
                           jax.tree.leaves(got), strict=True):
            assert g.dtype == torch.from_numpy(x).dtype and g.shape == x.shape
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(np.asarray(w)))
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(_oracle(x, per, perm, wire)))


@pytest.mark.parametrize("groups,per", list(itertools.product(range(2, 5), range(1, 4))))
def test_masked_level_group_mean_bit_exact_with_the_reference(groups, per):
    """The cases of the test above under membership masks (one random mask
    per seed, and one whose first group is wholly dropped): bit for bit the
    reference's default tier, f32 and bf16 wires, with and without a
    permutation (the mask travels with its rows)."""
    R = groups * per
    for seed, wire, permuted in itertools.product((0, 1), ("f32", "bf16"), (False, True)):
        tree = _group_tree(R, seed)
        rng = np.random.default_rng(seed + 10)
        perm = tuple(rng.permutation(R)) if permuted else None
        masks = [tuple(float(m) for m in rng.integers(0, 2, R)),
                 tuple(0.0 if i < per else 1.0 for i in range(R))]
        for mask in masks:
            if not any(mask) or all(mask):
                continue
            want = jdaso.level_group_mean(jax.tree.map(jnp.asarray, tree), per,
                                          wire_format=wire, mask=mask, perm=perm)
            got = daso.level_group_mean(jax.tree.map(torch.from_numpy, tree), per,
                                        wire_format=wire, mask=mask, perm=perm)
            for x, w, g in zip(jax.tree.leaves(tree), jax.tree.leaves(want),
                               jax.tree.leaves(got), strict=True):
                assert g.dtype == torch.from_numpy(x).dtype and g.shape == x.shape
                np.testing.assert_array_equal(_bits(g.numpy()), _bits(np.asarray(w)),
                                              err_msg=str((seed, wire, perm, mask)))


def test_build_topology_strategy_takes_a_membership_mask():
    """`membership=` sets the lowered strategy's mask (2-level: the stock
    daso strategy; 3-level: hier_daso), and a masked hier step with a host
    sync gives the reference's carry within rtol 2e-5, the dropped rows
    frozen."""
    mask = (1.0, 0.0, 1.0, 1.0)
    for text in ("chip:4 x pod:4", "chip:2 x host:2 x pod:2"):
        s = spec.TopologySpec.parse(text)
        strat = lower.build_topology_strategy(None, None, s, membership=mask)
        assert strat.membership == mask and strat.n_active() == 3 and strat.topo is s
        assert lower.build_topology_strategy(None, None, s).membership is None
    from repro.optim.optimizers import sgd as jax_sgd
    from repro_torch.optim.optimizers import sgd
    rng = np.random.default_rng(4)
    w0 = rng.standard_normal((4, 3, 2)).astype(np.float32)
    x = rng.standard_normal((4, 5, 3)).astype(np.float32)

    def loss(p, b):
        return ((b["x"] @ p["w"]) ** 2).mean(), {}

    text = "chip:2 x host:2 x pod:2"
    out = []
    for mod, sp, opt, conv in ((lower, spec, sgd, torch.from_numpy),
                               (jlower, jspec, jax_sgd, jnp.asarray)):
        strat = mod.build_topology_strategy(loss, opt(momentum=0.9),
                                            sp.TopologySpec.parse(text), membership=mask)
        carry = strat.init_carry({"w": conv(w0[0])})
        carry = ({"w": conv(w0)},) + tuple(carry[1:])
        carry, _ = strat.step_fn("local+host", 1)(carry, {"x": conv(x)}, 0.1)
        out.append(np.asarray(carry[0]["w"]))
    np.testing.assert_allclose(out[0], out[1], rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(out[0][1], w0[1])


def test_level_group_mean_of_the_whole_axis_is_the_replica_mean():
    tree = jax.tree.map(torch.from_numpy, _group_tree(4, 2))
    for wire in ("f32", "bf16"):
        got = daso.level_group_mean(tree, 4, wire_format=wire, perm=(3, 1, 0, 2))
        want = daso.replica_mean(tree, wire_format=wire)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want), strict=True):
            assert torch.equal(a, b)


def test_level_group_mean_keeps_the_global_mean_under_any_permutation():
    """Each group mean keeps its group's sum (to rounding), so the mean of
    the group means is the mean of the rows, for every permutation of 4."""
    x = {"w": torch.from_numpy(np.random.default_rng(3).standard_normal((4, 64)))}
    want = x["w"].mean(0)
    for perm in itertools.permutations(range(4)):
        got = daso.level_group_mean(x, 2, perm=perm)["w"]
        torch.testing.assert_close(got.mean(0), want, rtol=0, atol=1e-12)
        pairs = (perm[:2], perm[2:])
        for pair in pairs:
            assert torch.equal(got[pair[0]], got[pair[1]])


def test_level_group_mean_leaves_its_input_and_owns_its_output():
    tree = jax.tree.map(torch.from_numpy, _group_tree(4, 4))
    before = [x.clone() for x in jax.tree.leaves(tree)]
    got = daso.level_group_mean(tree, 2)
    for x, b in zip(jax.tree.leaves(tree), before):
        assert torch.equal(x, b)
    ins = {x.untyped_storage().data_ptr() for x in jax.tree.leaves(tree)}
    assert not ins & {x.untyped_storage().data_ptr() for x in jax.tree.leaves(got)}


def test_group_mean_refusals():
    x = {"w": torch.zeros(4, 2)}
    with pytest.raises(ValueError, match="not divisible"):
        daso.level_group_mean(x, 3)
    with pytest.raises(ValueError, match="int8"):
        daso.level_group_mean(x, 2, wire_format="int8")
    with pytest.raises(ValueError, match="not a permutation"):
        daso.level_group_mean(x, 2, perm=(0, 0, 1, 2))
    assert daso.normalize_group_perm((0, 1, 2, 3), 4) is None
    assert daso.normalize_group_perm([1, 0, 3, 2], 4) == \
        jdaso.normalize_group_perm([1, 0, 3, 2], 4) == (1, 0, 3, 2)
    cfg = daso.DasoConfig(n_replicas=4, global_world=16)
    for g in (1, 5):
        with pytest.raises(ValueError, match="outside 2..4"):
            daso.daso_train_step(None, None, cfg, mode="local", inner_syncs=(("host", g),))
    # retune (item 18) works: the same answer and periods as the reference's
    jc, tc = _hier_controllers()
    assert tc.retune({"_outer": 1.0, "host": 0.5}) == jc.retune({"_outer": 1.0, "host": 0.5})
    assert tc.inner_periods == jc.inner_periods == {"host": 2}


def test_train_loop_topology_refusals_match_the_reference():
    for kw in (dict(strategy="hier_daso"), dict(strategy="sync", topology="chip:2 x pod:2"),
               dict(strategy="local_sgd", topology="chip:2 x pod:2")):
        with pytest.raises(ValueError):
            jloop.build_strategy(None, jloop.TrainLoopConfig(**kw), None)
        with pytest.raises(ValueError, match="hier_daso|topology"):
            loop.build_strategy(None, loop.TrainLoopConfig(**kw), None)
    strat = loop.build_strategy(None, loop.TrainLoopConfig(
        topology="chip:2 x host:2 x pod:2%2", n_replicas=9, local_world=9), None)
    assert type(strat).__name__ == "HierDasoStrategy" and strat.name == "hier_daso"
    assert (strat.cfg.n_replicas, strat.cfg.global_world, strat.cfg.b_max) == (4, 8, 2)
    two = loop.build_strategy(None, loop.TrainLoopConfig(topology="chip:4 x pod:4"), None)
    assert type(two).__name__ == "DasoStrategy" and two.topo.n_replicas == 4
