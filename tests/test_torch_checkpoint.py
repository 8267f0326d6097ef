"""The port's checkpoints (`repro_torch.checkpoint.io`) on the CPU:

  * twins of tests/test_checkpoint.py: bit-exact round trips of mixed
    dtypes in dict / list / tuple containers, optimizer states and the
    TrainState, and the version guard;
  * twins of tests/test_overlap.py's checkpoint tests and of
    tests/test_live_faults.py's crash-safety tests: the bit-exact resume of
    a run in one_cycle overlap, the overlap-mismatch refusal, a v1 state
    loading as "off", torn / truncated / missing files refused, and
    `fallback=True` / `load_latest_train_state` skipping a torn newest
    snapshot;
  * the on-disk layout shared with the JAX package: either package loads
    the other's TrainState and params checkpoints bit for bit, and a JAX run
    checkpointed at step k and resumed by the port's `run_training` gives
    JAX's uninterrupted run within RTOL;
  * a hier_daso TrainState (a 3-level topology) written by either package
    resumes in both with its per-level periods and the same schedule;
  * the port's resume equals its uninterrupted run bit for bit (losses and
    the whole final carry) on both executors, overlap off and one_cycle,
    the loaded carry keeps exactly the aliasing the running one had (shared
    tensors, rows broadcast along the replica axis) and its empty
    containers, and a carry of another shape is refused by its path;
  * the launchers: `launch.train --ckpt / --ckpt-every / --resume`, and
    `launch.serve --ckpt` giving the JAX
    engine's tokens on the same checkpoint, refusing params of another
    config by the first leaf that differs.

The training problem is tests/conftest.py's MLP made with numpy, the same
arrays into both packages."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.core.daso import DasoConfig as JaxDasoConfig
from repro.core.schedule import DasoController as JaxDasoController
from repro.optim.optimizers import sgd as jax_sgd
from repro.optim.schedules import constant_lr as jax_constant_lr
from repro.train.loop import TrainLoopConfig as JaxTrainLoopConfig
from repro.train.loop import run_training as jax_run_training
from repro.configs import get_reduced as jax_get_reduced
from repro.serve.engine import Engine as JaxEngine
from repro_torch.checkpoint import io
from repro_torch.configs import get_reduced
from repro_torch.convert import state_from_jax
from repro_torch.core.daso import DasoConfig
from repro_torch.core.schedule import DasoController
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models.lm import init_params
from repro_torch.optim.optimizers import adamw, sgd
from repro_torch.optim.schedules import constant_lr
from repro_torch.train.loop import TrainLoopConfig, ckpt_step_dir, run_training
from repro_torch.tree import leaves

RTOL = 1e-4  # tests/test_torch_train.py: a JAX run against the port's
D, H, PER, R = 8, 16, 16, 2


def _bits(t):
    """The raw bits of a tensor, flat (so -0.0 differs from 0.0)."""
    t = t.contiguous().reshape(-1)
    if t.dtype == torch.bool:
        return t
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _assert_identical(a, b):
    """Same containers (a tuple is not a list), dtypes and bits."""
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_identical(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_identical(x, y)
    else:
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
        assert torch.equal(_bits(a), _bits(b))


def _structure(tree):
    """The containers of a tree, its leaves as None."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_structure(v) for v in tree)
    return None


def _np(x):
    """A JAX or numpy leaf as numpy, bf16 widened to f32."""
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


# -- round trips ---------------------------------------------------------------------

_LEAF_SPECS = [("float32", (3, 4)), ("float32", (7,)), ("bfloat16", (5, 3)),
               ("bfloat16", (2,)), ("float16", (4,)), ("int32", (6,)),
               ("int8", (3, 3)), ("uint8", (2, 2)), ("bool", (3,)), ("float32", ())]


def _leaves(seed):
    rng = np.random.default_rng(seed)
    out = []
    for dt, shape in _LEAF_SPECS:
        if dt == "bool":
            x = torch.from_numpy(rng.integers(0, 2, shape).astype(bool))
        elif dt.startswith(("int", "uint")):
            lo = 0 if dt.startswith("u") else -100
            x = torch.from_numpy(rng.integers(lo, 100, shape)).to(getattr(torch, dt))
        else:
            x = torch.from_numpy(np.asarray(3 * rng.standard_normal(shape))).to(getattr(torch, dt))
        out.append(x)
    out[2][0, 0], out[0][0, 0] = -0.0, float("inf")
    return out


def _container(kind, xs):
    if kind == "dict":
        return {f"k{i}": x for i, x in enumerate(xs)}
    if kind == "list":
        return list(xs)
    if kind == "tuple":
        return tuple(xs)
    return {"a": (xs[0], list(xs)), "b": {"c": tuple(xs), "d": [{"e": xs[3]}]}}


@pytest.mark.parametrize("kind", ["dict", "list", "tuple", "nested"])
def test_roundtrip_mixed_dtypes_and_containers(kind, tmp_path):
    """save -> load is bit-identical (bf16 through the exact f32 widening,
    -0.0 and inf kept) and container-exact: lists come back lists, tuples
    tuples."""
    tree = _container(kind, _leaves(len(kind)))
    io.save_checkpoint(str(tmp_path), tree, step=3)
    loaded, manifest = io.load_checkpoint(str(tmp_path), device="cpu")
    assert manifest["step"] == 3
    _assert_identical(tree, loaded)


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_optimizer_state_roundtrip(name, tmp_path):
    """Optimizer states (momentum trees, adamw's int32 step counter) after
    one update survive the checkpoint exactly."""
    opt = sgd(momentum=0.9) if name == "sgd" else adamw()
    params = {"w": torch.ones(3, 2), "b": torch.zeros(2, dtype=torch.bfloat16)}
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    _, state = opt.update(grads, opt.init(params), params, 0.1)
    io.save_checkpoint(str(tmp_path), {"opt": state})
    loaded, _ = io.load_checkpoint(str(tmp_path), device="cpu")
    _assert_identical(state, loaded["opt"])


def _controller_with_history(cls, cfg_cls):
    cfg = cfg_cls(n_replicas=2, global_world=8, b_max=4, warmup_steps=2,
                  cooldown_steps=2, total_steps=30)
    c = cls(cfg, loss_window=5)
    for t in range(12):
        c.mode_for_step(t)
        c.observe_loss(1.0 / (t + 1))
    return cfg, c


def test_train_state_roundtrip(tmp_path):
    """A TrainState: a tuple carry with a bf16 leaf, the controller's state
    (its schedule continues the same), membership, an rng array and the
    losses."""
    cfg, c = _controller_with_history(DasoController, DasoConfig)
    carry = ({"w": torch.ones(2, 3, 3), "b": torch.zeros(2, 4, dtype=torch.bfloat16)},
             {"mu": {"w": torch.full((2, 3, 3), 0.5)}},
             {"w": torch.ones(2, 3, 3) * 2})
    rng = np.array([0, 7], np.uint32)
    state = io.TrainState(step=12, carry=carry, controller=c.state_dict(),
                          membership=[1.0, 0.0], rng=rng, strategy="daso",
                          losses=[1.0, 0.5, 0.25])
    io.save_train_state(str(tmp_path), state)
    loaded = io.load_train_state(str(tmp_path), device="cpu")
    assert (loaded.version, loaded.step, loaded.strategy) == (io.TRAIN_STATE_VERSION, 12,
                                                              "daso")
    assert loaded.membership == [1.0, 0.0] and loaded.losses == [1.0, 0.5, 0.25]
    assert loaded.overlap == "off"
    _assert_identical(carry, loaded.carry)
    assert isinstance(loaded.rng, np.ndarray)
    np.testing.assert_array_equal(loaded.rng, rng)
    c2 = DasoController(cfg, loss_window=5)
    c2.load_state_dict(loaded.controller)
    assert c2.state_dict() == c.state_dict()
    for t in range(12, 20):
        assert c2.mode_for_step(t) == c.mode_for_step(t)


def test_train_state_version_guard(tmp_path):
    """A newer TrainState version is refused; a bare parameter checkpoint is
    not taken for a TrainState."""
    io.save_train_state(str(tmp_path / "new"), io.TrainState(
        step=1, carry=({"w": torch.ones(2)},), version=io.TRAIN_STATE_VERSION + 1))
    with pytest.raises(ValueError, match="newer"):
        io.load_train_state(str(tmp_path / "new"), device="cpu")
    io.save_checkpoint(str(tmp_path / "bare"), {"w": torch.ones(2)})
    with pytest.raises(ValueError, match="not a TrainState"):
        io.load_train_state(str(tmp_path / "bare"), device="cpu")


def test_loaders_run_on_cuda_unless_the_cpu_is_asked(tmp_path, monkeypatch):
    io.save_checkpoint(str(tmp_path), {"w": torch.ones(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        io.load_checkpoint(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        io.load_train_state(str(tmp_path))


def test_overlap_layout_mismatch_rejected_and_v1_defaults_to_off(tmp_path):
    """tests/test_overlap.py's two layout tests: a 3-slot ("off") carry is
    refused by a one_cycle run with the flag to restart with, and a v1
    state (no overlap key) loads as "off"."""
    path = str(tmp_path / "st")
    carry = ({"w": torch.ones(2, 3)}, {"m": torch.zeros(2, 3)}, {"w": torch.zeros(2, 3)})
    io.save_train_state(path, io.TrainState(step=4, carry=carry, overlap="off"))
    with pytest.raises(ValueError, match="--overlap off"):
        io.load_train_state(path, device="cpu", expect_overlap="one_cycle")
    assert io.load_train_state(path, device="cpu", expect_overlap="off").overlap == "off"
    mf = os.path.join(path, "manifest.json")
    with open(mf) as f:
        manifest = json.load(f)
    host = manifest["extra"]["train_state"]
    host["version"] = 1
    del host["overlap"]
    with open(mf, "w") as f:
        json.dump(manifest, f)
    ts = io.load_train_state(path, device="cpu", expect_overlap="off")
    assert (ts.overlap, ts.version) == ("off", 1)
    with pytest.raises(ValueError, match="--overlap off"):
        io.load_train_state(path, device="cpu", expect_overlap="one_cycle")


def test_overlap_controller_roundtrip_through_a_train_state(tmp_path):
    """A one_cycle controller checkpointed mid-cycle (`_ov_last` set) plans
    the same modes after a load."""
    cfg = DasoConfig(n_replicas=2, global_world=8, b_max=4, warmup_steps=3,
                     cooldown_steps=0, total_steps=40, overlap="one_cycle")
    a = DasoController(cfg, loss_window=50)
    for t in range(9):
        a.mode_for_step(t)
    io.save_train_state(str(tmp_path), io.TrainState(
        step=9, carry=(torch.ones(2),), controller=a.state_dict(), overlap="one_cycle"))
    b = DasoController(cfg, loss_window=50)
    b.load_state_dict(io.load_train_state(str(tmp_path), device="cpu",
                                          expect_overlap="one_cycle").controller)
    assert b._ov_last == a._ov_last == 7
    for t in range(9, 20):
        assert a.mode_for_step(t) == b.mode_for_step(t)


# -- crash safety ------------------------------------------------------------------------

def _tiny_state(step):
    return io.TrainState(step=step, carry=({"w": torch.arange(12.0).reshape(3, 4) + step},),
                         losses=[float(step)])


def _corrupt(path, how):
    """A crash mid-save: tests/test_live_faults.py::_corrupt."""
    npz, man = os.path.join(path, "arrays.npz"), os.path.join(path, "manifest.json")
    if how == "truncate_arrays":
        with open(npz, "r+b") as f:
            f.truncate(os.path.getsize(npz) // 2)
    elif how == "truncate_manifest":
        with open(man, "r+b") as f:
            f.truncate(max(1, os.path.getsize(man) // 2))
    elif how == "missing_manifest":
        os.remove(man)
    elif how == "missing_arrays":
        os.remove(npz)
    elif how == "torn_pair":
        # the arrays of one save beside the manifest of another
        with open(man) as f:
            doc = json.load(f)
        doc["save_id"] = "9999-0-deadbeef"
        with open(man, "w") as f:
            json.dump(doc, f)
    else:
        raise AssertionError(how)


@pytest.mark.parametrize("how", ["truncate_arrays", "truncate_manifest", "missing_manifest",
                                 "missing_arrays", "torn_pair"])
def test_corrupt_checkpoint_detected_and_fallback(tmp_path, how):
    """A snapshot torn by a crash is refused (never half loaded); with
    fallback=True, and in load_latest_train_state, the newest intact
    sibling is taken."""
    ckpt = str(tmp_path / "ck")
    for step in (4, 8):
        io.save_train_state(ckpt_step_dir(ckpt, step), _tiny_state(step))
    newest = ckpt_step_dir(ckpt, 8)
    _corrupt(newest, how)
    with pytest.raises(io.CheckpointCorruptError):
        io.load_train_state(newest, device="cpu")
    st = io.load_train_state(newest, device="cpu", fallback=True)
    assert st.step == 4
    np.testing.assert_array_equal(st.carry[0]["w"].numpy(), np.arange(12.0).reshape(3, 4) + 4)
    path, st2 = io.load_latest_train_state(ckpt, device="cpu")
    assert st2.step == 4 and path == ckpt_step_dir(ckpt, 4)


def test_no_intact_snapshot_raises_and_dirs_list_newest_first(tmp_path):
    ckpt = str(tmp_path / "ck")
    for step in (3, 12, 7):
        io.save_train_state(ckpt_step_dir(ckpt, step), _tiny_state(step))
    (tmp_path / "ck" / "not_a_step").mkdir()
    assert io.list_train_state_dirs(ckpt) == [ckpt_step_dir(ckpt, s) for s in (12, 7, 3)]
    for step in (3, 12, 7):
        _corrupt(ckpt_step_dir(ckpt, step), "truncate_arrays")
    with pytest.raises(io.CheckpointCorruptError, match="no intact"):
        io.load_latest_train_state(ckpt, device="cpu")
    with pytest.raises(io.CheckpointCorruptError):
        io.load_latest_train_state(str(tmp_path / "nonexistent"), device="cpu")


def test_atomic_rewrite_leaves_one_consistent_pair(tmp_path):
    d = str(tmp_path / "snap")
    io.save_train_state(d, _tiny_state(4))
    io.save_train_state(d, _tiny_state(9))
    assert io.load_train_state(d, device="cpu").step == 9
    assert not [p for p in os.listdir(d) if ".tmp." in p]


# -- the layout both packages share ------------------------------------------------------

def _jax_carry(seed, overlap):
    """A DASO carry with bf16, f32 and int leaves; the in-flight buffer a
    broadcast mean, the pending snapshot the params themselves."""
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((R, 3, 4)).astype(np.float32),
              "e": jnp.asarray(rng.standard_normal((R, 5)), jnp.bfloat16)}
    opt = {"mu": {"w": rng.standard_normal((R, 3, 4)).astype(np.float32),
                  "e": jnp.asarray(rng.standard_normal((R, 5)), jnp.bfloat16)},
           "t": jnp.asarray(3, jnp.int32)}
    inflight = jax.tree.map(lambda a: jnp.broadcast_to(jnp.asarray(a)[:1], a.shape), params)
    carry = (params, opt, inflight) + ((params,) if overlap == "one_cycle" else ())
    return jax.tree.map(jnp.asarray, carry)


@pytest.mark.parametrize("overlap", ["off", "one_cycle"])
def test_jax_train_state_loads_into_the_port(tmp_path, overlap):
    """JAX's save_train_state -> the port's load_train_state: every leaf bit
    for bit `convert.state_from_jax` of the same carry, the same
    containers, an equal host state; the rng key stays numpy."""
    _, c = _controller_with_history(JaxDasoController, JaxDasoConfig)
    carry = _jax_carry(0, overlap)
    state = jio.TrainState(step=12, carry=carry, controller=c.state_dict(), rng=
                           jax.random.PRNGKey(7), strategy="daso", losses=[2.0, 1.5],
                           overlap=overlap)
    jio.save_train_state(str(tmp_path), state)
    got = io.load_train_state(str(tmp_path), device="cpu", expect_overlap=overlap)
    _assert_identical(got.carry, state_from_jax(jax.tree.map(np.asarray, carry)))
    assert got.controller == json.loads(json.dumps(c.state_dict()))
    assert (got.step, got.strategy, got.losses, got.overlap, got.membership) == (
        12, "daso", [2.0, 1.5], overlap, None)
    np.testing.assert_array_equal(got.rng, np.asarray(jax.random.PRNGKey(7)))
    assert got.rng.dtype == np.uint32


@pytest.mark.parametrize("overlap", ["off", "one_cycle"])
def test_port_train_state_loads_into_jax(tmp_path, overlap):
    carry_np = jax.tree.map(np.asarray, _jax_carry(1, overlap))
    cfg, c = _controller_with_history(DasoController, DasoConfig)
    io.save_train_state(str(tmp_path), io.TrainState(
        step=12, carry=state_from_jax(carry_np), controller=c.state_dict(),
        strategy="daso", losses=[2.0, 1.5], overlap=overlap))
    got = jio.load_train_state(str(tmp_path), expect_overlap=overlap)
    want_l, want_t = jax.tree.flatten(carry_np)
    got_l, got_t = jax.tree.flatten(got.carry)
    assert got_t == want_t
    for a, b in zip(got_l, want_l, strict=True):
        assert str(a.dtype) == str(b.dtype)
        np.testing.assert_array_equal(_np(a), _np(b))
    jc = JaxDasoController(JaxDasoConfig(n_replicas=2, global_world=8, b_max=4,
                                         warmup_steps=2, cooldown_steps=2, total_steps=30),
                           loss_window=5)
    jc.load_state_dict(got.controller)
    for t in range(12, 20):
        assert jc.mode_for_step(t) == c.mode_for_step(t)
    assert (got.step, got.losses, got.overlap) == (12, [2.0, 1.5], overlap)


def test_params_checkpoints_load_across_packages(tmp_path):
    """A bare params checkpoint (the launchers' final params) written by
    either package loads in the other, bit for bit."""
    tree = {"embed": {"tok": np.random.default_rng(2).standard_normal((6, 4)).astype(
        np.float32)}, "blocks": [{"w": jnp.asarray(np.ones((2, 4, 4)), jnp.bfloat16)}],
            "final_norm": {"scale": np.zeros(4, np.float32)}}
    jio.save_checkpoint(str(tmp_path / "j"), jax.tree.map(jnp.asarray, tree), step=5)
    got, man = io.load_checkpoint(str(tmp_path / "j"), device="cpu")
    assert man["step"] == 5
    _assert_identical(got, state_from_jax(jax.tree.map(np.asarray, tree)))
    io.save_checkpoint(str(tmp_path / "t"), got, step=6)
    back, man = jio.load_checkpoint(str(tmp_path / "t"))
    assert man["step"] == 6 and man["dtypes"] == jio.load_checkpoint(
        str(tmp_path / "j"))[1]["dtypes"]
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree), strict=True):
        assert str(a.dtype) == str(jnp.asarray(b).dtype)
        np.testing.assert_array_equal(_np(a), _np(b))


# -- resume ----------------------------------------------------------------------------

def _mlp(seed=3):
    """tests/conftest.py's MLP made with numpy: params0, the data of a step
    (R, PER, D), and the loss in both frameworks."""
    rng = np.random.default_rng(seed)
    params0 = {"w1": (0.3 * rng.standard_normal((D, H))).astype(np.float32),
               "w2": (0.3 * rng.standard_normal((H, 1))).astype(np.float32)}
    wtrue = (0.5 * rng.standard_normal((D, H))).astype(np.float32)

    def batch(step):
        x = np.random.default_rng((seed, step)).standard_normal((R, PER, D)).astype(
            np.float32)
        return {"x": x, "y": (np.tanh(x @ wtrue).sum(-1, keepdims=True) * 0.3).astype(
            np.float32)}

    return params0, batch


def _jax_loss(params, b):
    return jnp.mean((jnp.tanh(b["x"] @ params["w1"]) @ params["w2"] - b["y"]) ** 2), {}


def _loss(params, b):
    return torch.mean((torch.tanh(b["x"] @ params["w1"]) @ params["w2"] - b["y"]) ** 2), {}


def _loop_kw(n_steps, executor, overlap, **kw):
    return dict(strategy="daso", n_steps=n_steps, n_replicas=R, local_world=4, b_max=4,
                loss_window=50, executor=executor, overlap=overlap, **kw)


def _run_port(n_steps, executor, overlap, **kw):
    params0, batch = _mlp()
    return run_training(_loss, {k: torch.from_numpy(v) for k, v in params0.items()},
                        lambda t: {k: torch.from_numpy(v) for k, v in batch(t).items()},
                        TrainLoopConfig(device="cpu", **_loop_kw(n_steps, executor, overlap,
                                                                 **kw)),
                        optimizer=sgd(momentum=0.9), lr_fn=constant_lr(0.05), log=None)


def _run_jax(n_steps, executor, overlap, **kw):
    params0, batch = _mlp()
    return jax_run_training(_jax_loss, jax.tree.map(jnp.asarray, params0),
                            lambda t: jax.tree.map(jnp.asarray, batch(t)),
                            JaxTrainLoopConfig(**_loop_kw(n_steps, executor, overlap, **kw)),
                            optimizer=jax_sgd(momentum=0.9), lr_fn=jax_constant_lr(0.05),
                            log=None)


@pytest.mark.parametrize("overlap", ["off", "one_cycle"])
@pytest.mark.parametrize("executor", ["macro", "per_step"])
def test_port_resume_is_bit_exact(tmp_path, executor, overlap):
    """tests/test_overlap.py:324's twin on both executors: a run resumed
    from its mid-run TrainState gives the uninterrupted run's losses and
    final carry (params, momentum, in-flight and pending of every replica)
    bit for bit."""
    ckpt = str(tmp_path / "ck")
    fresh = _run_port(24, executor, overlap)
    saved = _run_port(24, executor, overlap, ckpt_every=9, ckpt_dir=ckpt)
    dirs = io.list_train_state_dirs(ckpt)
    assert len(dirs) == 2  # one mid-run, one at the end
    assert saved.losses == fresh.losses
    resumed = _run_port(24, executor, overlap, resume_from=dirs[-1])
    assert io.load_train_state(dirs[-1], device="cpu").step < 24
    assert resumed.losses == fresh.losses
    _assert_identical(resumed.carry, fresh.carry)
    assert [h[1] for h in resumed.controller.history] == \
        [h[1] for h in fresh.controller.history]


def test_loaded_carry_restores_the_running_carrys_aliasing(tmp_path):
    """After an overlap merge the pending snapshot is the params and the
    in-flight buffer an expand of one mean row: the save records that and
    the loaded carry holds the same, so a resumed run holds no more than the
    uninterrupted one."""
    ckpt = str(tmp_path / "ck")
    _run_port(24, "macro", "one_cycle", ckpt_every=9, ckpt_dir=ckpt)
    path = io.list_train_state_dirs(ckpt)[-1]
    ts = io.load_train_state(path, device="cpu", expect_overlap="one_cycle")
    plan = [h[1] for h in io.load_train_state(path, device="cpu").controller["history"]]
    assert plan[-1].startswith("ov_sync")  # the snapshot follows an overlap merge
    params, opt, inflight, pending = ts.carry
    for k in params:
        assert pending[k] is params[k]
        assert inflight[k].stride(0) == 0 and inflight[k].shape[0] == R
        assert params[k].stride(0) != 0 and not torch.equal(params[k][0], params[k][1])
        assert opt["mu"][k] is not params[k]


def test_loaded_carry_keeps_only_the_aliasing_it_was_saved_with(tmp_path):
    """Leaves that were separate tensors stay separate even where their bits
    are equal (two zero-initialised leaves, a dense leaf whose rows are
    equal); a leaf that was one tensor with another, and a row broadcast
    along the replica axis, come back so. Without the record (the JAX
    package's checkpoints) every leaf loads dense."""
    z, row = torch.zeros(R, 3), torch.arange(3.0)
    carry = ({"a": z, "b": torch.zeros(R, 3), "c": row.repeat(R, 1)},
             {"m": row.unsqueeze(0).expand(R, 3)}, {"a": z})
    path = str(tmp_path / "s")
    io.save_train_state(path, io.TrainState(step=1, carry=carry))
    (p, o, q) = io.load_train_state(path, device="cpu").carry
    _assert_identical((p, o, q), carry)
    assert q["a"] is p["a"]
    assert p["b"].data_ptr() != p["a"].data_ptr() and p["c"].stride(0) != 0
    assert o["m"].stride(0) == 0
    mf = os.path.join(path, "manifest.json")
    with open(mf) as f:
        manifest = json.load(f)
    del manifest["extra"]["carry_layout"]
    with open(mf, "w") as f:
        json.dump(manifest, f)
    (p, o, q) = io.load_train_state(path, device="cpu").carry
    _assert_identical((p, o, q), carry)
    assert q["a"].data_ptr() != p["a"].data_ptr() and o["m"].stride(0) != 0


def test_resume_refuses_a_carry_of_another_shape(tmp_path):
    """The loaded carry is held to the run's carry leaf by leaf: a leaf of
    another shape is refused by its path in the checkpoint's spelling."""
    ckpt = str(tmp_path / "ck")
    _run_port(12, "macro", "off", ckpt_every=12, ckpt_dir=ckpt)
    path = ckpt_step_dir(ckpt, 12)
    ts = io.load_train_state(path, device="cpu")
    params, opt, inflight = ts.carry
    params["w1"] = params["w1"][:, :, :-1]
    io.save_train_state(path, io.TrainState(step=ts.step, carry=(params, opt, inflight),
                                            controller=ts.controller, losses=ts.losses))
    with pytest.raises(ValueError, match=r"carry/!0/w1: checkpoint shape \(2, 8, 15\), "
                                         r"this run's carry expects \(2, 8, 16\)"):
        _run_port(24, "macro", "off", resume_from=path)


@pytest.mark.parametrize("overlap", ["off", "one_cycle"])
def test_jax_checkpoint_resumed_by_the_port(tmp_path, overlap):
    """A JAX run checkpointed at step k and resumed by the port's
    run_training gives JAX's uninterrupted losses (the checkpoint's prefix
    included) and final params within RTOL, and its mode history."""
    ckpt = str(tmp_path / "ck")
    fresh = _run_jax(24, "macro", overlap)
    _run_jax(24, "macro", overlap, ckpt_every=9, ckpt_dir=ckpt)
    k_dir = jio.list_train_state_dirs(ckpt)[-1]
    resumed = _run_port(24, "macro", overlap, resume_from=k_dir)
    k = jio.load_train_state(k_dir).step
    assert 0 < k < 24
    assert resumed.losses[:k] == [float(x) for x in jio.load_train_state(k_dir).losses]
    np.testing.assert_allclose(resumed.losses, fresh.losses, rtol=RTOL)
    for a, b in zip(leaves(resumed.params), jax.tree.leaves(fresh.params), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-6)
    assert [h[1] for h in resumed.controller.history] == \
        [h[1] for h in fresh.controller.history]


HIER_SPEC = "chip:2 x host:2@50e9 x pod:2@25e9"  # R = 4, P = 8, B_host = 2


def _hier_run(package, n_steps, **kw):
    """A hier_daso run of the MLP at R = 4 from the spec, in either
    package, on the macro executor."""
    rng = np.random.default_rng(5)
    params0 = {"w1": (0.3 * rng.standard_normal((D, H))).astype(np.float32),
               "w2": (0.3 * rng.standard_normal((H, 1))).astype(np.float32)}

    def batch(step):
        x = np.random.default_rng((5, step)).standard_normal((4, PER, D)).astype(np.float32)
        return {"x": x, "y": np.tanh(x).sum(-1, keepdims=True).astype(np.float32)}

    loop_kw = dict(strategy="daso", n_steps=n_steps, topology=HIER_SPEC, loss_window=50,
                   executor="macro", **kw)
    if package == "jax":
        return jax_run_training(_jax_loss, jax.tree.map(jnp.asarray, params0),
                                lambda t: jax.tree.map(jnp.asarray, batch(t)),
                                JaxTrainLoopConfig(**loop_kw), optimizer=jax_sgd(momentum=0.9),
                                lr_fn=jax_constant_lr(0.05), log=None)
    return run_training(_loss, {k: torch.from_numpy(v) for k, v in params0.items()},
                        lambda t: {k: torch.from_numpy(v) for k, v in batch(t).items()},
                        TrainLoopConfig(device="cpu", **loop_kw),
                        optimizer=sgd(momentum=0.9), lr_fn=constant_lr(0.05), log=None)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_hier_daso_train_state_resumes_in_the_other_package(tmp_path, writer):
    """A hier_daso TrainState written by one package, with its periods set
    to B_host = 3 (as a retune would leave them; the key is TrainState
    v3's), resumed by both: the periods survive, both resumed schedules are
    the writer's schedule continued with B_host = 3, identical between the
    packages, and the losses agree within RTOL."""
    ckpt = str(tmp_path / "ck")
    written = _hier_run(writer, 24, ckpt_every=9, ckpt_dir=ckpt)
    path = (jio if writer == "jax" else io).list_train_state_dirs(ckpt)[-1]
    mf = os.path.join(path, "manifest.json")
    with open(mf) as f:
        manifest = json.load(f)
    controller = manifest["extra"]["train_state"]["controller"]
    assert controller["inner_periods"] == {"host": 2}
    controller["inner_periods"] = {"host": 3}
    with open(mf, "w") as f:
        json.dump(manifest, f)
    k = io.load_train_state(path, device="cpu").step
    assert 0 < k < 24 and io.load_train_state(path, device="cpu").controller == controller
    port = _hier_run("port", 24, resume_from=path)
    jax_ = _hier_run("jax", 24, resume_from=path)
    assert port.controller.inner_periods == jax_.controller.inner_periods == {"host": 3}
    modes = [h[1] for h in port.controller.history]
    assert modes == [h[1] for h in jax_.controller.history]
    assert modes[:k] == [h[1] for h in written.controller.history][:k]
    assert [t for t in range(k, 24) if modes[t].endswith("+host")] == \
        [t for t in range(k, 24) if (t + 1) % 3 == 0 and modes[t] != "blocking"]
    assert port.controller.level_sync_counts() == jax_.controller.level_sync_counts()
    np.testing.assert_allclose(port.losses, jax_.losses, rtol=RTOL)
    np.testing.assert_allclose(port.losses[:k], written.losses[:k], rtol=RTOL)


def test_resume_refuses_a_strategy_or_membership_it_cannot_take(tmp_path):
    ckpt = str(tmp_path / "ck")
    _run_port(12, "macro", "off", ckpt_every=12, ckpt_dir=ckpt)
    path = ckpt_step_dir(ckpt, 12)
    with pytest.raises(ValueError, match="strategy 'daso'"):
        params0, batch = _mlp()
        run_training(_loss, {k: torch.from_numpy(v) for k, v in params0.items()},
                     lambda t: None, TrainLoopConfig(strategy="local_sgd", n_steps=24,
                                                     n_replicas=R, resume_from=path,
                                                     device="cpu"), log=None)
    mf = os.path.join(path, "manifest.json")
    with open(mf) as f:
        manifest = json.load(f)
    manifest["extra"]["train_state"]["membership"] = [1.0, 0.0, 1.0]
    with open(mf, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="3 entries for 2 replicas"):
        _run_port(24, "macro", "off", resume_from=path)


@pytest.mark.parametrize("executor", ["macro", "per_step"])
def test_resume_takes_the_checkpoints_membership(tmp_path, executor):
    """A TrainState whose membership is [1.0, 0.0] resumes with replica 1
    dropped: its params and momentum rows stay as the checkpoint holds them,
    the final params are replica 0's, the port's next TrainState keeps the
    mask, and the losses (over the active replica) and params match the
    reference's run resumed from the same directory within RTOL."""
    ckpt = str(tmp_path / "ck")
    _run_port(24, executor, "off", ckpt_every=12, ckpt_dir=ckpt)
    path = io.list_train_state_dirs(ckpt)[-1]  # the first, at or past step 12
    mf = os.path.join(path, "manifest.json")
    with open(mf) as f:
        manifest = json.load(f)
    manifest["extra"]["train_state"]["membership"] = [1.0, 0.0]
    with open(mf, "w") as f:
        json.dump(manifest, f)
    ts = io.load_train_state(path, device="cpu")
    again = str(tmp_path / "again")
    port = _run_port(24, executor, "off", resume_from=path, ckpt_every=6, ckpt_dir=again)
    jax_ = _run_jax(24, executor, "off", resume_from=path)
    for slot in (0, 1):
        for got, saved in zip(leaves(port.carry[slot]), leaves(ts.carry[slot]), strict=True):
            assert torch.equal(got[1], saved[1])
    for a, b in zip(leaves(port.params), leaves(port.carry[0])):
        assert torch.equal(a, b[0])
    assert ts.step < 24
    assert io.load_train_state(io.list_train_state_dirs(again)[0],
                               device="cpu").membership == [1.0, 0.0]
    np.testing.assert_allclose(port.losses, jax_.losses, rtol=RTOL)
    for a, b in zip(leaves(port.params), jax.tree.leaves(jax_.params), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-6)
    assert [h[1] for h in port.controller.history] == [h[1] for h in jax_.controller.history]


# -- the launchers ------------------------------------------------------------------

LAUNCH = ["--tiny", "--device", "cpu", "--nodes", "2", "--per-node-batch", "2",
          "--seq-len", "16"]


def test_launcher_ckpt_writes_the_final_params(tmp_path, capsys):
    """--ckpt DIR: the final params (replica 0) in DIR at step --steps, in
    the layout the JAX package's load_checkpoint reads."""
    res = launch_train.main(LAUNCH + ["--steps", "4", "--ckpt", str(tmp_path)])
    assert f"[train] checkpoint -> {tmp_path}" in capsys.readouterr().out
    params, manifest = io.load_checkpoint(str(tmp_path), device="cpu")
    assert manifest["step"] == 4
    jparams, _ = jio.load_checkpoint(str(tmp_path))
    for a, b, c in zip(leaves(params), leaves(res.params), jax.tree.leaves(jparams),
                       strict=True):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))


def test_launcher_resume_continues_the_run(tmp_path):
    """--ckpt-every N writes TrainStates; --resume DIR/step_XXXXXXXX
    continues the run (int8 wire, one_cycle overlap): the loss trace (the
    checkpoint's prefix included) and the final params are the
    uninterrupted run's, bit for bit, and so is the carry's tree, down to
    the LM's empty "rem" list, which the npz cannot hold."""
    ckpt, m1, m2 = tmp_path / "ck", tmp_path / "a.json", tmp_path / "b.json"
    argv = ["--steps", "12", "--overlap", "one_cycle", "--wire-format", "int8"]
    full = launch_train.main(LAUNCH + argv + ["--ckpt", str(ckpt), "--ckpt-every", "5",
                                              "--metrics-out", str(m1)])
    steps = sorted(p.name for p in ckpt.iterdir() if p.name.startswith("step_"))
    assert len(steps) == 2
    resumed = launch_train.main(LAUNCH + argv + ["--resume", str(ckpt / steps[0]),
                                                 "--metrics-out", str(m2)])
    assert json.loads(m2.read_text())["losses"] == json.loads(m1.read_text())["losses"]
    for a, b in zip(leaves(resumed.params), leaves(full.params), strict=True):
        assert torch.equal(a, b)
    assert full.params["rem"] == [] and resumed.params["rem"] == []
    assert _structure(resumed.carry) == _structure(full.carry)


def test_launcher_ckpt_every_requires_ckpt(capsys):
    with pytest.raises(SystemExit):
        launch_train.main(LAUNCH + ["--steps", "4", "--ckpt-every", "2"])
    assert "--ckpt-every requires --ckpt" in capsys.readouterr().err


def test_serve_ckpt_gives_the_jax_engine_tokens(tmp_path, capsys):
    """The training launcher's --ckpt, served by `launch.serve --ckpt`: the
    restored step is printed, and the greedy tokens are the JAX engine's on
    the same checkpoint (loaded by the JAX package) and prompts."""
    launch_train.main(["--device", "cpu", "--steps", "2", "--nodes", "2",
                       "--per-node-batch", "1", "--seq-len", "8", "--ckpt", str(tmp_path)])
    out = launch_serve.main(["--device", "cpu", "--ckpt", str(tmp_path), "--batch", "2",
                             "--prompt-len", "8", "--max-new", "6"])
    assert "[serve] restored checkpoint step=2" in capsys.readouterr().out
    prompts = torch.randint(0, get_reduced("llama3.2-1b").vocab_size, (2, 8),
                            generator=torch.Generator().manual_seed(0))
    jp, _ = jio.load_checkpoint(str(tmp_path))
    want = JaxEngine(jax_get_reduced("llama3.2-1b"), jp, max_len=14).generate(
        jnp.asarray(prompts.numpy(), jnp.int32), max_new_tokens=6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_serve_ckpt_must_fit_the_config(tmp_path):
    """Parameters of another config are refused, naming the first leaf
    whose shape differs."""
    tiny = get_reduced("llama3.2-1b").replace(d_model=128, n_heads=4, n_kv_heads=2,
                                              head_dim=32, d_ff=256, vocab_size=256)
    io.save_checkpoint(str(tmp_path), init_params(tiny, torch.Generator().manual_seed(0),
                                                  "cpu"))
    with pytest.raises(ValueError, match=r"embed/tok: checkpoint shape \(256, 128\), the "
                                         r"config expects \(512, 256\)"):
        launch_serve.main(["--device", "cpu", "--ckpt", str(tmp_path), "--batch", "1",
                           "--prompt-len", "4", "--max-new", "2"])
