"""The port's CNN family (ResNet, the paper's own workload) held against the
JAX package on the CPU: the config registry, `resnet_apply` (train and
eval, basic and bottleneck blocks, even and odd image sizes), the "SAME"
convolution and max pool at strides 1 and 2, `make_resnet_loss` (loss,
accuracy, gradients, the updated batch-norm state), `SyntheticImages` and
`make_noniid_class_partition` bit for bit, the init tree, `convert`, and
24-step DASO and sync runs shaped as `benchmarks/figures.py::_resnet_problem`
against the reference's per-step executor. Also the nested aux through
`value_and_grad`, nested `bn_state` batches through the macro executor's
staging and the process placement, the `n_micro > 1` hazard, the ablation
twin and the LM launchers' refusal.

Inputs are made from a numpy seed and the reference's weights are carried
across with `convert.cnn_params_from_jax`: torch cannot draw JAX's bits."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.configs.resnet50 import ResNetConfig as JaxResNetConfig
from repro.core.daso import microbatched_value_and_grad as jax_microbatched
from repro.data.synthetic import SyntheticImages as JaxSyntheticImages
from repro.data.synthetic import make_noniid_class_partition as jax_partition
from repro.models import cnn as jcnn
from repro.train.loop import TrainLoopConfig as JaxTrainLoopConfig
from repro.train.loop import run_training as jax_run_training
from repro.train.step import make_resnet_loss as jax_make_resnet_loss
from repro_torch.configs import ARCH_IDS, ResNetConfig, get_config, get_reduced
from repro_torch.convert import cnn_params_from_jax, params_from_jax, state_from_jax
from repro_torch.core import executor as texecutor
from repro_torch.core.daso import microbatched_value_and_grad, value_and_grad
from repro_torch.data import SyntheticImages, make_noniid_class_partition
from repro_torch.launch import ablation, profile_serve, serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.distributed import ProcessPlacement
from repro_torch.launch.mesh import process_replica_slice
from repro_torch.models import cnn
from repro_torch.topo.spec import TopologySpec
from repro_torch.train import TrainLoopConfig, make_resnet_loss, run_training
from repro_torch.tree import flatten, leaves, tree_map

# a small bottleneck config and an odd image size
BOTTLENECK = dict(name="resnet-bneck", stage_sizes=(1, 1), width=4, bottleneck=True,
                  n_classes=5, image_size=16)
ODD = dict(name="resnet-odd", stage_sizes=(1, 1), width=8, bottleneck=False,
           n_classes=10, image_size=15)
CONFIGS = {"reduced": None, "bottleneck": BOTTLENECK, "odd15": ODD}
# 24-step runs: the frameworks sum in different orders inside the model and
# SGD carries the difference forward (tests/test_torch_train.py's RTOL)
RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The small CNNs' ops are too small to split across threads; beside
    the suite's other workers, torch's thread pool only contends for the
    cores. One thread for this module, then the worker's setting back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name):
    """(JAX config, port config) of one case, field for field."""
    kw = CONFIGS[name]
    jcfg = jax_get_reduced("resnet50") if kw is None else JaxResNetConfig(**kw)
    return jcfg, ResNetConfig(**dataclasses.asdict(jcfg))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _randomized(params, state, seed):
    """The reference's init with a random head (the zero head gives zero
    logits) and random batch-norm affine and running statistics, so eval
    mode and the affine paths see non-trivial values."""
    rng = np.random.default_rng(seed)
    p, s = _np_tree(params), _np_tree(state)

    def bn_p(d):
        for k, v in d.items():
            if isinstance(v, dict) and "scale" in v:
                v["scale"] = (1 + 0.1 * rng.standard_normal(v["scale"].shape)).astype(np.float32)
                v["bias"] = (0.1 * rng.standard_normal(v["bias"].shape)).astype(np.float32)

    def bn_s(d):
        for v in d.values():
            if isinstance(v, dict) and "mean" in v:
                v["mean"] = (0.1 * rng.standard_normal(v["mean"].shape)).astype(np.float32)
                v["var"] = rng.uniform(0.5, 1.5, v["var"].shape).astype(np.float32)

    for tree, fix in ((p, bn_p), (s, bn_s)):
        fix(tree["stem"])
        for k in tree:
            if k.startswith("stage"):
                for blk in tree[k]:
                    fix(blk)
    w = p["head"]["w"]
    p["head"]["w"] = (0.1 * rng.standard_normal(w.shape)).astype(np.float32)
    p["head"]["b"] = (0.1 * rng.standard_normal(w.shape[1])).astype(np.float32)
    return p, s


def _images(n, size, seed):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3), dtype=np.float32)


@pytest.fixture(scope="module")
def models():
    """Each case's reference weights (randomized) and state, as numpy."""
    out = {}
    for i, name in enumerate(CONFIGS):
        jcfg, tcfg = _cfgs(name)
        p, s = jcnn.init_resnet(jcfg, jax.random.PRNGKey(i))
        p, s = _randomized(p, s, seed=10 + i)
        out[name] = (jcfg, tcfg, p, s)
    return out


def _assert_trees_close(got, want, atol, rtol=0.0):
    g, w = leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=atol, rtol=rtol)


# -- config registry -----------------------------------------------------------------

def test_registry_returns_the_resnet_config():
    for get, jget in ((get_config, jax_get_config), (get_reduced, jax_get_reduced)):
        cfg, jcfg = get("resnet50"), jget("resnet50")
        assert isinstance(cfg, ResNetConfig)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert "resnet50" in ARCH_IDS


# -- the SAME convolution and max pool ------------------------------------------------

@pytest.mark.parametrize("size", [16, 15, 224 // 8, 7])
@pytest.mark.parametrize("k,stride", [(1, 1), (3, 1), (3, 2), (7, 2), (1, 2)])
def test_conv_same_matches_lax(size, k, stride):
    """Stride 2 on an even size pads its excess at the high end ((2, 3) for
    the 7x7 stem, (0, 1) for a 3x3): a symmetric pad shifts every window."""
    rng = np.random.default_rng(size * 10 + k)
    x = rng.standard_normal((2, size, size, 3), dtype=np.float32)
    w = rng.standard_normal((k, k, 3, 5), dtype=np.float32)
    want = jcnn._conv(jnp.asarray(x), jnp.asarray(w), stride)
    got = cnn._conv(torch.from_numpy(x), torch.from_numpy(w), stride)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("size", [16, 15, 112 // 8, 9])
@pytest.mark.parametrize("stride", [1, 2])
def test_max_pool_same_matches_reduce_window(size, stride):
    x = np.random.default_rng(size).standard_normal((2, size, size, 4), dtype=np.float32)
    want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                 (1, stride, stride, 1), "SAME")
    got = cnn.max_pool_same(torch.from_numpy(x), 3, stride)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_same_pads_are_jax_s():
    assert cnn.same_pads(224, 7, 2) == (2, 3)
    assert cnn.same_pads(56, 3, 2) == (0, 1)
    assert cnn.same_pads(112, 3, 2) == (0, 1)
    assert cnn.same_pads(15, 3, 2) == (1, 1)
    assert cnn.same_pads(16, 1, 2) == (0, 0)


# -- resnet_apply -------------------------------------------------------------------

@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_resnet_apply_matches_jax(models, name, train):
    jcfg, tcfg, p, s = models[name]
    x = _images(4, jcfg.image_size, seed=3)
    want_logits, want_state = jax.jit(
        lambda p, s, x: jcnn.resnet_apply(p, s, x, jcfg, train=train))(p, s, jnp.asarray(x))
    logits, state = cnn.resnet_apply(cnn_params_from_jax(p), state_from_jax(s),
                                     torch.from_numpy(x), tcfg, train=train)
    assert tuple(logits.shape) == (4, jcfg.n_classes)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits),
                               atol=1e-5, rtol=0)
    _assert_trees_close(state, want_state, atol=1e-5)


# -- the loss ------------------------------------------------------------------------

def _loss_batch(jcfg, p, s, n=6, seed=4):
    src = SyntheticImages(jcfg.n_classes, jcfg.image_size, seed=seed)
    b = src.batch(n, 0)
    tb = {**b, "bn_state": state_from_jax(s)}
    jb = {"images": jnp.asarray(b["images"].numpy()), "labels": jnp.asarray(b["labels"].numpy()),
          "bn_state": jax.tree.map(jnp.asarray, s)}
    return tb, jb


@pytest.mark.parametrize("name", ["reduced", "bottleneck"])
def test_resnet_loss_and_grads_match_jax(models, name):
    jcfg, tcfg, p, s = models[name]
    tb, jb = _loss_batch(jcfg, p, s)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        jax_make_resnet_loss(jcfg, mutable_state=True), has_aux=True))(
        {"net": jax.tree.map(jnp.asarray, p)}, jb)
    (loss, aux), grads = value_and_grad(make_resnet_loss(tcfg, mutable_state=True))(
        {"net": cnn_params_from_jax(p)}, tb)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5, rtol=0)
    assert aux["acc"].item() == float(jaux["acc"])
    _assert_trees_close(aux["bn_state"], jaux["bn_state"], atol=1e-5)
    g, jg = leaves(grads), jax.tree.leaves(jgrads)
    assert len(g) == len(jg)
    for a, b in zip(g, jg):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * max(np.abs(b).max(), 1e-30),
                                   rtol=0)


# ResNet-50's depth and bottleneck blocks at a narrow width and image size,
# drawn as chip_smoke.py's resnet_check draws the published size
DEEP_NARROW = dict(name="resnet50-narrow", stage_sizes=(3, 4, 6, 3), width=8,
                   bottleneck=True, n_classes=100, image_size=64)


def _leaf_errs(got, truth):
    """Per leaf, max |got - truth| over max |truth|."""
    return np.array([np.abs(a - t).max() / np.abs(t).max() for a, t in zip(got, truth)])


def test_f32_gradient_error_on_four_images_is_a_relu_kink(monkeypatch):
    """On 4 images at ResNet-50's depth the f32 gradients can be far from
    the f64 ones while both packages compute the same function: the f32
    forward moves a pre-activation within rounding of zero across a ReLU's
    kink, and the leaves, small sums of large terms, move with it. Held:
    the JAX package's f64 gradients are the port's; any port f32 leaf off
    f64 by more than 1e-3 comes with a flipped ReLU, each flipped input
    within 1e-3 of its layer's largest magnitude; and with every ReLU pinned
    to the f64 forward's mask, both packages' f32 gradients are within 1e-3
    of f64 on every leaf. resnet_check in chip_smoke.py holds the card the
    same way at the published width."""
    jcfg = JaxResNetConfig(**DEEP_NARROW)
    tcfg = ResNetConfig(**DEEP_NARROW)
    tp, ts = cnn.init_resnet(tcfg, torch.Generator().manual_seed(1), "cpu")
    g = torch.Generator().manual_seed(2)
    tp["head"] = {k: 0.01 * torch.randn(v.shape, generator=g) for k, v in tp["head"].items()}
    p, s = tree_map(lambda x: x.numpy(), (tp, ts))
    b = SyntheticImages(jcfg.n_classes, jcfg.image_size, seed=0).batch(4, 10 ** 6)
    relu = torch.relu

    def port_grads(dtype, relu_fn=relu):
        cast = lambda t: tree_map(lambda x: x.to(dtype), t)  # noqa: E731
        tb = {"images": cast(b["images"]), "labels": b["labels"],
              "bn_state": cast(state_from_jax(s))}
        with monkeypatch.context() as m:
            m.setattr(torch, "relu", relu_fn)
            _, gr = value_and_grad(make_resnet_loss(tcfg))({"net": cast(cnn_params_from_jax(p))},
                                                           tb)
        return [x.double().numpy() for x in leaves(gr)]

    def jax_grads(x64, masks=None):
        dtype = jnp.float64 if x64 else jnp.float32
        it = iter(masks or ())
        with jax.enable_x64(x64), monkeypatch.context() as m:
            if masks is not None:
                m.setattr(jax.nn, "relu", lambda x: x * jnp.asarray(next(it), x.dtype))
            cast = lambda t: jax.tree.map(lambda x: jnp.asarray(x, dtype), t)  # noqa: E731
            jb = {"images": cast(b["images"].numpy()), "labels": jnp.asarray(b["labels"].numpy()),
                  "bn_state": cast(s)}
            _, gr = jax.jit(jax.value_and_grad(jax_make_resnet_loss(jcfg), has_aux=True))(
                {"net": cast(p)}, jb)
            return [np.asarray(x, np.float64) for x in jax.tree.leaves(gr)]

    def recording(seen):
        return lambda x: seen.append(x.detach()) or relu(x)

    pre64, pre32 = [], []
    truth = port_grads(torch.float64, recording(pre64))
    unpinned = _leaf_errs(port_grads(torch.float32, recording(pre32)), truth)
    assert _leaf_errs(jax_grads(True), truth).max() < 1e-6
    flipped = [(x64[(x32 > 0) != (x64 > 0)].abs().max() / x64.abs().max()).item()
               for x32, x64 in zip(pre32, pre64, strict=True) if ((x32 > 0) != (x64 > 0)).any()]
    assert unpinned.max() <= 1e-3 or flipped, unpinned.max()
    assert all(f <= 1e-3 for f in flipped), flipped
    masks = [x > 0 for x in pre64]
    it = iter(masks)
    pinned = _leaf_errs(port_grads(torch.float32, lambda x: x * next(it).to(x.dtype)), truth)
    jax_pinned = _leaf_errs(jax_grads(False, [m.numpy() for m in masks]), truth)
    assert pinned.max() <= 1e-3 and jax_pinned.max() <= 1e-3, (pinned.max(), jax_pinned.max())
    print(f"f32 grads off f64 (leaf max): unpinned {unpinned.max():.3g}, "
          f"{len(flipped)} flipped layer(s) {flipped}; pinned port {pinned.max():.3g}, "
          f"pinned JAX {jax_pinned.max():.3g}")

def test_zero_head_accuracy_takes_index_zero(models):
    """At step 0 the zero head makes every logit equal: both argmax take
    index 0, so the accuracy is the share of label 0."""
    jcfg, tcfg, p, s = models["reduced"]
    p = {**p, "head": {"w": np.zeros_like(p["head"]["w"]), "b": np.zeros_like(p["head"]["b"])}}
    tb, jb = _loss_batch(jcfg, p, s, n=32)
    _, jaux = jax_make_resnet_loss(jcfg)({"net": jax.tree.map(jnp.asarray, p)}, jb)
    _, aux = make_resnet_loss(tcfg)({"net": cnn_params_from_jax(p)}, tb)
    share = float((tb["labels"] == 0).float().mean())
    assert aux["acc"].dtype == torch.float32 and 0 < share < 1
    assert aux["acc"].item() == float(jaux["acc"]) == share
    assert "bn_state" not in aux


def test_nested_aux_through_value_and_grad(models):
    """The updated bn_state (a tree) comes out of value_and_grad and
    microbatched_value_and_grad at n_micro = 1 detached, as the
    reference's."""
    jcfg, tcfg, p, s = models["reduced"]
    tb, jb = _loss_batch(jcfg, p, s)
    loss_fn = make_resnet_loss(tcfg, mutable_state=True)
    params = {"net": cnn_params_from_jax(p)}
    (_, jaux), _ = jax_microbatched(jax_make_resnet_loss(jcfg, mutable_state=True), 1)(
        {"net": jax.tree.map(jnp.asarray, p)}, jb)
    outs = [vg(params, tb) for vg in (value_and_grad(loss_fn),
                                      microbatched_value_and_grad(loss_fn, 1))]
    for (loss, aux), _ in outs:
        assert not loss.requires_grad
        assert all(not x.requires_grad for x in leaves(aux))
        _assert_trees_close(aux["bn_state"], jaux["bn_state"], atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(leaves(outs[0][0]), leaves(outs[1][0])))


def test_microbatching_a_cnn_batch_fails_in_both(models):
    """The reference chunks every batch leaf, bn_state included, and fails
    inside batch norm; the port refuses such a batch by name."""
    jcfg, tcfg, p, s = models["reduced"]
    tb, jb = _loss_batch(jcfg, p, s, n=8)
    with pytest.raises((TypeError, ValueError)):
        jax_microbatched(jax_make_resnet_loss(jcfg), 2)({"net": jax.tree.map(jnp.asarray, p)}, jb)
    with pytest.raises(ValueError, match="bn_state"):
        microbatched_value_and_grad(make_resnet_loss(tcfg), 2)(
            {"net": cnn_params_from_jax(p)}, tb)


# -- data ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_synthetic_images_bit_for_bit(weighted):
    jsrc, tsrc = JaxSyntheticImages(6, 20, seed=3), SyntheticImages(6, 20, seed=3)
    w = jax_partition(6, 2, seed=1)[1] if weighted else None
    for step in (0, 7):
        jb = jsrc.batch(9, step, class_weights=w)
        tb = tsrc.batch(9, step, class_weights=w)
        assert tb["images"].dtype == torch.float32 and tb["labels"].dtype == torch.int32
        np.testing.assert_array_equal(tb["images"].numpy(), np.asarray(jb["images"]))
        np.testing.assert_array_equal(tb["labels"].numpy(), np.asarray(jb["labels"]))


def test_noniid_partition_bit_for_bit():
    for args in ((4, 4, 0.2, 0), (10, 3, 0.3, 5)):
        np.testing.assert_array_equal(make_noniid_class_partition(*args), jax_partition(*args))


# -- init and conversion --------------------------------------------------------------

def _paths(tree):
    return [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("name", ["resnet50", "reduced", "bottleneck"])
def test_init_tree_is_the_reference_s(name):
    """Leaf paths, shapes and flatten order of params and state as the
    reference's (its shapes through eval_shape), the head at zeros, batch
    norm at scale 1 / mean 0 / var 1, and each convolution a truncated
    normal of std 0.8796 sqrt(2 / fan_in) (a standard normal cut at +-2 has
    std 0.8796)."""
    if name == "resnet50":
        jcfg, tcfg = jax_get_config("resnet50"), get_config("resnet50")
    else:
        jcfg, tcfg = _cfgs(name)
    want_p, want_s = jax.eval_shape(lambda k: jcnn.init_resnet(jcfg, k), jax.random.PRNGKey(0))
    p, s = cnn.init_resnet(tcfg, torch.Generator().manual_seed(0), "cpu")
    tp = jax.tree.map(lambda x: np.zeros(0), p, is_leaf=lambda x: isinstance(x, torch.Tensor))
    ts = jax.tree.map(lambda x: np.zeros(0), s, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert _paths(tp) == _paths(want_p) and _paths(ts) == _paths(want_s)
    assert [tuple(x.shape) for x in leaves(p)] == [x.shape for x in jax.tree.leaves(want_p)]
    assert [tuple(x.shape) for x in leaves(s)] == [x.shape for x in jax.tree.leaves(want_s)]
    assert all(x.dtype == torch.float32 for x in leaves(p) + leaves(s))
    assert not p["head"]["w"].any() and not p["head"]["b"].any()
    assert torch.equal(p["stem"]["bn"]["scale"], torch.ones(tcfg.width))
    assert torch.equal(s["stem"]["bn"]["var"], torch.ones(tcfg.width))
    if name == "resnet50":
        assert sum(x.numel() for x in leaves(p)) == 25_557_032
        assert len(leaves(p)) == 161
        for w in (p["stem"]["conv"], p["stage3"][0]["conv2"]):
            fan_in = w.shape[0] * w.shape[1] * w.shape[2]
            want = 0.8796 * (2.0 / fan_in) ** 0.5
            assert abs(w.std().item() / want - 1) < 0.02
            assert w.abs().max().item() <= 2 * (2.0 / fan_in) ** 0.5


def test_cnn_params_from_jax(models):
    jcfg, tcfg, p, s = models["bottleneck"]
    net = cnn_params_from_jax(p)
    assert [tuple(x.shape) for x in leaves(net)] == [x.shape for x in jax.tree.leaves(p)]
    wrapped = cnn_params_from_jax({"net": p})
    assert all(torch.equal(a, b) for a, b in zip(leaves(wrapped["net"]), leaves(net)))
    carry = jax.tree.map(lambda x: np.stack([x, x + 1]), {"net": p})  # a replica axis
    rows = cnn_params_from_jax(carry)
    assert all(torch.equal(a[1], b + 1) for a, b in zip(leaves(rows["net"]), leaves(net)))
    with pytest.raises(ValueError, match="not a ResNet params tree"):
        cnn_params_from_jax({"embed": {}, "blocks": [], "rem": [], "final_norm": {}})
    with pytest.raises(ValueError, match="not an LM params tree"):
        params_from_jax(p)


# -- training -------------------------------------------------------------------------

R, PER, IMG, CLASSES, STEPS = 4, 8, 16, 4, 24


def _problem(image_module, state, device_kw):
    """figures.py::_resnet_problem's data: R replicas of PER images, each
    replica with the initial batch-norm state; sync takes the R * PER
    images of one draw."""
    src = image_module(n_classes=CLASSES, image_size=IMG, seed=0)
    torch_side = image_module is SyntheticImages
    if torch_side:
        bn_r = tree_map(lambda x: x.expand((R,) + x.shape), state)
        stack = torch.stack
    else:
        bn_r = jax.tree.map(lambda x: jnp.broadcast_to(x, (R,) + x.shape), state)
        stack = jnp.stack

    def daso_data(step):
        outs = [src.batch(PER, step * R + r, **device_kw) for r in range(R)]
        return {**{k: stack([o[k] for o in outs]) for k in outs[0]}, "bn_state": bn_r}

    def sync_data(step):
        return {**src.batch(PER * R, step, **device_kw), "bn_state": state}

    return daso_data, sync_data


@pytest.fixture(scope="module")
def resnet_runs():
    jcfg = JaxResNetConfig(name="resnet-bench", stage_sizes=(1, 1), width=8,
                           bottleneck=False, n_classes=CLASSES, image_size=IMG)
    tcfg = ResNetConfig(**dataclasses.asdict(jcfg))
    p, s = _np_tree(jcnn.init_resnet(jcfg, jax.random.PRNGKey(0)))
    jdaso, jsync = _problem(JaxSyntheticImages, jax.tree.map(jnp.asarray, s), {})
    tdaso, tsync = _problem(SyntheticImages, state_from_jax(s), {"device": "cpu"})
    daso_kw = dict(strategy="daso", n_steps=STEPS, n_replicas=R, local_world=4, b_max=4,
                   lr=0.05, loss_window=10)
    sync_kw = dict(strategy="sync", n_steps=STEPS, lr=0.05)
    jp = {"net": jax.tree.map(jnp.asarray, p)}
    runs = {}
    for name, jdata, tdata, kw in (("daso", jdaso, tdaso, daso_kw),
                                   ("sync", jsync, tsync, sync_kw)):
        runs[name] = jax_run_training(jax_make_resnet_loss(jcfg), jp, jdata,
                                      JaxTrainLoopConfig(executor="per_step", **kw), log=None)
        for ex in ("per_step", "macro"):
            runs[f"{name}/{ex}"] = run_training(
                make_resnet_loss(tcfg), {"net": cnn_params_from_jax(p)}, tdata,
                TrainLoopConfig(executor=ex, device="cpu", **kw), log=None)
    runs["daso/mutable"] = run_training(
        make_resnet_loss(tcfg, mutable_state=True), {"net": cnn_params_from_jax(p)}, tdaso,
        TrainLoopConfig(executor="macro", device="cpu", **daso_kw), log=None)
    return runs


@pytest.mark.parametrize("name", ["daso", "sync"])
def test_resnet_run_matches_jax(resnet_runs, name):
    want = resnet_runs[name]
    for ex in ("per_step", "macro"):
        got = resnet_runs[f"{name}/{ex}"]
        if name == "daso":
            assert [h[1:] for h in got.controller.history] == \
                [h[1:] for h in want.controller.history]
        assert got.sync_fraction == want.sync_fraction
        np.testing.assert_allclose(got.losses, want.losses, rtol=RTOL)
        np.testing.assert_allclose([m["acc"] for m in got.metrics],
                                   [m["acc"] for m in want.metrics], atol=1e-6)
    got = resnet_runs[f"{name}/per_step"]
    assert got.losses[-1] < got.losses[0]
    if name == "daso":
        assert {h[1] for h in got.controller.history} >= {"blocking", "send", "receive",
                                                         "local"}


@pytest.mark.parametrize("name", ["daso", "sync"])
def test_resnet_macro_bit_for_bit_per_step(resnet_runs, name):
    a, b = resnet_runs[f"{name}/macro"], resnet_runs[f"{name}/per_step"]
    assert a.losses == b.losses
    assert all(torch.equal(x, y) for x, y in zip(leaves(a.carry), leaves(b.carry), strict=True))


def test_mutable_state_run_skips_the_nested_aux(resnet_runs):
    """A loss whose aux holds the bn_state tree trains through the step
    builders (aux metrics take tensors only, as the reference's): the same
    losses bit for bit, since the state is read through."""
    a, b = resnet_runs["daso/mutable"], resnet_runs["daso/macro"]
    assert a.losses == b.losses
    assert "acc" in a.metrics[-1] and "bn_state" not in a.metrics[-1]


# -- staging and placement of nested batches --------------------------------------------

def _nested_batch(step):
    rng = np.random.default_rng(step)
    state = {"stem": {"bn": {"mean": torch.from_numpy(rng.standard_normal(3, dtype=np.float32)),
                             "var": torch.ones(3)}},
             "stage0": [{"bn1": {"mean": torch.zeros(5), "var": torch.ones(5)}}]}
    return {"images": torch.from_numpy(rng.standard_normal((R, 2, 4, 4, 3), dtype=np.float32)),
            "labels": torch.from_numpy(rng.integers(0, 4, (R, 2)).astype(np.int32)),
            "bn_state": tree_map(lambda x: x.expand((R,) + x.shape), state)}


def test_nested_batches_are_staged_and_placed():
    """The macro executor's stack and per-step slice (`_step_batch`) and
    ProcessPlacement's `place_batch` / `stage_cycle` (process 1 of 2's
    rows) keep a nested bn_state as they keep tokens, a broadcast (stride-0)
    state made contiguous."""
    per_step = [_nested_batch(t) for t in range(3)]
    stacked = tree_map(lambda *xs: torch.stack(xs), *per_step)
    for i, b in enumerate(per_step):
        got = texecutor._step_batch(stacked, i)
        assert flatten(got)[1] == flatten(b)[1]
        assert all(torch.equal(x, y) for x, y in zip(leaves(got), leaves(b)))
    pl = ProcessPlacement(TopologySpec.parse("chip:4 x pod:4"), device="cpu")
    pl.rows = process_replica_slice(pl.spec, 2, 1)
    placed = pl.place_batch(per_step[0])
    assert flatten(placed)[1] == flatten(per_step[0])[1]
    for x, y in zip(leaves(placed), leaves(per_step[0])):
        assert x.is_contiguous() and torch.equal(x, y[2:4])
    batches, lrs = pl.stage_cycle(per_step, [0.1, 0.2, 0.3])
    assert lrs.dtype == torch.float32 and lrs.shape == (3,)
    for x, y in zip(leaves(batches), leaves(stacked)):
        assert x.is_contiguous() and torch.equal(x, y[:, 2:4])


# -- entry points -----------------------------------------------------------------------

def test_ablation_twin_runs_on_the_cpu(capsys):
    out = ablation.main(["--device", "cpu", "--steps", "4"])
    text = capsys.readouterr().out
    assert "daso (Eq.1 weighted merge)" in text and "daso NON-iid nodes" in text
    assert "daso B=16" in text
    assert out["drift"] == 0.0 and out["macro"].losses == out["per_step"].losses
    assert out["macro"].executor_stats.dispatches <= 4


def test_ablation_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ablation.main(["--steps", "1"])


def test_require_lm_decides_by_the_config(monkeypatch):
    """A second CNN config, under another id, is refused as resnet50 is:
    the config's type decides, not the id."""
    from repro_torch.configs import base

    cnn_mod = type("M", (), {"CONFIG": ResNetConfig(name="resnet18", stage_sizes=(2, 2, 2, 2),
                                                     bottleneck=False)})
    monkeypatch.setattr(base, "_module", lambda arch_id: cnn_mod)
    with pytest.raises(SystemExit, match=r"resnet18 is the CNN family.*run_training"):
        base.require_lm("resnet18", "train")
    monkeypatch.undo()
    base.require_lm("llama3.2-1b", "train")


@pytest.mark.parametrize("entry", [launch_train, serve, profile_serve])
def test_lm_entry_points_refuse_resnet50(entry):
    with pytest.raises(SystemExit, match=r"run_training.*launch\.ablation"):
        entry.main(["--arch", "resnet50", "--device", "cpu"])
