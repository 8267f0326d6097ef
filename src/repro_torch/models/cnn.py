"""ResNet family, the paper's own ImageNet benchmark model
(`repro/models/cnn.py`).

The tree is the reference's leaf for leaf: NHWC images, HWIO convolution
weights (kh, kw, cin, cout), `stage{i}` lists of block dicts and `head.w` of
shape (cin, n_classes), so the flat arena, `convert` and checkpoints list
the leaves as the reference does. A convolution permutes at use: the NHWC
activation as a channels-last NCHW view (no copy), the weight as OIHW.

Batch norm takes the statistics of the batch it is given (population
variance, as `x.var` in the reference); under DASO's per-replica local step
each replica's statistics stay its own, as under the reference's vmap over
the replica axis ("stats stay per-pod"). Running statistics live in a
separate `state` tree and keep 0.9 of the old value per step.

"SAME" padding is JAX's: at stride 2 the odd excess goes to the high end
(the 7x7/2 stem on 224 pads (2, 3), a 3x3/2 on 56 pads (0, 1)), so the
padding is explicit and the convolution and max pool take none.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.resnet50 import ResNetConfig
from repro_torch.models.common import _trunc_normal


def same_pads(size: int, k: int, stride: int):
    """(low, high) padding of one spatial axis under JAX's "SAME"."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_nchw(x, k: int, stride: int, value: float = 0.0):
    (top, bottom), (left, right) = (same_pads(x.shape[2], k, stride),
                                    same_pads(x.shape[3], k, stride))
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x


def _conv(x, w, stride=1):
    """x (B,H,W,Cin) NHWC, w (kh,kw,Cin,Cout) HWIO -> (B,H',W',Cout), "SAME"."""
    h = _pad_nchw(x.permute(0, 3, 1, 2), w.shape[0], stride)
    return F.conv2d(h, w.permute(3, 2, 0, 1), stride=stride).permute(0, 2, 3, 1)


def max_pool_same(x, k: int = 3, stride: int = 2):
    """`lax.reduce_window(x, -inf, max, (1,k,k,1), (1,s,s,1), "SAME")` on NHWC."""
    h = _pad_nchw(x.permute(0, 3, 1, 2), k, stride, value=float("-inf"))
    return F.max_pool2d(h, k, stride).permute(0, 2, 3, 1)


def _conv_init(generator, kh, kw, cin, cout, device):
    fan_in = kh * kw * cin
    return _trunc_normal((kh, kw, cin, cout), (2.0 / fan_in) ** 0.5, torch.float32,
                         device, generator)


def _bn_init(c, device):
    return {"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device)}


def _bn_state(c, device):
    return {"mean": torch.zeros(c, device=device), "var": torch.ones(c, device=device)}


def batch_norm(x, p, s, *, train: bool, momentum=0.9, eps=1e-5):
    """x (B,H,W,C). Training: the batch's mean and population variance over
    (B, H, W), and running statistics kept at `momentum` of the old value."""
    if train:
        mean = x.mean(dim=(0, 1, 2))
        var = x.var(dim=(0, 1, 2), correction=0)
        new_s = {"mean": momentum * s["mean"] + (1 - momentum) * mean,
                 "var": momentum * s["var"] + (1 - momentum) * var}
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    y = (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y, new_s


def init_resnet(cfg: ResNetConfig, generator: torch.Generator, device):
    """(params, state), drawn from `generator` (which must live on
    `device`) in the reference's order: each convolution a normal truncated
    at +-2 times sqrt(2 / fan_in), batch-norm scales at one, the head at
    zeros."""
    width = cfg.width
    params = {"stem": {"conv": _conv_init(generator, 7, 7, 3, width, device),
                       "bn": _bn_init(width, device)}}
    state = {"stem": {"bn": _bn_state(width, device)}}
    exp = 4 if cfg.bottleneck else 1
    cin = width
    for i, n_blocks in enumerate(cfg.stage_sizes):
        cmid = width * (2 ** i)
        cout = cmid * exp
        stage_p, stage_s = [], []
        for b in range(n_blocks):
            stride = 2 if (b == 0 and i > 0) else 1
            blk_p, blk_s = {}, {}
            if cfg.bottleneck:
                blk_p["conv1"] = _conv_init(generator, 1, 1, cin, cmid, device)
                blk_p["conv2"] = _conv_init(generator, 3, 3, cmid, cmid, device)
                blk_p["conv3"] = _conv_init(generator, 1, 1, cmid, cout, device)
                bns = (("bn1", cmid), ("bn2", cmid), ("bn3", cout))
            else:
                blk_p["conv1"] = _conv_init(generator, 3, 3, cin, cmid, device)
                blk_p["conv2"] = _conv_init(generator, 3, 3, cmid, cout, device)
                bns = (("bn1", cmid), ("bn2", cout))
            for j, c in bns:
                blk_p[j] = _bn_init(c, device)
                blk_s[j] = _bn_state(c, device)
            if stride != 1 or cin != cout:
                blk_p["proj"] = _conv_init(generator, 1, 1, cin, cout, device)
                blk_p["proj_bn"] = _bn_init(cout, device)
                blk_s["proj_bn"] = _bn_state(cout, device)
            stage_p.append(blk_p)
            stage_s.append(blk_s)
            cin = cout
        params[f"stage{i}"] = stage_p
        state[f"stage{i}"] = stage_s
    params["head"] = {"w": torch.zeros(cin, cfg.n_classes, device=device),
                      "b": torch.zeros(cfg.n_classes, device=device)}
    return params, state


def _block_apply(p, s, x, *, stride: int, bottleneck: bool, train: bool):
    new_s = {}
    r = x
    if bottleneck:
        h = _conv(x, p["conv1"])
        h, new_s["bn1"] = batch_norm(h, p["bn1"], s["bn1"], train=train)
        h = torch.relu(h)
        h = _conv(h, p["conv2"], stride)
        h, new_s["bn2"] = batch_norm(h, p["bn2"], s["bn2"], train=train)
        h = torch.relu(h)
        h = _conv(h, p["conv3"])
        h, new_s["bn3"] = batch_norm(h, p["bn3"], s["bn3"], train=train)
    else:
        h = _conv(x, p["conv1"], stride)
        h, new_s["bn1"] = batch_norm(h, p["bn1"], s["bn1"], train=train)
        h = torch.relu(h)
        h = _conv(h, p["conv2"])
        h, new_s["bn2"] = batch_norm(h, p["bn2"], s["bn2"], train=train)
    if "proj" in p:
        r = _conv(x, p["proj"], stride)
        r, new_s["proj_bn"] = batch_norm(r, p["proj_bn"], s["proj_bn"], train=train)
    return torch.relu(h + r), new_s


def resnet_apply(params, state, images, cfg: ResNetConfig, *, train: bool):
    """images (B,H,W,3) -> (logits (B,n_classes), new_state)."""
    new_state = {"stem": {}}
    h = _conv(images, params["stem"]["conv"], stride=2)
    h, new_state["stem"]["bn"] = batch_norm(
        h, params["stem"]["bn"], state["stem"]["bn"], train=train)
    h = max_pool_same(torch.relu(h))
    for i in range(len(cfg.stage_sizes)):
        stage_s = []
        for b, (p, s) in enumerate(zip(params[f"stage{i}"], state[f"stage{i}"])):
            stride = 2 if (b == 0 and i > 0) else 1
            h, ns = _block_apply(p, s, h, stride=stride, bottleneck=cfg.bottleneck,
                                 train=train)
            stage_s.append(ns)
        new_state[f"stage{i}"] = stage_s
    h = h.mean(dim=(1, 2))
    logits = h @ params["head"]["w"] + params["head"]["b"]
    return logits, new_state
