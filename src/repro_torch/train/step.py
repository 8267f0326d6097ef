"""Loss functions connecting the decoder LM and the ResNet to the DASO /
sync steps (`repro/train/step.py`)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.cnn import resnet_apply
from repro_torch.models.common import cross_entropy_loss
from repro_torch.models.lm import forward


def make_lm_loss(cfg: ArchConfig):
    """loss_fn(params, batch) -> (total_loss, aux). batch: tokens (B,S),
    labels (B,P+S) (-1 = ignore), optional prefix_embeds (B,P,D) (the
    labels then cover the spliced length) and positions.

    total = cross-entropy + the MoE's load-balance and router z losses,
    summed over the layers by `forward` (zeros for a model without MoE);
    aux holds those two, the drop fraction and "ce". Attention runs the
    plain `multihead_attention` (`attn_impl="plain"`), differentiated by
    autograd, as the JAX package trains through its jnp attention: K1 has
    no backward."""
    def loss_fn(params, batch):
        out = forward(params, batch["tokens"], cfg,
                      prefix_embeds=batch.get("prefix_embeds"),
                      positions=batch.get("positions"), attn_impl="plain")
        ce = cross_entropy_loss(out["logits"], batch["labels"])
        aux = dict(out["aux"])
        total = ce + aux["moe_lb_loss"] + aux["moe_z_loss"]
        aux["ce"] = ce
        return total, aux

    return loss_fn


def make_resnet_loss(cfg, *, mutable_state: bool = False):
    """ResNet loss (`repro/train/step.py::make_resnet_loss`). batch: images
    (B,H,W,3), labels (B,), bn_state (the running statistics, read through).
    The f32 log-softmax's mean NLL of the label; aux holds the accuracy and,
    with `mutable_state`, the updated running statistics ("bn_state") for
    the caller to thread back."""
    def loss_fn(params, batch):
        logits, new_state = resnet_apply(params["net"], batch["bn_state"],
                                         batch["images"], cfg, train=True)
        labels = batch["labels"]
        logp = torch.log_softmax(logits.float(), dim=-1)
        loss = -torch.take_along_dim(logp, labels[:, None].long(), dim=-1).mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        aux = {"acc": acc}
        if mutable_state:
            aux["bn_state"] = new_state
        return loss, aux

    return loss_fn
