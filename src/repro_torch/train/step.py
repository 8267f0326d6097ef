"""Loss functions connecting the decoder LM to the DASO / sync steps
(`repro/train/step.py`)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import cross_entropy_loss
from repro_torch.models.lm import forward


def make_lm_loss(cfg: ArchConfig):
    """loss_fn(params, batch) -> (total_loss, aux). batch: tokens (B,S),
    labels (B,S) (-1 = ignore), optional positions.

    Attention runs the plain `multihead_attention` (`attn_impl="plain"`),
    differentiated by autograd, as the JAX package trains through its jnp
    attention: K1 has no backward. The dense models of the port have no
    MoE losses; `aux` keeps them at zero so the total matches the
    reference's."""
    def loss_fn(params, batch):
        out = forward(params, batch["tokens"], cfg,
                      positions=batch.get("positions"), attn_impl="plain")
        ce = cross_entropy_loss(out["logits"], batch["labels"])
        zero = torch.zeros((), dtype=torch.float32, device=ce.device)
        aux = {"moe_lb_loss": zero, "moe_z_loss": zero, "moe_drop_frac": zero,
               "ce": ce}
        return ce + aux["moe_lb_loss"] + aux["moe_z_loss"], aux

    return loss_fn
