"""Elastic-membership carry surgery: reseeding a rejoined replica
(`repro/resilience/membership.py`).

The exchange side of membership (the masked arena mean, frozen ghost rows,
Eq. (1) at the surviving world's P) lives in core/daso.py and
core/flatbuf.py, baked into the step variants. What lives here runs between
cycles: a replica that rejoins after a crash has a stale, frozen row, and
takes the survivors' mean state before it is active again, as an elastic
worker bootstraps from the current consensus.
"""
from __future__ import annotations

from typing import Iterable, Tuple

import torch

from repro_torch.core import flatbuf
from repro_torch.tree import tree_map


def donor_mean_rows(tree, donor_mask: Tuple[float, ...]):
    """The membership-weighted mean over the donor rows of every leaf, as a
    (1, ...) tensor per leaf: the state a joiner bootstraps from. A floating
    leaf averages in its own dtype, an integer leaf in f32 and rounds."""
    mask = flatbuf.normalize_membership(donor_mask, len(donor_mask))
    return tree_map(lambda x: _donor_mean(x, mask), tree)


def _donor_mean(x: torch.Tensor, mask) -> torch.Tensor:
    if x.is_floating_point():
        return flatbuf.masked_axis0_mean(x, mask)
    return torch.round(flatbuf.masked_axis0_mean(x.float(), mask)).to(x.dtype)


def reseed_carry(carry, donor_mask: Tuple[float, ...], joining: Iterable[int]):
    """The carry with the rows of the `joining` replicas in every leaf
    replaced by the donors' membership-weighted mean: params, optimizer
    state (a rejoined node has no momentum history; the donors' mean
    surprises least) and the in-flight buffer, so the joiner is as a
    replica that has just taken a blocking sync. Leaves that are one tensor
    in `carry` (the in-flight buffer aliasing the params) stay one tensor."""
    joining = sorted(set(joining))
    if not joining:
        return carry
    n = len(donor_mask)
    for j in joining:
        if not 0 <= j < n:
            raise ValueError(f"joining replica {j} outside 0..{n - 1}")
        if donor_mask[j]:
            raise ValueError(f"replica {j} is both donor and joiner")
    mask = flatbuf.normalize_membership(donor_mask, n)
    sel = [i in joining for i in range(n)]
    done = {}

    def leaf(x):
        if id(x) not in done:
            m = _donor_mean(x, mask)
            col = flatbuf.membership_col(sel, torch.bool, x.dim(), x.device)
            done[id(x)] = (x, torch.where(col, m, x))
        return done[id(x)][1]

    return tree_map(leaf, carry)
