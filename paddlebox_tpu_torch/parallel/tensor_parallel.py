"""Tensor parallelism (the Megatron MLP split) and expert parallelism
(MoE) over a torch.distributed process group.

Counterpart of paddlebox_tpu/parallel/tensor_parallel.py, whose functions
run per device inside shard_map over a mesh axis; here each runs on one
rank of ``group`` (None: the world, where torch.distributed is
initialized; ``LOCAL``: this process alone), and with no process group, in
a group of one or under LOCAL it is the identity of its collective: no
call is made.

  tp_mlp_apply      W1 split by columns, W2 by rows, one psum a block:
                    the activations stay split through the hidden dim
  ep_experts_apply  each rank owns E/P experts; the gates are computed
                    replicated and each rank's gate-weighted outputs are
                    psum'd into the mixture

The psum is torch.distributed.nn.functional.all_reduce, whose backward
all-reduces the gradient: the transpose JAX gives psum, so the autodiff
contract is the reference's. Each rank computes the same replicated loss
from psum'd activations, so the loss is divided by the group's size before
the gradient (``tp_loss_scale``), or the psum's transpose scales every
split leaf's gradient by P; then every replicated leaf (b2 after the
psum, a head, the gate, an embedding cotangent) carries a partial
gradient that must be psum'd across the group (``tp_fix_grads``,
``ep_gate_psum``).
"""

from __future__ import annotations

import warnings
from typing import Dict, Mapping

import numpy as np
import torch
import torch.distributed as dist


class _Local:
    """The group of this process alone, whatever process group exists."""

    def __repr__(self) -> str:
        return "LOCAL"


# a one-shard caller's group: no collective, even inside a larger world
LOCAL = _Local()


def group_size(group=None) -> int:
    """The ranks of ``group`` (None: the world), 1 under LOCAL or without a
    process group."""
    if (group is LOCAL or not dist.is_available()
            or not dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def group_rank(group=None) -> int:
    """This process's rank in ``group`` (None: the world), 0 under LOCAL or
    without a process group."""
    if (group is LOCAL or not dist.is_available()
            or not dist.is_initialized()):
        return 0
    return dist.get_rank(group)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``x`` over ``group``'s ranks with autograd (the backward
    all-reduces the gradient); ``x`` itself in a group of one."""
    if group_size(group) == 1:
        return x
    from torch.distributed.nn import functional as dnn
    with warnings.catch_warnings():
        # the autograd collectives warn that they are deprecated in favour
        # of functional collectives, which carry no autograd
        warnings.simplefilter("ignore", FutureWarning)
        return dnn.all_reduce(
            x, group=group if group is not None else dist.group.WORLD)


def tp_mlp_init(rng: np.random.RandomState, n_shards: int, d_in: int,
                d_hidden: int, d_out: int,
                scale: float = 0.1) -> Dict[str, np.ndarray]:
    """[P, ...] stacked shards: W1 split by columns, W2 by rows; b2 is
    replicated (added after the psum, once). The reference's draws."""
    if d_hidden % n_shards:
        raise ValueError("d_hidden %d not divisible by %d shards"
                         % (d_hidden, n_shards))
    h = d_hidden // n_shards
    return {
        "w1": (scale * rng.randn(n_shards, d_in, h)).astype(np.float32),
        "b1": np.zeros((n_shards, h), np.float32),
        "w2": (scale * rng.randn(n_shards, h, d_out)).astype(np.float32),
        "b2": np.zeros((d_out,), np.float32),
    }


def tp_mlp_apply(p_local: Mapping[str, torch.Tensor], x: torch.Tensor,
                 group=None) -> torch.Tensor:
    """One rank's Megatron block: x replicated [B, d_in]; p_local this
    rank's {w1 [d_in, h/P], b1 [h/P], w2 [h/P, d_out], b2 [d_out]}:
    relu(x @ W1_col) @ W2_row summed across the group, then + b2."""
    h = torch.relu(x @ p_local["w1"] + p_local["b1"])
    return psum(h @ p_local["w2"], group) + p_local["b2"]


def tp_loss_scale(loss: torch.Tensor, group=None) -> torch.Tensor:
    """The contract's first half: a replicated loss made from psum'd
    activations is divided by the group's size before the gradient."""
    return loss / group_size(group)


def all_reduce_(t: torch.Tensor, group=None) -> None:
    """Sum ``t`` over the group in place, outside autograd (no call in a
    group of one)."""
    if group_size(group) > 1:
        dist.all_reduce(t, group=group)


def _psum_grad(g, group):
    """A computed gradient summed over the group, a new tensor."""
    if g is None or group_size(group) == 1:
        return g
    g = g.clone()
    all_reduce_(g, group)
    return g


def tp_fix_grads(grads, sharded, group=None):
    """The contract's second half: under the 1/P-scaled loss a split leaf's
    gradient (w1, w2, an expert block) is exact, and every replicated
    leaf's is partial and is summed across the group here. ``grads`` and
    ``sharded`` are matching (nested) dicts, True marking a split leaf;
    returns the corrected grads, a new dict."""
    if isinstance(grads, Mapping):
        return {k: tp_fix_grads(grads[k], sharded[k], group) for k in grads}
    return grads if sharded else _psum_grad(grads, group)


def ep_gate_psum(grads: Mapping[str, torch.Tensor], group=None
                 ) -> Dict[str, torch.Tensor]:
    """ep_experts_apply's gate contract: the replicated gate's gradient is
    partial on each rank (its expert slice's cotangent only) and is summed
    across the group before any update."""
    return dict(grads, gate=_psum_grad(grads["gate"], group))


def ep_experts_init(rng: np.random.RandomState, n_experts: int, d_in: int,
                    d_hidden: int, d_out: int,
                    scale: float = 0.1) -> Dict[str, np.ndarray]:
    """[E, ...] stacked expert MLPs and a replicated gate [d_in, E]. The
    reference's draws."""
    return {
        "ew1": (scale * rng.randn(n_experts, d_in, d_hidden)
                ).astype(np.float32),
        "eb1": np.zeros((n_experts, d_hidden), np.float32),
        "ew2": (scale * rng.randn(n_experts, d_hidden, d_out)
                ).astype(np.float32),
        "eb2": np.zeros((n_experts, d_out), np.float32),
        "gate": (scale * rng.randn(d_in, n_experts)).astype(np.float32),
    }


def ep_experts_apply(p_local: Mapping[str, torch.Tensor], x: torch.Tensor,
                     group=None) -> torch.Tensor:
    """One rank's expert-parallel MoE: x replicated [B, d_in]; p_local this
    rank's E/P experts (leading axis) and the replicated gate over all E.
    Dense (MMoE-style) gating: every expert sees every instance, each rank
    weights its experts' outputs by their gates, and the psum assembles
    the mixture; expert weights never leave their rank."""
    e_local = p_local["ew1"].shape[0]
    idx = group_rank(group)
    gates = torch.softmax(x @ p_local["gate"], dim=-1)            # [B, E]
    g_local = gates[:, idx * e_local:(idx + 1) * e_local]        # [B, E/P]
    h = torch.relu(torch.einsum("bi,eih->beh", x, p_local["ew1"])
                   + p_local["eb1"])
    y = torch.einsum("beh,eho->beo", h, p_local["ew2"]) + p_local["eb2"]
    return psum(torch.einsum("beo,be->bo", y, g_local), group)
