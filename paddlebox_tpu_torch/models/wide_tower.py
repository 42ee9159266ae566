"""Model-parallel zoo entries: the wide-tower DeepFM (tensor parallel) and
the expert-parallel MMoE.

Counterpart of paddlebox_tpu/models/wide_tower.py. The deep tower's wide
hidden layer splits over the ranks of an ``mp`` process group (the
Megatron split of parallel/tensor_parallel.py), or the MMoE's expert
blocks do; parallel/mesh_tower.py MeshTowerTrainer trains them and
enforces the autodiff contract (tp_loss_scale and tp_fix_grads).

The contract is the reference's, not the replicated zoo's nn.Module:

  host_init(seed)  -> (host_params, sharded): numpy leaves drawn from
                      np.random.RandomState(seed), the reference's arrays
                      bit for bit; ``sharded`` a dict of bools of the same
                      keys, True where the leaf stacks the shards on a
                      leading [P] axis
  apply_local(p, pooled, group) -> [B] logits on one rank of ``group``,
                      ``p`` this rank's tensors: each sharded leaf without
                      its leading [P] axis (convert.tower_params_from_jax)

Neither takes a rank_offset or dense columns: the input is the pooled
[B, num_slots, slot_dim] alone.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.parallel.tensor_parallel import (ep_experts_apply,
                                                          ep_experts_init,
                                                          tp_mlp_apply,
                                                          tp_mlp_init)

Params = Mapping[str, torch.Tensor]


class TpDeepFM:
    """DeepFM whose deep tower's first (wide) layer is tensor parallel.

    The FM first- and second-order terms are replicated, as
    models/deepfm.py computes them; the deep path is one Megatron block
    (total_in -> d_wide / P on each rank -> d_mid, one psum) and a small
    replicated head. A rank holds O(d_wide / P) of the tower."""

    name = "tp_deepfm"
    task_names = ("ctr",)

    def __init__(self, spec: ModelSpec, n_shards: int, d_wide: int = 4096,
                 d_mid: int = 128, embedx_dim: int = None) -> None:
        self.spec = spec
        self.n_shards = n_shards
        self.d_wide = d_wide
        self.d_mid = d_mid
        self.embedx_dim = (embedx_dim if embedx_dim is not None
                           else spec.slot_dim - 3)

    def host_init(self, seed: int) -> Tuple[Dict[str, np.ndarray],
                                            Dict[str, bool]]:
        rng = np.random.RandomState(seed)
        p = tp_mlp_init(rng, self.n_shards, self.spec.total_in, self.d_wide,
                        self.d_mid)
        p["head_w"] = (0.1 * rng.randn(self.d_mid)).astype(np.float32)
        p["head_b"] = np.zeros((), np.float32)
        p["fm_out_w"] = (0.1 * rng.randn(3)).astype(np.float32)
        p["fm_out_b"] = np.zeros((), np.float32)
        return p, {k: k in ("w1", "b1", "w2") for k in p}

    def apply_local(self, p: Params, pooled: torch.Tensor,
                    group=None) -> torch.Tensor:
        B = pooled.shape[0]
        D = self.embedx_dim
        first_order = pooled[:, :, 2].sum(dim=1)
        v = pooled[:, :, 3:3 + D]
        sum_v = v.sum(dim=1)
        fm2 = 0.5 * (sum_v * sum_v - (v * v).sum(dim=1)).sum(dim=-1)
        mid = torch.relu(tp_mlp_apply(p, pooled.reshape(B, -1), group))
        deep = mid @ p["head_w"] + p["head_b"]
        stack = torch.stack([first_order, fm2, deep], dim=-1)
        return stack @ p["fm_out_w"] + p["fm_out_b"]


class EpMMoE:
    """The expert-parallel MMoE-style CTR tower: n_experts dense expert
    MLPs split over the group (each rank owns E / P), a replicated softmax
    gate mixes them (every expert sees every instance) and a small
    replicated head reads the mixture. The gate's partial gradient is
    summed over the group by the trainer's tp_fix_grads."""

    name = "ep_mmoe"
    task_names = ("ctr",)

    def __init__(self, spec: ModelSpec, n_shards: int, n_experts: int = 8,
                 d_hidden: int = 64, d_out: int = 32) -> None:
        if n_experts % n_shards:
            raise ValueError("n_experts %d not divisible by %d shards"
                             % (n_experts, n_shards))
        self.spec = spec
        self.n_shards = n_shards
        self.n_experts = n_experts
        self.d_hidden = d_hidden
        self.d_out = d_out

    def host_init(self, seed: int) -> Tuple[Dict[str, np.ndarray],
                                            Dict[str, bool]]:
        rng = np.random.RandomState(seed)
        p = ep_experts_init(rng, self.n_experts, self.spec.total_in,
                            self.d_hidden, self.d_out)
        # the expert leaves regroup [E, ...] -> [P, E / P, ...]: the shard
        # axis leads
        el = self.n_experts // self.n_shards
        for k in ("ew1", "eb1", "ew2", "eb2"):
            p[k] = p[k].reshape((self.n_shards, el) + p[k].shape[1:])
        p["head_w"] = (0.1 * rng.randn(self.d_out)).astype(np.float32)
        p["head_b"] = np.zeros((), np.float32)
        return p, {k: k in ("ew1", "eb1", "ew2", "eb2") for k in p}

    def apply_local(self, p: Params, pooled: torch.Tensor,
                    group=None) -> torch.Tensor:
        B = pooled.shape[0]
        mix = ep_experts_apply(p, pooled.reshape(B, -1), group)
        return mix @ p["head_w"] + p["head_b"]
