"""Join-phase pv ranking model: rank_attention over a pv's peers, then an
MLP.

Counterpart of paddlebox_tpu/models/join_pv.py:23-59. Each ad instance
attends over the ads of its pv (search session) through a parameter block
for each (rank, peer rank) pair (ops/rank_attention.py), and the attention
output joins the pooled slot features (and the dense columns) in the
ranking MLP. Parameters by the JAX names: dnn_w{i} [din, dout], dnn_b{i}
(din of the first layer num_slots * slot_dim + att_dim + dense_dim) and
rank_param [max_rank^2 * num_slots * slot_dim, att_dim]. The trainer feeds
the batch's rank-offset matrix (a ``rank_offset`` feed, data/pv.py); a
batch without one gets zero attention (the update phase's fallback).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.layers import mlp_apply, mlp_init
from paddlebox_tpu_torch.ops.rank_attention import rank_attention


class JoinPvDnn(nn.Module):
    name = "join_pv_dnn"
    task_names = ("ctr",)
    use_rank_offset = True  # the trainer feeds the batch's rank_offset
    matmul_dtype = "float32"

    def __init__(self, spec: ModelSpec, max_rank: int = 3,
                 att_dim: int = 64,
                 hidden: Sequence[int] = (512, 256, 128),
                 generator: Optional[torch.Generator] = None) -> None:
        """Parameters are drawn on the CPU from ``generator``; move the
        module afterwards."""
        super().__init__()
        self.spec = spec
        self.max_rank = max_rank
        self.att_dim = att_dim
        self.hidden = tuple(hidden)
        F = spec.sparse_in
        mlp_init(self, [F + att_dim + spec.dense_dim, *self.hidden, 1], "dnn",
                 generator)
        self.rank_param = nn.Parameter(
            torch.randn(max_rank * max_rank * F, att_dim,
                        generator=generator) * math.sqrt(1.0 / F))

    def forward(self, pooled: torch.Tensor,
                dense: Optional[torch.Tensor] = None,
                rank_offset: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = pooled.reshape(pooled.shape[0], -1)
        if rank_offset is None:
            att = x.new_zeros(x.shape[0], self.att_dim)
        else:
            att, _ = rank_attention(x, rank_offset, self.rank_param,
                                    self.max_rank)
        feats = [x, att] if dense is None else [x, att, dense]
        return mlp_apply(self, torch.cat(feats, dim=-1), "dnn",
                         matmul_dtype=self.matmul_dtype)[:, 0]
