"""NN-cross CTR model over the dual-output expand embedding.

Counterpart of paddlebox_tpu/models/nn_cross.py:27-72 (CtrDnnExpand), the
model family pull_box_extended_sparse exists for (user API
``fluid.contrib.layers.pull_box_extended_sparse``, contrib/layers/nn.py:
1678): every feature carries a second embedding block (the expand vector,
TableConfig.expand_embed_dim wide) trained with the base one. The pooled
base view feeds a deep tower; the sum-pooled expand vectors feed a cross
branch, an FM-style second-order term over the slots plus a linear
projection. Both branches' gradients go back through one extended push
(ops/sparse.py build_push_grads_extended).

Parameter names: the tower's dnn_w{i} [din, dout] and dnn_b{i}, the JAX
layout; the JAX params' nested ``params["cross"]`` dict (lin_w [S*E, 1],
lin_b [1], fm_scale []) is registered flat as cross_lin_w, cross_lin_b
and cross_fm_scale (convert.py nests and flattens it).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.layers import (mlp_apply, mlp_init,
                                               promoted_matmul, with_dense)


class CtrDnnExpand(nn.Module):
    name = "ctr_dnn_expand"
    task_names = ("ctr",)
    use_expand = True   # the trainer pulls extended and pushes expand grads
    matmul_dtype = "float32"

    def __init__(self, spec: ModelSpec, expand_dim: int,
                 hidden: Sequence[int] = (64, 32),
                 generator: Optional[torch.Generator] = None) -> None:
        """Parameters are drawn on the CPU from ``generator`` (seeded by the
        caller for a reproducible init); move the module afterwards."""
        super().__init__()
        if expand_dim <= 0:
            raise ValueError("CtrDnnExpand needs expand_dim > 0")
        self.spec = spec
        self.expand_dim = expand_dim
        self.hidden = tuple(hidden)
        mlp_init(self, [spec.total_in, *self.hidden, 1], "dnn", generator)
        S, E = spec.num_slots, expand_dim
        self.cross_lin_w = nn.Parameter(
            torch.randn(S * E, 1, generator=generator) * 0.01)
        self.cross_lin_b = nn.Parameter(torch.zeros(1))
        self.cross_fm_scale = nn.Parameter(torch.ones(()))

    def forward(self, pooled: torch.Tensor,
                expand: Optional[torch.Tensor] = None,
                dense: Optional[torch.Tensor] = None) -> torch.Tensor:
        """pooled [B, S, slot_dim] base view; expand [B, S, E] the
        sum-pooled expand vectors (required: the trainer's extended pull
        supplies them); dense [B, dense_dim] appended to the tower's
        input, when the feed has it."""
        if expand is None:
            raise ValueError("CtrDnnExpand needs the expand input")
        B = pooled.shape[0]
        deep = mlp_apply(self, with_dense(pooled.reshape(B, -1), dense),
                         "dnn", matmul_dtype=self.matmul_dtype)[:, 0]
        # 0.5 * sum_e ((sum_s v_se)^2 - sum_s v_se^2), the pairwise slot
        # inner products
        s_sum = expand.sum(dim=1)
        s_sq = (expand * expand).sum(dim=1)
        fm = 0.5 * (s_sum * s_sum - s_sq).sum(dim=-1)
        lin = promoted_matmul(expand.reshape(B, -1), self.cross_lin_w)[:, 0] \
            + self.cross_lin_b[0]
        return deep + self.cross_fm_scale * fm + lin
