"""DeepFM: factorization machine + deep tower over the pooled slots.

Counterpart of paddlebox_tpu/models/deepfm.py:19-53. The FM second-order
term is (sum^2 - sum of squares)/2 over the per-slot embedx vectors; the
first order is the sum of the pooled embed_w column; a [3] output layer
mixes (first order, FM, deep). Parameter names match the JAX params dict:
deep_w{i} [din, dout], deep_b{i}, fm_out_w [3], fm_out_b [].
``matmul_dtype`` is the deep tower's product (models/layers.py; the
trainer sets it from DtypeFlags); mixed dtypes under a bf16 compute dtype
promote as in the JAX model. The dense columns, when the feed has them, are
appended to the deep tower's input (its width is the spec's total_in).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.layers import (mlp_apply, mlp_init,
                                               promoted_matmul, with_dense)


class DeepFM(nn.Module):
    name = "deepfm"
    task_names = ("ctr",)
    matmul_dtype = "float32"

    def __init__(self, spec: ModelSpec,
                 hidden: Sequence[int] = (400, 400, 400),
                 embedx_dim: Optional[int] = None,
                 generator: Optional[torch.Generator] = None) -> None:
        """``embedx_dim``: the embedx columns the FM term reads after a
        slot's embed_w (None: ``spec.slot_dim - 3``, every column after
        it). Parameters are drawn on the CPU from ``generator`` (seeded by
        the caller for a reproducible init); move the module afterwards."""
        super().__init__()
        self.spec = spec
        self.hidden = tuple(hidden)
        # pooled slot layout: [log_show, log_ctr, embed_w, embedx...(D)]
        self.embedx_dim = (embedx_dim if embedx_dim is not None
                           else spec.slot_dim - 3)
        mlp_init(self, [spec.total_in, *self.hidden, 1], "deep", generator)
        self.fm_out_w = nn.Parameter(torch.randn(3, generator=generator) * 0.1)
        self.fm_out_b = nn.Parameter(torch.zeros(()))

    def forward(self, pooled: torch.Tensor,
                dense: Optional[torch.Tensor] = None) -> torch.Tensor:
        B = pooled.shape[0]
        D = self.embedx_dim
        first_order = pooled[:, :, 2].sum(dim=1)
        v = pooled[:, :, 3:3 + D]
        sum_v = v.sum(dim=1)
        fm2 = 0.5 * (sum_v * sum_v - (v * v).sum(dim=1)).sum(dim=-1)
        deep = mlp_apply(self, with_dense(pooled.reshape(B, -1), dense),
                         "deep", matmul_dtype=self.matmul_dtype)[:, 0]
        stack = torch.stack([first_order, fm2, deep], dim=-1)
        return promoted_matmul(stack, self.fm_out_w) + self.fm_out_b
