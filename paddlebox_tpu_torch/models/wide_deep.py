"""Wide&Deep: a linear (wide) head over each slot's CVM and embed_w columns
and the dense columns, plus a deep MLP over the whole pooled input.

Counterpart of paddlebox_tpu/models/wide_deep.py:18-46. Parameters: the
deep tower's deep_w{i} [din, dout] and deep_b{i}, wide_w
[num_slots * 3 + dense_dim, 1] and wide_b [1], the JAX names. The wide
product is a plain promoted ``@``; the deep tower's follows
``matmul_dtype``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.layers import (mlp_apply, mlp_init,
                                               promoted_matmul, with_dense)


class WideDeep(nn.Module):
    name = "wide_deep"
    task_names = ("ctr",)
    matmul_dtype = "float32"

    def __init__(self, spec: ModelSpec,
                 hidden: Sequence[int] = (256, 128, 64),
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.spec = spec
        self.hidden = tuple(hidden)
        mlp_init(self, [spec.total_in, *self.hidden, 1], "deep", generator)
        wide_in = spec.num_slots * 3 + spec.dense_dim
        self.wide_w = nn.Parameter(
            torch.randn(wide_in, 1, generator=generator) * 0.01)
        self.wide_b = nn.Parameter(torch.zeros(1))

    def forward(self, pooled: torch.Tensor,
                dense: Optional[torch.Tensor] = None) -> torch.Tensor:
        B = pooled.shape[0]
        wide_x = with_dense(pooled[:, :, :3].reshape(B, -1), dense)
        deep_x = with_dense(pooled.reshape(B, -1), dense)
        wide = (promoted_matmul(wide_x, self.wide_w) + self.wide_b)[:, 0]
        deep = mlp_apply(self, deep_x, "deep",
                         matmul_dtype=self.matmul_dtype)[:, 0]
        return wide + deep
