"""DLRM (the MLPerf-rec shape): a bottom MLP on the dense columns, the
pairwise dot products of the per-slot embedx vectors and the bottom
output, and a top MLP on [interactions, bottom].

Counterpart of paddlebox_tpu/models/dlrm.py:16-53. The bottom MLP ends in
embedx_dim with its activation after the last layer too
(``final_act=True``); the dots are one plain einsum, and the pairs (s, t)
with s < t come from ``torch.triu_indices(S, S, 1)``, row-major as
jnp.triu_indices gives them. Parameters bot_w{i} / bot_b{i} (only with a
dense input) and top_w{i} / top_b{i}, the JAX names.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.layers import mlp_apply, mlp_init


class DLRM(nn.Module):
    name = "dlrm"
    task_names = ("ctr",)
    matmul_dtype = "float32"

    def __init__(self, spec: ModelSpec, bottom: Sequence[int] = (128, 64),
                 top: Sequence[int] = (256, 128),
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.spec = spec
        self.embedx_dim = spec.slot_dim - 3
        self.bottom = tuple(bottom) + (self.embedx_dim,)
        self.top = tuple(top)
        if spec.dense_dim:
            mlp_init(self, [spec.dense_dim, *self.bottom], "bot", generator)
        S = spec.num_slots + (1 if spec.dense_dim else 0)
        top_in = S * (S - 1) // 2 + (self.embedx_dim if spec.dense_dim
                                     else 0)
        mlp_init(self, [top_in, *self.top, 1], "top", generator)

    def forward(self, pooled: torch.Tensor,
                dense: Optional[torch.Tensor] = None) -> torch.Tensor:
        feats = pooled[:, :, 3:]                          # [B, S, D]
        bot = None
        if dense is not None and self.spec.dense_dim:
            bot = mlp_apply(self, dense, "bot", matmul_dtype=self.matmul_dtype,
                            final_act=True)               # [B, D]
            feats = torch.cat([feats, bot[:, None, :]], dim=1)
        inter = torch.einsum("bsd,btd->bst", feats, feats)
        S = feats.shape[1]
        iu, ju = torch.triu_indices(S, S, 1, device=feats.device)
        x = inter[:, iu, ju]                              # [B, S(S-1)/2]
        if bot is not None:
            x = torch.cat([x, bot], dim=-1)
        return mlp_apply(self, x, "top", matmul_dtype=self.matmul_dtype)[:, 0]
