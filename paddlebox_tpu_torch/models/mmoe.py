"""MMoE: multi-gate mixture of experts over the shared pooled input.

Counterpart of paddlebox_tpu/models/mmoe.py:17-60. The experts
(expert_w [E, din, H], expert_b [E, H]) and the per-task softmax gates
(gate_w [T, din, E]) are plain einsums, outside ``matmul_dtype`` as in JAX;
each task's tower (tower_{task}_w{i}, tower_{task}_b{i}) goes through
mlp_apply. ``forward`` returns the logits by task, the main task first.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.layers import mlp_apply, mlp_init, with_dense


class MMoE(nn.Module):
    name = "mmoe"
    matmul_dtype = "float32"

    def __init__(self, spec: ModelSpec, num_experts: int = 4,
                 expert_dim: int = 64,
                 tasks: Tuple[str, ...] = ("ctr", "cvr"),
                 tower: Sequence[int] = (32,),
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.spec = spec
        self.num_experts = num_experts
        self.expert_dim = expert_dim
        self.task_names = tuple(tasks)
        self.tower = tuple(tower)
        din, E, H = spec.total_in, num_experts, expert_dim
        self.expert_w = nn.Parameter(
            torch.randn(E, din, H, generator=generator) * math.sqrt(2.0 / din))
        self.expert_b = nn.Parameter(torch.zeros(E, H))
        self.gate_w = nn.Parameter(
            torch.randn(len(self.task_names), din, E, generator=generator)
            * 0.01)
        for t in self.task_names:
            mlp_init(self, [H, *self.tower, 1], f"tower_{t}", generator)

    def forward(self, pooled: torch.Tensor,
                dense: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        x = with_dense(pooled.reshape(pooled.shape[0], -1), dense)
        experts = torch.relu(torch.einsum("bi,eih->beh", x, self.expert_w)
                             + self.expert_b)                # [B, E, H]
        gates = torch.softmax(torch.einsum("bi,tie->bte", x, self.gate_w),
                              dim=-1)                        # [B, T, E]
        mixed = torch.einsum("bte,beh->bth", gates, experts)  # [B, T, H]
        return {t: mlp_apply(self, mixed[:, i], f"tower_{t}",
                             matmul_dtype=self.matmul_dtype)[:, 0]
                for i, t in enumerate(self.task_names)}
