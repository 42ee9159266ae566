"""Static shape info every model needs (paddlebox_tpu/models/base.py:25-38).

A model is an ``nn.Module`` whose ``forward(pooled, dense=None)`` maps the
fused seqpool+CVM output [B, num_slots, slot_dim] and the batch's dense
columns [B, dense_dim] (None when the feed has none) to logits: [B] for a
single-task model, a dict of [B] by task for a multi-task one (its
``task_names``, the main task first). Parameter names follow the JAX params
dict, so weights carry across by name (convert.params_from_jax).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    num_slots: int
    slot_dim: int          # per-slot pooled width (3+embedx_dim with CVM)
    dense_dim: int = 0

    @property
    def sparse_in(self) -> int:
        return self.num_slots * self.slot_dim

    @property
    def total_in(self) -> int:
        return self.sparse_in + self.dense_dim
