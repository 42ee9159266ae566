"""CTR-DNN over the pooled slots and an aux row read from a side table.

Counterpart of paddlebox_tpu/models/aux_input.py:32-68, the consumer of
the reference's lookup_input / pull_cache_value ops: the feed translates
each instance's key to a row offset on the host (BatchPacker's
input_table or use_cache_idx -> the batch's ``aux_offset``), and the model
gathers ``aux_rows[aux_offset]`` on the device and appends it to the MLP's
input. ``aux_rows`` [aux_capacity, aux_dim] is a BUFFER: the dense
optimizer never sees it (the JAX model's stop_gradient leaves optax a
zero gradient there) and a bf16 forward leaves it f32; the trainer
refreshes it from its ``aux_source`` (embedding/side_tables.py) at the
start of every pass, at the fixed capacity. Parameters dnn_w{i} [din,
dout] and dnn_b{i}, the JAX names (din of the first layer total_in +
aux_dim). A batch without ``aux_offset`` raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.layers import mlp_apply, mlp_init, with_dense


class CtrDnnAux(nn.Module):
    name = "ctr_dnn_aux"
    task_names = ("ctr",)
    use_aux_input = True
    matmul_dtype = "float32"

    def __init__(self, spec: ModelSpec, aux_dim: int,
                 aux_capacity: int = 1 << 12,
                 hidden: Sequence[int] = (512, 256, 128),
                 generator: Optional[torch.Generator] = None) -> None:
        """Parameters are drawn on the CPU from ``generator``; move the
        module afterwards."""
        super().__init__()
        self.spec = spec
        self.aux_dim = aux_dim
        self.aux_capacity = aux_capacity
        self.hidden = tuple(hidden)
        mlp_init(self, [spec.total_in + aux_dim, *self.hidden, 1], "dnn",
                 generator)
        self.register_buffer("aux_rows",
                             torch.zeros(aux_capacity, aux_dim))

    def forward(self, pooled: torch.Tensor,
                dense: Optional[torch.Tensor] = None,
                aux_offset: Optional[torch.Tensor] = None) -> torch.Tensor:
        if aux_offset is None:
            raise ValueError("CtrDnnAux needs the aux_offset batch leaf: "
                             "give the dataset an input_table or "
                             "use_cache_idx (BatchPacker)")
        x = with_dense(pooled.reshape(pooled.shape[0], -1), dense)
        aux = self.aux_rows.index_select(0, aux_offset.reshape(-1).long())
        x = torch.cat([x, aux.to(x.dtype)], dim=-1)
        return mlp_apply(self, x, "dnn", matmul_dtype=self.matmul_dtype)[:, 0]
