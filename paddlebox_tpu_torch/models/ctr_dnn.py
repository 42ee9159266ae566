"""CTR-DNN: pooled slot embeddings (and the dense columns) into an MLP.

Counterpart of paddlebox_tpu/models/ctr_dnn.py:33-92, the reference's
test_boxps.py graph (pull -> sum-pool -> CVM -> fc stack). Parameters
dnn_w{i} [din, dout] and dnn_b{i}, the JAX names.

``use_data_norm`` normalizes the flattened input by running summaries
(ops/data_norm.py; the "summary" params of boxps_worker.cc:89-95) before
the MLP, in float32 whatever the compute dtype, the result cast back to the
input's dtype. The summaries are BUFFERS, ``dn_summary_batch_size``,
``dn_summary_batch_sum`` and ``dn_summary_batch_square_sum`` (the JAX
params' nested ``dn_summary`` dict, flattened by convert.py): the dense
optimizer never sees them, as the JAX model's stop_gradient gives optax
zero gradients there, and a bf16 forward leaves them f32 (functional_call
casts parameters only). The trainer moves them with ``update_summary``
after the dense step, the decayed running-sums rule.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.layers import mlp_apply, mlp_init, with_dense
from paddlebox_tpu_torch.ops.data_norm import (DataNormState, data_norm,
                                               data_norm_summary_update)

DN_FIELDS = ("batch_size", "batch_sum", "batch_square_sum")


class CtrDnn(nn.Module):
    name = "ctr_dnn"
    task_names = ("ctr",)
    matmul_dtype = "float32"

    def __init__(self, spec: ModelSpec,
                 hidden: Sequence[int] = (512, 256, 128),
                 use_data_norm: bool = False, dn_slot_dim: int = 0,
                 dn_decay: float = 0.9999999,
                 generator: Optional[torch.Generator] = None) -> None:
        """Parameters are drawn on the CPU from ``generator``; move the
        module afterwards."""
        super().__init__()
        self.spec = spec
        self.hidden = tuple(hidden)
        self.use_data_norm = use_data_norm
        self.dn_slot_dim = dn_slot_dim
        self.dn_decay = dn_decay
        mlp_init(self, [spec.total_in, *self.hidden, 1], "dnn", generator)
        if use_data_norm:
            st = DataNormState.init(spec.total_in)
            for f in DN_FIELDS:
                self.register_buffer("dn_summary_" + f, getattr(st, f))

    def dn_state(self) -> DataNormState:
        return DataNormState(*(getattr(self, "dn_summary_" + f)
                               for f in DN_FIELDS))

    @staticmethod
    def _assemble(pooled: torch.Tensor,
                  dense: Optional[torch.Tensor]) -> torch.Tensor:
        return with_dense(pooled.reshape(pooled.shape[0], -1), dense)

    def forward(self, pooled: torch.Tensor,
                dense: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self._assemble(pooled, dense)
        if self.use_data_norm:
            x = data_norm(x.float(), self.dn_state(),
                          slot_dim=self.dn_slot_dim).to(x.dtype)
        return mlp_apply(self, x, "dnn", matmul_dtype=self.matmul_dtype)[:, 0]

    @torch.no_grad()
    def update_summary(self, pooled: torch.Tensor,
                       dense: Optional[torch.Tensor] = None) -> None:
        """This batch into the running summaries, in place (the trainer
        calls it after the dense step, on the step's f32 pooled input)."""
        x = self._assemble(pooled, dense).float()
        st = data_norm_summary_update(self.dn_state(), x,
                                      decay=self.dn_decay,
                                      slot_dim=self.dn_slot_dim)
        for f in DN_FIELDS:
            getattr(self, "dn_summary_" + f).copy_(getattr(st, f))
