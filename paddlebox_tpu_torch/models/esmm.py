"""ESMM: entire-space multi-task CTR + CVR over shared embeddings.

Counterpart of paddlebox_tpu/models/esmm.py:21-46: two towers (ctr_w{i},
ctr_b{i} and cvr_w{i}, cvr_b{i}, the JAX names) over the pooled input and
the dense columns, returning logits for 'ctr' and 'cvr'. ``loss_mode =
"esmm"`` makes the trainer compose pCTCVR = pCTR * pCVR and train
BCE(click, pCTR) + BCE(conversion, pCTCVR) over every impression
(train/trainer.py ``multi_task_loss``); the batch's cvr label is the feed's
conversion label (the click label when the feed has none).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.layers import mlp_apply, mlp_init, with_dense


class ESMM(nn.Module):
    name = "esmm"
    task_names = ("ctr", "cvr")
    loss_mode = "esmm"
    matmul_dtype = "float32"

    def __init__(self, spec: ModelSpec,
                 tower: Sequence[int] = (256, 128, 64),
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.spec = spec
        self.tower = tuple(tower)
        for t in self.task_names:
            mlp_init(self, [spec.total_in, *self.tower, 1], t, generator)

    def forward(self, pooled: torch.Tensor,
                dense: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        x = with_dense(pooled.reshape(pooled.shape[0], -1), dense)
        return {t: mlp_apply(self, x, t, matmul_dtype=self.matmul_dtype)[:, 0]
                for t in self.task_names}
