"""Sparse pull/push building blocks of the train step.

Counterpart of paddlebox_tpu/ops/sparse.py:30-82. The pull gathers full slab
rows by id and cuts the per-key pull view [show, click, embed_w, embedx...].
The backward of the pull is not a slab gradient but the per-key push rows
built here.
"""

from __future__ import annotations

import torch

from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.embedding.accessor import ValueLayout
from paddlebox_tpu_torch.ops.row_kernels import gather_rows


def gather_slab_rows(slab: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """[K, width] rows slab[ids] for int32 ids (padding ids address the
    trash row; an id past the slab reads the last row, as JAX's gather
    clamps). On the card this is the gather_rows kernel."""
    return gather_rows(slab, ids)


def pull_view_from_rows(rows: torch.Tensor,
                        layout: ValueLayout) -> torch.Tensor:
    """Pull view [K, 3+D]: show, click, embed_w, embedx."""
    D = layout.embedx_dim
    xw0 = layout.embedx_w
    return torch.cat([rows[:, acc.SHOW:acc.CLICK + 1],
                      rows[:, acc.EMBED_W:acc.EMBED_W + 1],
                      rows[:, xw0:xw0 + D]], dim=1)


def build_push_grads(d_emb: torch.Tensor, slots: torch.Tensor,
                     clicks: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-key push rows [K, 4+D] from the pull view's gradient.

    d_emb [K, 3+D] (its show/click columns are dropped), slots [K] slot
    ordinal, clicks [K] the label of each key's instance, valid [K] bool.
    g_show is 1 per valid occurrence; the push merges duplicates."""
    v = valid.to(d_emb.dtype)[:, None]
    return torch.cat([slots.to(d_emb.dtype)[:, None], v,
                      clicks.to(d_emb.dtype)[:, None] * v,
                      d_emb[:, 2:] * v], dim=1)
