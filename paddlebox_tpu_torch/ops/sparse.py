"""Sparse pull/push building blocks of the train step.

Counterpart of paddlebox_tpu/ops/sparse.py:30-121. The pull gathers full
slab rows by id and cuts the per-key pull view [show, click, embed_w,
embedx...]; the extended pull (pull_box_extended_sparse) cuts the expand
block's [expand_w...] beside it. The backward of the pull is not a slab
gradient but the per-key push rows built here.
"""

from __future__ import annotations

import torch

from typing import Optional

from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.embedding.accessor import ValueLayout
from paddlebox_tpu_torch.ops.row_kernels import (gather_rows,
                                                 gather_rows_decode)


def gather_slab_rows(slab: torch.Tensor, ids: torch.Tensor,
                     layout: Optional[ValueLayout] = None) -> torch.Tensor:
    """[K, width] f32 rows slab[ids] for int32 ids (padding ids address the
    trash row; an id past the slab reads the last row, as JAX's gather
    clamps), DECODED under a bf16 ``layout`` (reference ops/sparse.py:
    46-54; None or an f32 layout: the f32 slab's rows as they are). On
    the card this is the gather_rows kernel; on a bf16 slab its decoding
    form, the raw gather and the codec's decode in one kernel."""
    if layout is None or not layout.bf16:
        return gather_rows(slab, ids)
    return gather_rows_decode(slab, ids, layout)


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


def pull_sparse_extended(slab: torch.Tensor, ids: torch.Tensor,
                         layout: ValueLayout):
    """pull_box_extended_sparse (reference ops/sparse.py:85-101): the pull
    view [K, 3+D] and the expand (NN-cross) embedding [K, E] of the same
    gathered rows. The layout must have an expand block."""
    if not layout.expand_dim:
        raise ValueError("layout has no expand block (expand_dim == 0)")
    rows = gather_slab_rows(slab, ids, layout)
    ew = layout.expand_w
    return (pull_view_from_rows(rows, layout),
            rows[:, ew:ew + layout.expand_dim])


def build_push_grads_extended(d_emb: torch.Tensor, d_expand: torch.Tensor,
                              slots: torch.Tensor, clicks: torch.Tensor,
                              valid: torch.Tensor) -> torch.Tensor:
    """Push rows [K, 4+D+E] with the expand block's gradient d_expand
    [K, E] after the embedx grads (reference ops/sparse.py:104-121, the
    push_box_extended_sparse backward)."""
    v = valid.to(d_emb.dtype)[:, None]
    return torch.cat([build_push_grads(d_emb, slots, clicks, valid),
                      d_expand * v], dim=1)
