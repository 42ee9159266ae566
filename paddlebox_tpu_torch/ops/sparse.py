"""Sparse pull/push building blocks of the train step.

Counterpart of paddlebox_tpu/ops/sparse.py. The pull gathers full slab
rows by id and cuts the per-key pull view [show, click, embed_w,
embedx...]; the extended pull (pull_box_extended_sparse) cuts the expand
block's [expand_w...] beside it. The backward of the pull is not a slab
gradient but the per-key push rows built here.

``pull_sparse_differentiable`` is the reference's full-graph form (its
custom_vjp, :123-149): the same pull, whose backward is a slab-shaped
gradient, each key's embed_w and embedx cotangents summed into its row
(show and click get none). The sum takes an id's occurrences in
ascending order from zero (a sorted segment sum, no atomics), so the
card's gradient is the CPU's bit for bit.

The public pulls take an id as JAX's indexing does (reference
ops/sparse.py:57-60, 138-147): an id in [-C, 0) is row C + id, in the
forward and in the slab gradient; an id still outside the slab then
reads the nearest row (JAX's gather clamps) and adds nothing to the
gradient (JAX's scatter drops it). The trainers' staged pulls
(gather_slab_rows with pull_view_from_rows or extended_views_from_rows)
take the route index's ids, which are never negative, as they are.
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
    form, the raw gather and the codec's decode in one kernel. A negative
    id reads row 0 (the kernel's lower clamp): the public pulls wrap ids
    in [-C, 0) first (``wrap_negative_ids``)."""
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


def wrap_negative_ids(ids: torch.Tensor, rows: int) -> torch.Tensor:
    """``ids`` with each negative id raised by ``rows`` (JAX's index
    normalization): an id in [-rows, 0) becomes its row, one below -rows
    stays negative."""
    return torch.where(ids < 0, ids + rows, ids)


def pull_sparse(slab: torch.Tensor, ids: torch.Tensor,
                layout: ValueLayout) -> torch.Tensor:
    """The per-key pull view [K, 3+D] (show, click, embed_w, embedx) of
    slab[ids], an id taken as JAX's indexing takes it (module docstring):
    the gather_rows kernel on the card."""
    ids = wrap_negative_ids(ids, slab.shape[0])
    return pull_view_from_rows(gather_slab_rows(slab, ids, layout), layout)


def pull_view_grad(ids: torch.Tensor, d_out: torch.Tensor,
                   slab_shape, layout: ValueLayout) -> torch.Tensor:
    """The slab-shaped gradient of the pull view's cotangent d_out
    [K, 3+D]: row i's embed_w gets the sum of d_out[k, 2] and its embedx
    columns the sum of d_out[k, 3:] over the k with ids[k] == i, each sum
    over the occurrences in ascending order from zero; every other entry
    is zero. As JAX's scatter does: an id in [-C, 0) adds to row C + id,
    and an id still outside the slab adds nothing."""
    D = layout.embedx_dim
    xw0 = layout.embedx_w
    d_slab = torch.zeros(tuple(slab_shape), dtype=d_out.dtype,
                         device=d_out.device)
    ids = wrap_negative_ids(ids.to(torch.int64), d_slab.shape[0])
    inside = (ids >= 0) & (ids < d_slab.shape[0])
    if not bool(inside.all()):
        ids, d_out = ids[inside], d_out[inside]
    if ids.numel() == 0:
        return d_slab
    uids, inv = torch.unique(ids, sorted=True, return_inverse=True)
    perm = torch.argsort(inv, stable=True)
    lengths = torch.bincount(inv, minlength=uids.numel())
    merged = torch.segment_reduce(d_out[:, 2:3 + D].index_select(0, perm),
                                  "sum", lengths=lengths, axis=0,
                                  unsafe=True)
    d_slab[uids, acc.EMBED_W] = merged[:, 0]
    d_slab[uids, xw0:xw0 + D] = merged[:, 1:]
    return d_slab


class _PullSparse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, slab, ids, layout):
        ctx.save_for_backward(ids)
        ctx.slab_shape = tuple(slab.shape)
        ctx.layout = layout
        return pull_sparse(slab, ids, layout)

    @staticmethod
    def backward(ctx, d_out):
        (ids,) = ctx.saved_tensors
        return (pull_view_grad(ids, d_out, ctx.slab_shape, ctx.layout),
                None, None)


def pull_sparse_differentiable(slab: torch.Tensor, ids: torch.Tensor,
                               layout: ValueLayout) -> torch.Tensor:
    """pull_sparse whose autograd backward is ``pull_view_grad``: a slab
    gradient, for a model that differentiates through the pull. An f32
    layout only (a slab-shaped f32 gradient of an encoded bf16 slab means
    nothing; the trainers' explicit pull and push take the bf16 slab)."""
    if layout.bf16:
        raise ValueError(
            "pull_sparse_differentiable requires a float32 slab layout; "
            "the bf16 slab diet (slab_embed_dtype) is explicit-path only")
    return _PullSparse.apply(slab, ids, layout)


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
    ids = wrap_negative_ids(ids, slab.shape[0])
    return extended_views_from_rows(gather_slab_rows(slab, ids, layout),
                                    layout)


def extended_views_from_rows(rows: torch.Tensor, layout: ValueLayout):
    """(pull view [K, 3+D], expand embedding [K, E]) of already gathered
    rows: the trainers' staged extended pull."""
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
