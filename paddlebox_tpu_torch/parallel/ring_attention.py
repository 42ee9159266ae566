"""Sequence parallelism: ring attention and Ulysses over a process group.

Counterpart of paddlebox_tpu/parallel/ring_attention.py. Each rank of the
``sp`` group holds T/P positions of q, k and v [B, T/P, H, Dh]; the result
has q's shape, this rank's positions.

  ring_attention     P block updates (``_block_attn_update``, the
                     reference's :29-52 with its guard of fully masked
                     rows, so a causal or empty row gives 0, never NaN) in
                     the reference's order: the rank's own K/V block
                     first, then each hop's, the K/V block passed to rank
                     + 1 and taken from rank - 1 between updates, then the
                     ``l > 0`` normalisation (:55-89). A hop is
                     ``_RingHop``, an autograd Function whose forward posts
                     the K and V sends and receives as one
                     dist.batch_isend_irecv and waits for them before the
                     next update, and whose backward passes the gradients
                     the other way (rank + 1 to rank): the transpose of
                     the reference's ppermute. The hops chain, so the
                     backward runs them in the reverse order on every rank
                     and the pairs match.
  ulysses_attention  all-to-all from sequence to heads, full-sequence
                     softmax attention on H/P heads, all-to-all back
                     (:92-122), by torch.distributed.nn.functional.
                     all_to_all_single (its backward is the reverse
                     all-to-all); H % P raises.

A group of one (or no process group: ``group=None`` outside
torch.distributed) makes no point-to-point call and no all-to-all: the
ring is one block update from the empty state, Ulysses the plain softmax
attention. The attention stays explicit einsum and softmax in the
reference's order of operations: it is no kernel of the reference.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch
import torch.distributed as dist

from paddlebox_tpu_torch.parallel.tensor_parallel import (group_rank,
                                                          group_size)


def _block_attn_update(q, k, v, m, l, o, k_pos, q_pos, causal: bool,
                       scale: float):
    """One flash-attention accumulation step against a K/V block.

    q: [B, Tq, H, Dh]; k, v: [B, Tk, H, Dh]; m, l: [B, H, Tq]; o like q.
    Returns (m, l, o) updated."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = None
    if causal:
        mask = q_pos[None, None, :, None] >= k_pos[None, None, None, :]
        s = torch.where(mask, s, torch.full_like(s, -torch.inf))
    m_new = torch.maximum(m, s.amax(dim=-1))
    # a fully masked row (m_new = -inf): exp(-inf - -inf) would be NaN
    m_safe = torch.where(torch.isfinite(m_new), m_new,
                         torch.zeros_like(m_new))
    p = torch.exp(s - m_safe[..., None])
    if causal:
        p = torch.where(mask, p, torch.zeros_like(p))
    corr = torch.exp(torch.where(torch.isfinite(m), m - m_safe,
                                 torch.full_like(m, -torch.inf)))
    corr = torch.where(torch.isfinite(corr), corr, torch.zeros_like(corr))
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None].transpose(1, 2) + torch.einsum(
        "bhqk,bkhd->bqhd", p, v)
    return m_new, l_new, o_new


def _shift(group, send_to: int, recv_from: int, *tensors):
    """Send each tensor to group rank ``send_to`` and receive one of its
    shape from ``recv_from``: one batch of point-to-point ops, waited
    for. Returns the received tensors."""
    g = group if group is not None else dist.group.WORLD
    dst = dist.get_global_rank(g, send_to)
    src = dist.get_global_rank(g, recv_from)
    out = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
           for t in tensors]
    ops = []
    for i, (t, r) in enumerate(zip(tensors, out)):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), dst, g, tag=i))
        ops.append(dist.P2POp(dist.irecv, r, src, g, tag=i))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingHop(torch.autograd.Function):
    """One ring hop of (k, v): to rank + 1, from rank - 1; the backward
    sends the gradients to rank - 1 and takes them from rank + 1."""

    @staticmethod
    def forward(ctx, group, k, v):
        ctx.group = group
        P, idx = group_size(group), group_rank(group)
        ctx.peers = ((idx - 1) % P, (idx + 1) % P)
        return tuple(_shift(group, (idx + 1) % P, (idx - 1) % P, k, v))

    @staticmethod
    def backward(ctx, gk, gv):
        to, frm = ctx.peers
        gk, gv = _shift(ctx.group, to, frm, gk, gv)
        return None, gk, gv


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group=None, causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Blockwise ring attention over the sequence split across ``group``
    (None: the world, or one shard without a process group)."""
    P, idx = group_size(group), group_rank(group)
    B, T, H, Dh = q.shape
    scale = scale if scale is not None else 1.0 / (Dh ** 0.5)
    ar = torch.arange(T, device=q.device)
    q_pos = idx * T + ar
    m = torch.full((B, H, T), -torch.inf, dtype=q.dtype, device=q.device)
    l = torch.zeros((B, H, T), dtype=q.dtype, device=q.device)
    o = torch.zeros_like(q)
    kb, vb = k, v
    for step in range(P):
        src = (idx - step) % P   # whose block this rank holds now
        m, l, o = _block_attn_update(q, kb, vb, m, l, o, src * T + ar,
                                     q_pos, causal, scale)
        if step + 1 < P:
            kb, vb = _RingHop.apply(group, kb, vb)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    return o / l_safe[..., None].transpose(1, 2)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """all_to_all_single of ``x`` [P, ...] over ``group`` with autograd:
    block j goes to rank j, block j of the result came from rank j."""
    from torch.distributed.nn import functional as dnn
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    with warnings.catch_warnings():
        # deprecated in favour of functional collectives, which carry no
        # autograd
        warnings.simplefilter("ignore", FutureWarning)
        return dnn.all_to_all_single(
            out, x.contiguous(),
            group=group if group is not None else dist.group.WORLD)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group=None, causal: bool = False,
                      scale: Optional[float] = None) -> torch.Tensor:
    """All-to-all (DeepSpeed-Ulysses) attention: sequence to heads, the
    full sequence's softmax attention on this rank's H/P heads, heads back
    to sequence. H must divide by the group's size."""
    P = group_size(group)
    B, T, H, Dh = q.shape
    if H % P:
        raise ValueError("heads %d not divisible by axis size %d" % (H, P))
    Hp = H // P

    def seq2head(x):  # [B, T, H, Dh] -> [B, T * P, H / P, Dh]
        if P == 1:
            return x
        x = x.reshape(B, T, P, Hp, Dh).permute(2, 0, 1, 3, 4)
        return _all_to_all(x, group).permute(1, 0, 2, 3, 4).reshape(
            B, P * T, Hp, Dh)

    def head2seq(x):  # the inverse
        if P == 1:
            return x
        x = x.reshape(B, P, T, Hp, Dh).permute(1, 0, 2, 3, 4)
        return _all_to_all(x, group).permute(1, 2, 0, 3, 4).reshape(
            B, T, H, Dh)

    qg, kg, vg = seq2head(q), seq2head(k), seq2head(v)
    Tg = qg.shape[1]
    scale = scale if scale is not None else 1.0 / (Dh ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", qg, kg) * scale
    if causal:
        pos = torch.arange(Tg, device=q.device)
        s = torch.where(pos[None, None, :, None] >= pos[None, None, None, :],
                        s, torch.full_like(s, -torch.inf))
    p = torch.softmax(s, dim=-1)
    return head2seq(torch.einsum("bhqk,bkhd->bqhd", p, vg))
