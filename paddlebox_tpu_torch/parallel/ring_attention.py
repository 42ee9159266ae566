"""Ring and Ulysses attention at one shard.

Counterpart of paddlebox_tpu/parallel/ring_attention.py. With the sequence
on one card the ring is one flash-style block update (``_block_attn_update``,
the reference's :29-52, its guard of fully masked rows included, so a
causal or empty row gives 0, never NaN) and the ``l > 0`` normalisation
(:52-89); Ulysses is the plain softmax form (:92-122) with no all_to_all.
The attention stays explicit einsum and softmax in the reference's order of
operations: it is no kernel of the reference, and BST's masking feeds zero
tokens, not a key mask. An ``n_shards`` other than 1 raises: the ring's
ppermute and Ulysses' all_to_all across cards are ROADMAP A10.

q, k, v: [B, T, H, Dh]; the result has q's shape.
"""

from __future__ import annotations

from typing import Optional

import torch


def check_one_shard(n_shards: int) -> None:
    if n_shards != 1:
        raise NotImplementedError(
            "sequence parallelism over %d shards waits for the port's "
            "multi-GPU slice (ROADMAP A10); the port runs n_shards=1"
            % n_shards)


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


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   n_shards: int = 1, causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Blockwise attention at one shard: one block update from the empty
    state (m = -inf, l = 0, o = 0), then o / l where l > 0."""
    check_one_shard(n_shards)
    B, T, H, Dh = q.shape
    scale = scale if scale is not None else 1.0 / (Dh ** 0.5)
    pos = torch.arange(T, device=q.device)
    m0 = torch.full((B, H, T), -torch.inf, dtype=q.dtype, device=q.device)
    l0 = torch.zeros((B, H, T), dtype=q.dtype, device=q.device)
    _, l, o = _block_attn_update(q, k, v, m0, l0, torch.zeros_like(q), pos,
                                 pos, causal, scale)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    return o / l_safe[..., None].transpose(1, 2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      n_shards: int = 1, causal: bool = False,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Full-sequence softmax attention on every head (Ulysses' form with
    the heads all on one shard)."""
    check_one_shard(n_shards)
    T, Dh = q.shape[1], q.shape[3]
    scale = scale if scale is not None else 1.0 / (Dh ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        pos = torch.arange(T, device=q.device)
        s = torch.where(pos[None, None, :, None] >= pos[None, None, None, :],
                        s, torch.full_like(s, -torch.inf))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
