"""Fused per-slot sequence pooling + CVM transform.

Counterpart of paddlebox_tpu/ops/seqpool.py:21-57 and 80-89 (seqpool_sum,
the plain sum pool of the expand block). The packer's segment ids
(instance * num_slots + slot) are nondecreasing, so the pool is a sorted
segment sum: each segment's keys are added in occurrence order, as the JAX
sorted segment_sum does, and without atomics, so the result does not vary
from run to run on the card. CVM columns follow cvm_op.h:
y0 = log(show+1), y1 = log(click+1) - y0.
"""

from __future__ import annotations

import torch


def cvm_transform(pooled: torch.Tensor, use_cvm: bool = True) -> torch.Tensor:
    """[..., 2+E] with cols [show, click, emb...] -> CVM columns, or the E
    embedding columns alone when use_cvm is False."""
    rest = pooled[..., 2:]
    if not use_cvm:
        return rest
    log_show = torch.log(pooled[..., 0:1] + 1.0)
    log_ctr = torch.log(pooled[..., 1:2] + 1.0) - log_show
    return torch.cat([log_show, log_ctr, rest], dim=-1)


def fused_seqpool_cvm(emb: torch.Tensor, segments: torch.Tensor,
                      valid: torch.Tensor, batch_size: int, num_slots: int,
                      n_valid: int, use_cvm: bool = True) -> torch.Tensor:
    """emb [K, 2+E] per-key pull view, segments [K] NONDECREASING,
    valid [K] bool -> [batch_size, num_slots, 2+E] (E without CVM). Empty
    slots pool to zero. Differentiable in emb.

    n_valid: keys from this index on are all padding (the packer's tail,
    pinned to the last segment) and are left out of the sum instead of
    being added as zeros — one sequential run of tens of thousands of
    zeros would otherwise dominate the reduction's time on the card."""
    pooled = seqpool_sum(emb, segments, valid, batch_size, num_slots,
                         n_valid)
    return cvm_transform(pooled, use_cvm)


def seqpool_sum(emb: torch.Tensor, segments: torch.Tensor,
                valid: torch.Tensor, batch_size: int, num_slots: int,
                n_valid: int) -> torch.Tensor:
    """Per-slot sum pooling with no CVM columns (reference ops/seqpool.py:
    80-89), the pool the expand (NN-cross) embedding feeds: emb [K, E],
    segments [K] NONDECREASING, valid [K] bool -> [batch_size, num_slots,
    E], a sorted segment sum as fused_seqpool_cvm's (no atomics; keys from
    ``n_valid`` on, the padding tail, left out). Differentiable in emb."""
    emb, segments, valid = emb[:n_valid], segments[:n_valid], valid[:n_valid]
    masked = torch.where(valid[:, None], emb, torch.zeros_like(emb))
    bounds = torch.arange(batch_size * num_slots + 1, dtype=segments.dtype,
                          device=segments.device)
    offsets = torch.searchsorted(segments, bounds)
    pooled = torch.segment_reduce(masked, "sum", offsets=offsets, axis=0,
                                  unsafe=True)
    return pooled.reshape(batch_size, num_slots, emb.shape[-1])
