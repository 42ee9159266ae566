"""Fused per-slot sequence pooling + CVM transform.

Counterpart of paddlebox_tpu/ops/seqpool.py:21-57 and 80-89 (seqpool_sum,
the plain sum pool of the expand block), and of its variants at :60-77 and
:92-205 (cvm_conv_transform, fused_seqpool_cvm_with_conv, _with_credit,
_tradew, _with_diff_thres and _with_pcoc: the counter layouts of the
reference's other fused_seqpool_cvm ops). The variants take the reference's
arguments and pool every key slot, the padding tail masked, after checking
that the segments are nondecreasing: the reference's unsorted segment sum
takes any order, a sorted one would mis-sum silently, so an unsorted vector
raises instead (the packers' segments always pass). The packer's segment ids
(instance * num_slots + slot) are nondecreasing, so the pool is a sorted
segment sum: each segment's keys are added in occurrence order, as the JAX
sorted segment_sum does, and without atomics, so the result does not vary
from run to run on the card. CVM columns follow cvm_op.h:
y0 = log(show+1), y1 = log(click+1) - y0.
"""

from __future__ import annotations

from typing import Optional

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
                      use_cvm: bool = True, pad_empty_zero: bool = True,
                      sorted_segments: bool = False,
                      n_valid: Optional[int] = None) -> torch.Tensor:
    """emb [K, 2+E] per-key pull view, segments [K] = instance * num_slots
    + slot, valid [K] bool -> [batch_size, num_slots, 2+E] (E without
    CVM), the reference's arguments in its order. Empty slots pool to
    zero, whatever ``pad_empty_zero`` says (as in the reference, which
    reads it nowhere). Differentiable in emb.

    ``sorted_segments`` (the packers' segments, and every trainer's call):
    the segments are nondecreasing and the pool is the sorted segment sum
    as it is. Otherwise the keys are first put in segment order, stably,
    so each segment still sums its keys in occurrence order.

    n_valid: keys from this index on are all padding (the packer's tail,
    pinned to the last segment) and are left out of the sum instead of
    being added as zeros — one sequential run of tens of thousands of
    zeros would otherwise dominate the reduction's time on the card.
    None: every key."""
    if n_valid is None:
        n_valid = emb.shape[0]
    if not sorted_segments:
        emb, segments, valid = (emb[:n_valid], segments[:n_valid],
                                valid[:n_valid])
        order = torch.argsort(segments, stable=True)
        emb, segments, valid = emb[order], segments[order], valid[order]
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


def check_sorted_segments(segments: torch.Tensor) -> None:
    """Raise ValueError unless ``segments`` is nondecreasing (a host sync
    on the card)."""
    if segments.numel() > 1 and bool((segments[1:] < segments[:-1]).any()):
        raise ValueError("segments must be nondecreasing (the packer's "
                         "instance * num_slots + slot order); the sorted "
                         "segment sum would mis-sum an unsorted vector")


def _segpool(emb: torch.Tensor, segments: torch.Tensor, keep: torch.Tensor,
             batch_size: int, num_slots: int) -> torch.Tensor:
    """The variants' pool (reference seqpool.py:114-122): the sum of each
    segment's kept keys, [batch_size, num_slots, width]."""
    check_sorted_segments(segments)
    return seqpool_sum(emb, segments, keep, batch_size, num_slots,
                       emb.shape[0])


def cvm_conv_transform(pooled: torch.Tensor, use_cvm: bool = True,
                       show_filter: bool = False) -> torch.Tensor:
    """Conv counters [show, click, conv, emb...] -> [log(show+1),
    log(click+1), log(conv+1) - log(click+1), emb...]; show_filter drops
    the first column, use_cvm=False all three (reference seqpool.py:
    60-77)."""
    rest = pooled[..., 3:]
    if not use_cvm:
        return rest
    log_show = torch.log(pooled[..., 0:1] + 1.0)
    log_click = torch.log(pooled[..., 1:2] + 1.0)
    log_convr = torch.log(pooled[..., 2:3] + 1.0) - log_click
    cols = ([log_click, log_convr] if show_filter
            else [log_show, log_click, log_convr])
    return torch.cat(cols + [rest], dim=-1)


def _show_click_score(emb: torch.Tensor, show_coeff: float,
                      clk_coeff: float) -> torch.Tensor:
    show, click = emb[:, 0], emb[:, 1]
    return (show - click) * show_coeff + click * clk_coeff


def fused_seqpool_cvm_with_conv(
        emb: torch.Tensor, segments: torch.Tensor, valid: torch.Tensor,
        batch_size: int, num_slots: int, use_cvm: bool = True,
        need_filter: bool = False, show_coeff: float = 0.2,
        clk_coeff: float = 1.0, threshold: float = 0.96,
        show_filter: bool = False) -> torch.Tensor:
    """Per-key [show, click, conv, emb...]; need_filter drops the keys
    whose (show - click) * show_coeff + click * clk_coeff is under
    ``threshold`` before the pool (reference seqpool.py:92-111)."""
    keep = valid
    if need_filter:
        keep = keep & (_show_click_score(emb, show_coeff, clk_coeff)
                       >= threshold)
    pooled = _segpool(emb, segments, keep, batch_size, num_slots)
    return cvm_conv_transform(pooled, use_cvm, show_filter)


def fused_seqpool_cvm_with_credit(
        emb: torch.Tensor, segments: torch.Tensor, valid: torch.Tensor,
        batch_size: int, num_slots: int, use_cvm: bool = True,
        show_filter: bool = False) -> torch.Tensor:
    """Per-key [show, click, conv, credit, emb...]; each counter becomes
    log(x+1), show_filter drops the show column, use_cvm=False all four
    (reference seqpool.py:125-140)."""
    pooled = _segpool(emb, segments, valid, batch_size, num_slots)
    if not use_cvm:
        return pooled[..., 4:]
    counters = torch.log(pooled[..., :4] + 1.0)
    if show_filter:
        counters = counters[..., 1:]
    return torch.cat([counters, pooled[..., 4:]], dim=-1)


def fused_seqpool_cvm_tradew(
        emb: torch.Tensor, segments: torch.Tensor, valid: torch.Tensor,
        batch_size: int, num_slots: int, trade_num: int,
        trade_id: Optional[int] = None, use_cvm: bool = True
        ) -> torch.Tensor:
    """Per-key [show, click, trade_w[trade_num], emb...]: the embedding
    part weighted by trade ``trade_id``'s column before the pool (no
    weight without one), the trade block dropped, then the CVM transform
    (reference seqpool.py:143-160)."""
    emb_part = emb[:, 2 + trade_num:]
    if trade_id is not None:
        emb_part = emb_part * emb[:, 2 + trade_id:3 + trade_id]
    pooled = _segpool(torch.cat([emb[:, :2], emb_part], dim=1), segments,
                      valid, batch_size, num_slots)
    return cvm_transform(pooled, use_cvm)


def fused_seqpool_cvm_with_diff_thres(
        emb: torch.Tensor, segments: torch.Tensor, valid: torch.Tensor,
        slots: torch.Tensor, batch_size: int, num_slots: int,
        slot_thresholds, use_cvm: bool = True,
        show_coeff: float = 0.2, clk_coeff: float = 1.0,
        xbox_diff_thres_filter: bool = True,
        threshold: float = 0.96) -> torch.Tensor:
    """The base op with a per-slot filter: keys whose show/click score is
    under slot_thresholds[slot] (the scalar ``threshold`` when
    xbox_diff_thres_filter is False) are dropped before the pool
    (reference seqpool.py:163-180). ``slots`` [K] is each key's slot
    ordinal."""
    score = _show_click_score(emb, show_coeff, clk_coeff)
    if xbox_diff_thres_filter:
        thres = torch.as_tensor(slot_thresholds, dtype=emb.dtype,
                                device=emb.device)[slots.long()]
    else:
        thres = threshold
    keep = valid & (score >= thres)
    pooled = _segpool(emb, segments, keep, batch_size, num_slots)
    return cvm_transform(pooled, use_cvm)


def fused_seqpool_cvm_with_pcoc(
        emb: torch.Tensor, segments: torch.Tensor, valid: torch.Tensor,
        batch_size: int, num_slots: int, pclk_num: int,
        use_cvm: bool = True) -> torch.Tensor:
    """Per-key [show, click, show2, clk2, pclk_1..pclk_n, emb...] ->
    [log(show+1), log(click+1) - log(show+1), (log(pclk_i+1) -
    log(show2+1))_i, (log(pclk_i+1) - log(clk2+1))_i, emb...];
    use_cvm=False drops every counter (reference seqpool.py:183-205)."""
    used = 4 + pclk_num
    pooled = _segpool(emb, segments, valid, batch_size, num_slots)
    if not use_cvm:
        return pooled[..., used:]
    log1p = torch.log(pooled[..., :used] + 1.0)
    log_show, log_click = log1p[..., 0:1], log1p[..., 1:2]
    log_show2, log_clk2 = log1p[..., 2:3], log1p[..., 3:4]
    log_pclk = log1p[..., 4:used]
    return torch.cat([log_show, log_click - log_show, log_pclk - log_show2,
                      log_pclk - log_clk2, pooled[..., used:]], dim=-1)
