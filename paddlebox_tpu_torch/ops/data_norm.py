"""Streaming feature normalization (data_norm).

Counterpart of paddlebox_tpu/ops/data_norm.py:1-122, the reference's
data_norm_op (paddle/fluid/operators/data_norm_op.cc:327-355): each feature
column is normalized by running summaries (BatchSize, BatchSum,
BatchSquareSum), the "summary" dense params of BoxPSWorker
(boxps_worker.cc:89-95):

    mean  = batch_sum / batch_size
    scale = sqrt(batch_size / batch_square_sum)
    y     = (x - mean) * scale

``slot_dim`` > 0 adds the show-skip rule: the columns come in blocks of
slot_dim (the last block cut short), and a row whose block starts with a
show of |show| < 1e-7 gives zeros in that block and adds nothing to its
summaries. ``data_norm_summary_update`` is the running-sums rule with decay
(summary_decay_rate); the masked forms are masked_data_norm_op
(masked_data_norm_op.cu:39-131). All of it is plain elementwise PyTorch on
whatever device the tensors are on.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

_MIN_PRECISION = 1e-7


class DataNormState(NamedTuple):
    """Per-column summaries, [C] float32 each."""

    batch_size: torch.Tensor
    batch_sum: torch.Tensor
    batch_square_sum: torch.Tensor

    @classmethod
    def init(cls, dim: int, init_batch_size: float = 1e4,
             device: Optional[torch.device] = None) -> "DataNormState":
        """The reference's defaults: batch_size and batch_square_sum at
        ``init_batch_size``, batch_sum at zero."""
        return cls(
            batch_size=torch.full((dim,), init_batch_size,
                                  dtype=torch.float32, device=device),
            batch_sum=torch.zeros(dim, dtype=torch.float32, device=device),
            batch_square_sum=torch.full((dim,), init_batch_size,
                                        dtype=torch.float32, device=device))


def _mean_scale(state: DataNormState):
    mean = state.batch_sum / state.batch_size
    return mean, torch.sqrt(state.batch_size / state.batch_square_sum)


def _alive(x: torch.Tensor, slot_dim: int) -> torch.Tensor:
    """[N, C] bool: the column's block has a show of |show| >= 1e-7."""
    C = x.shape[-1]
    block_alive = x[:, 0::slot_dim].abs() >= _MIN_PRECISION
    return torch.repeat_interleave(block_alive, slot_dim, dim=1)[:, :C]


def data_norm(x: torch.Tensor, state: DataNormState,
              slot_dim: int = 0) -> torch.Tensor:
    """x [N, C] -> normalized [N, C]."""
    mean, scale = _mean_scale(state)
    y = (x - mean) * scale
    if slot_dim > 0:
        y = torch.where(_alive(x, slot_dim), y, torch.zeros_like(y))
    return y


def masked_data_norm(x: torch.Tensor, mask: torch.Tensor,
                     state: DataNormState) -> torch.Tensor:
    """Rows with mask True normalized, rows with mask False zeros."""
    mean, scale = _mean_scale(state)
    y = (x - mean) * scale
    keep = mask.reshape(-1).to(torch.bool)[:, None]
    return torch.where(keep, y, torch.zeros_like(y))


def masked_data_norm_stat_update(state: DataNormState, x: torch.Tensor,
                                 mask: torch.Tensor,
                                 decay: float = 0.9999999,
                                 squared_sum_epsilon: float = 1e-4
                                 ) -> DataNormState:
    """Per-column stats over the masked rows only, normalized to a batch
    size of 1; a batch with no masked row leaves the state as it is (no
    decay either)."""
    keep = mask.reshape(-1).to(torch.bool)
    mean = state.batch_sum / state.batch_size
    n = keep.sum()
    cnt = torch.clamp(n, min=1).to(torch.float32)
    k = keep[:, None]
    xs = torch.where(k, x, torch.zeros_like(x))
    sq = torch.where(k, (x - mean) ** 2, torch.zeros_like(x))
    d_size = torch.where(n > 0, 1.0, 0.0).to(torch.float32)
    d_sum = xs.sum(dim=0) / cnt
    d_sq = sq.sum(dim=0) / cnt + squared_sum_epsilon
    some = n > 0
    return DataNormState(
        batch_size=torch.where(some, state.batch_size * decay + d_size,
                               state.batch_size),
        batch_sum=torch.where(some, state.batch_sum * decay + d_sum,
                              state.batch_sum),
        batch_square_sum=torch.where(
            some, state.batch_square_sum * decay + d_sq,
            state.batch_square_sum))


def data_norm_summary_update(state: DataNormState, x: torch.Tensor,
                             decay: float = 0.9999999,
                             slot_dim: int = 0) -> DataNormState:
    """This batch's rows into the running summaries with decay. Without
    slot_dim every row counts (padding rows too: the count is N); with it,
    dead blocks add nothing."""
    mean = state.batch_sum / state.batch_size
    sq = (x - mean) ** 2
    if slot_dim > 0:
        alive = _alive(x, slot_dim)
        cnt = alive.sum(dim=0).to(torch.float32)
        xs = torch.where(alive, x, torch.zeros_like(x))
        sq = torch.where(alive, sq, torch.zeros_like(sq))
    else:
        cnt = torch.full((x.shape[-1],), float(x.shape[0]),
                         dtype=torch.float32, device=x.device)
        xs = x
    return DataNormState(
        batch_size=state.batch_size * decay + cnt,
        batch_sum=state.batch_sum * decay + xs.sum(dim=0),
        batch_square_sum=state.batch_square_sum * decay + sq.sum(dim=0))
