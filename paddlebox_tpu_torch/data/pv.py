"""pv (search-session) instance grouping and the rank-offset feed.

Counterpart of paddlebox_tpu/data/pv.py:27-91, numpy only and bit for bit
the reference's. A join-phase model groups a batch's ad instances by search
session (pv) and reads a per-instance rank-offset matrix that says which
peer ads share the pv and where they sit in the batch
(ops/rank_attention.py reads it):

    col 0:      this ad's rank (1..max_rank), or -1 if invalid
    col 2m+1:   rank of the peer with rank m+1 in the same pv (or -1)
    col 2m+2:   batch row of that peer (or -1)

A rank takes part only when its cmatch is a join channel (222 or 223) and
0 < rank <= max_rank.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from paddlebox_tpu_torch.data.slot_record import SlotRecord

JOIN_CMATCH = (222, 223)


def effective_rank(rank: int, cmatch: int, max_rank: int) -> int:
    """``rank`` when it takes part in the join (a join channel, 0 < rank <=
    max_rank), else -1."""
    return rank if cmatch in JOIN_CMATCH and 0 < rank <= max_rank else -1


def preprocess_instance(records: Sequence[SlotRecord],
                        merge_by_sid: bool = True) -> List[List[int]]:
    """Record indices grouped into pvs: sorted by search_id, one pv per
    distinct search_id (one per record when ``merge_by_sid`` is False)."""
    order = sorted(range(len(records)), key=lambda i: records[i].search_id)
    if not merge_by_sid:
        return [[i] for i in order]
    pvs: List[List[int]] = []
    last_sid = None
    for i in order:
        sid = records[i].search_id
        if last_sid is None or sid != last_sid:
            pvs.append([i])
            last_sid = sid
        else:
            pvs[-1].append(i)
    return pvs


def build_rank_offset(ranks: np.ndarray, cmatchs: np.ndarray,
                      pv_offsets: np.ndarray, max_rank: int = 3) -> np.ndarray:
    """The rank-offset matrix [N, 1 + 2 * max_rank] int32 (-1 filled) of
    ``ranks`` and ``cmatchs`` [N] in batch order with each pv contiguous;
    ``pv_offsets`` [P + 1] are the pvs' CSR offsets into the ad axis."""
    n = int(ranks.shape[0])
    mat = np.full((n, 2 * max_rank + 1), -1, dtype=np.int32)
    eff = np.where(
        np.isin(cmatchs, JOIN_CMATCH) & (ranks > 0) & (ranks <= max_rank),
        ranks, -1).astype(np.int32)
    for p in range(len(pv_offsets) - 1):
        lo, hi = int(pv_offsets[p]), int(pv_offsets[p + 1])
        mat[lo:hi, 0] = eff[lo:hi]
        members = [(int(eff[k]), k) for k in range(lo, hi) if eff[k] > 0]
        for j in range(lo, hi):
            if eff[j] <= 0:
                continue
            for fast_rank, k in members:
                m = fast_rank - 1
                mat[j, 2 * m + 1] = ranks[k]
                mat[j, 2 * m + 2] = k
    return mat


def pack_pv_batch(records: Sequence[SlotRecord], pvs: List[List[int]],
                  max_rank: int = 3) -> Tuple[List[int], np.ndarray]:
    """(record order with each pv contiguous, its rank-offset matrix [N,
    1 + 2 * max_rank]) of a batch's records grouped into ``pvs``."""
    order: List[int] = []
    pv_offsets = [0]
    for pv in pvs:
        order.extend(pv)
        pv_offsets.append(len(order))
    ranks = np.array([records[i].rank for i in order], np.int32)
    cmatchs = np.array([records[i].cmatch for i in order], np.int32)
    mat = build_rank_offset(ranks, cmatchs,
                            np.asarray(pv_offsets, np.int64), max_rank)
    return order, mat
