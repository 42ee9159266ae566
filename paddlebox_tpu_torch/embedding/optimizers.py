"""The sparse push of the train step: one fused kernel, then the slab write.

Counterpart of paddlebox_tpu/embedding/optimizers.py:275-345 (the host-dedup
push, ``push_sparse_hostdedup`` with ``_merged_new_rows``) and 381-458
(``push_blocked_write``). The merge, the row read, the in-table update and
the scatter run as one ``push_adagrad`` kernel launch over the batch's real
uniques, for every rule of the table's layout (adagrad, adam, adam_shared,
naive, with or without the expand block); the port follows the Pallas
kernel's semantics (``use_pallas_push``: its creation hash and
updated-slot learning rate), not ``apply_push``'s threefry creation
draws.

The slab is updated IN PLACE (the JAX step donates it). Padding uids
(capacity + i) never reach a write: the push runs over the first
``n_uniq`` uids only, and the blocked bucketize sends padding to a dropped
entry.
"""

from __future__ import annotations

import torch

from paddlebox_tpu_torch.config.configs import SparseOptimizerConfig
from paddlebox_tpu_torch.embedding.accessor import ValueLayout
from paddlebox_tpu_torch.embedding.push_kernels import (blocked_write,
                                                        push_adagrad)


def push_sparse_hostdedup(slab: torch.Tensor, uids: torch.Tensor,
                          perm: torch.Tensor, offsets: torch.Tensor,
                          n_uniq: int, grads: torch.Tensor, seed: int,
                          layout: ValueLayout, conf: SparseOptimizerConfig,
                          write: str = "scatter",
                          block_rows: int = 1024) -> None:
    """Push with the host dedup products (pass_table.dedup_ids and
    segment_offsets), IN PLACE.

    uids [K] int32 strictly ascending, the first n_uniq real; perm [K]
    int32; offsets [K+1] int32 segment offsets into perm over the real
    occurrences; grads [K, 4+D+E] per-occurrence push rows (padding rows
    all zero), E the layout's expand width. Each unique's row is read from the slab itself: nothing writes
    the slab between the step's pull and its push.
    write: 'scatter' (the kernel writes each row at its uid) or 'blocked'
    (the kernel returns the rows, the blocked_write kernel places them)."""
    if write == "scatter":
        push_adagrad(slab, grads, perm, offsets, uids, n_uniq, seed, layout,
                     conf)
    elif write == "blocked":
        new_rows = push_adagrad(slab, grads, perm, offsets, uids, n_uniq,
                                seed, layout, conf, rows_out=True)
        push_blocked_write(slab, uids, new_rows, block_rows)
    else:
        raise ValueError("push write %r (scatter or blocked)" % (write,))


def blocked_layout(uids: torch.Tensor, capacity: int, block_rows: int):
    """Bucketize STRICTLY ASCENDING uids (padding tail >= capacity) into
    touched row blocks, as the JAX push_blocked_write does on device:
    returns (row_map [NB, B] int32, blk_idx [NB] int32) with NB =
    min(U, capacity // B); row_map[i, r] is the new_rows index placed at
    row r of block blk_idx[i], -1 where the block keeps its bits. Slots fed
    only by padding uids keep row_map -1 and a block id clamped onto the
    last block. Only in-range uids are placed, so with n_uniq real uids
    every row_map value is below n_uniq (new_rows may hold just those)."""
    B = int(block_rows)
    if B <= 0 or capacity % B:
        raise ValueError("push_blocked_write: block_rows=%d must be positive "
                         "and divide the slab capacity %d" % (B, capacity))
    U = uids.shape[0]
    dev = uids.device
    n_blocks = capacity // B
    NB = min(U, n_blocks)
    u = uids.to(torch.int64)
    blk = u // B
    in_range = u < capacity
    is_first = torch.ones(U, dtype=torch.bool, device=dev)
    is_first[1:] = blk[1:] != blk[:-1]
    slot = torch.cumsum(is_first, 0) - 1
    # slot NB and the flat entry NB*B are spares that collect the writes the
    # JAX version drops (mode="drop"); they are cut off below
    blk_of_slot = torch.full((NB + 1,), n_blocks, dtype=torch.int64,
                             device=dev)
    blk_of_slot[slot.clamp(max=NB)] = torch.where(
        in_range, blk, torch.full_like(blk, n_blocks))
    tgt = torch.where(in_range, slot * B + (u - blk * B),
                      torch.full_like(u, NB * B))
    row_map = torch.full((NB * B + 1,), -1, dtype=torch.int32, device=dev)
    row_map[tgt] = torch.arange(U, dtype=torch.int32, device=dev)
    row_map = row_map[:NB * B].view(NB, B)
    blk_idx = blk_of_slot[:NB].clamp(max=n_blocks - 1).to(torch.int32)
    return row_map, blk_idx


def push_blocked_write(slab: torch.Tensor, uids: torch.Tensor,
                       new_rows: torch.Tensor, block_rows: int) -> None:
    """Blocked slab write, IN PLACE: bucketize the sorted uids into touched
    blocks, then the blocked-write kernel places each touched lane's row."""
    if uids.shape[0] == 0:
        return
    row_map, blk_idx = blocked_layout(uids, slab.shape[0], block_rows)
    blocked_write(slab, new_rows, row_map, blk_idx)
