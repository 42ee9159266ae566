"""The sparse push of the train step: one fused kernel, then the slab write.

Counterpart of paddlebox_tpu/embedding/optimizers.py:275-345 (the host-dedup
push, ``push_sparse_hostdedup`` with ``_merged_new_rows``), 381-458
(``push_blocked_write``), 244-263 (``push_sparse_dedup``, the ids-only
wire), 348-358 (``decode_delta_uids``) and 461-563 (``push_sparse_uidwire``
and ``push_sparse_rebuild``). The merge, the row read, the in-table update and
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

Three writes: 'scatter' (the kernel writes each row at its uid),
'blocked' (the kernel returns the rows, ``blocked_write`` places them by
row blocks) and 'rebuild' (the kernel returns the rows, the gather_rows
kernel spreads them over the whole slab by a [capacity] position map, and
one torch.where keeps the other rows: the reference's jnp.take and
jnp.where). The wires that ship less than the host's dedup derive the
rest on the device (``device_push_maps``): the same perm and offsets as
``dedup_ids`` and ``segment_offsets``, so every wire's push sums each
unique's occurrences in the same order and writes the same bits.
"""

from __future__ import annotations

import torch

from paddlebox_tpu_torch.config.configs import SparseOptimizerConfig
from paddlebox_tpu_torch.embedding.accessor import ValueLayout
from paddlebox_tpu_torch.embedding.push_kernels import (blocked_write,
                                                        push_adagrad)
from paddlebox_tpu_torch.ops.row_kernels import gather_rows


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
    (the kernel returns the rows, the blocked_write kernel places them);
    'rebuild' goes through push_sparse_rebuild with its position map."""
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


def push_sparse_rebuild(slab: torch.Tensor, uids: torch.Tensor,
                        pos: torch.Tensor, perm: torch.Tensor,
                        offsets: torch.Tensor, n_uniq: int,
                        grads: torch.Tensor, seed: int, layout: ValueLayout,
                        conf: SparseOptimizerConfig) -> None:
    """push_sparse_hostdedup with the row scatter replaced by the rebuild
    write, IN PLACE (reference optimizers.py:528-563): one push_adagrad
    launch with rows out ([n_uniq, device width], the slab's encoding),
    then slab[r] = new_rows[pos[r]] where pos[r] >= 0 and slab[r]
    elsewhere, by ``pos`` ([capacity] int32, -1 where no uid names the
    row: pass_table.pos_for_rebuild). The rows are spread over the slab
    by the gather_rows kernel (f32, or the 2-byte form on the bf16 slab's
    int16 rows) at pos clamped into new_rows, then one torch.where keeps
    the untouched rows. The same bits as 'scatter'."""
    if n_uniq == 0:
        return
    new_rows = push_adagrad(slab, grads, perm, offsets, uids, n_uniq, seed,
                            layout, conf, rows_out=True)
    sel = gather_rows(new_rows, pos.clamp(0, n_uniq - 1))
    torch.where((pos >= 0)[:, None], sel, slab, out=slab)


def device_push_maps(inv: torch.Tensor, n_valid: int):
    """(perm, offsets) int32 of each occurrence's unique index ``inv``
    [K] on the device: perm the stable argsort of inv (occurrences grouped
    by unique, ascending within each: dedup_ids' perm), offsets [K+1] each
    unique's run among the first n_valid sorted occurrences (the real
    keys; the padding slots address the trash row, the largest id, and
    sort last: segment_offsets)."""
    K = inv.shape[0]
    perm = torch.argsort(inv, stable=True).to(torch.int32)
    live = inv.index_select(0, perm)[:n_valid].contiguous()
    offsets = torch.searchsorted(
        live, torch.arange(K + 1, dtype=inv.dtype, device=inv.device),
        out_int32=True)
    return perm, offsets


def rebuild_pos(uids: torch.Tensor, n_uniq: int,
                capacity: int) -> torch.Tensor:
    """pos_for_rebuild on the device: [capacity] int32, pos[uids[j]] = j
    for the first n_uniq uids, -1 elsewhere."""
    pos = torch.full((capacity,), -1, dtype=torch.int32, device=uids.device)
    pos[uids[:n_uniq].to(torch.int64)] = torch.arange(
        n_uniq, dtype=torch.int32, device=uids.device)
    return pos


def decode_delta_uids(base: int, d16: torch.Tensor, cut: int,
                      capacity: int) -> torch.Tensor:
    """The sorted uid vector of the delta wire (pass_table.
    delta_encode_uids): base + cumsum(d16)[i] below ``cut``, and
    (capacity - 1) + (i - cut) from cut on. int32 [K] on d16's device."""
    i = torch.arange(d16.shape[0], dtype=torch.int32, device=d16.device)
    dec = int(base) + torch.cumsum(d16.to(torch.int32), 0,
                                   dtype=torch.int32)
    return torch.where(i >= int(cut), (capacity - 1) + (i - int(cut)), dec)


def push_sparse_uidwire(slab: torch.Tensor, uids: torch.Tensor,
                        ids: torch.Tensor, n_valid: int, n_uniq: int,
                        grads: torch.Tensor, seed: int, layout: ValueLayout,
                        conf: SparseOptimizerConfig, write: str = "scatter",
                        block_rows: int = 1024) -> None:
    """The uid wire's push, IN PLACE (reference optimizers.py:461-526):
    the host shipped only the sorted uid vector ``uids`` [K] (padding tail
    out of the slab) and the push's n_uniq; each occurrence's unique is
    found by a binary search of its id ``ids`` [K] in uids, then
    device_push_maps gives the host's perm and offsets, and the fused
    push writes by ``write``: 'scatter', 'rebuild' (the position map made
    on the device) or 'blocked' (over the first n_uniq uids, so that a
    delta wire's decoded trash id, which no occurrence names, is never
    placed)."""
    inv = torch.searchsorted(uids, ids, out_int32=True)
    perm, offsets = device_push_maps(inv, n_valid)
    if write == "scatter":
        push_adagrad(slab, grads, perm, offsets, uids, n_uniq, seed, layout,
                     conf)
    elif write == "rebuild":
        push_sparse_rebuild(slab, uids, rebuild_pos(uids, n_uniq,
                                                    slab.shape[0]),
                            perm, offsets, n_uniq, grads, seed, layout, conf)
    elif write == "blocked":
        new_rows = push_adagrad(slab, grads, perm, offsets, uids, n_uniq,
                                seed, layout, conf, rows_out=True)
        push_blocked_write(slab, uids[:n_uniq], new_rows, block_rows)
    else:
        raise ValueError("uid-wire write %r (scatter, rebuild or blocked)"
                         % (write,))


def push_sparse_dedup(slab: torch.Tensor, ids: torch.Tensor, n_valid: int,
                      grads: torch.Tensor, seed: int, layout: ValueLayout,
                      conf: SparseOptimizerConfig) -> None:
    """The ids-only wire's push, IN PLACE (reference optimizers.py:
    244-263): the batch's dedup runs on the device. torch.unique (sorted,
    with the inverse) gives the uniques, the trash row among them when the
    batch has padding, as dedup_ids counts it; padded with capacity + i to
    [K] as dedup_ids pads, they and device_push_maps feed the same fused
    push by 'scatter'. Its n_uniq, which sets the push's grid, is the
    length of torch.unique's output: on the card that costs the one
    device-to-host wait a step that torch.unique makes to size it."""
    K = ids.shape[0]
    uniq, inv = torch.unique(ids, sorted=True, return_inverse=True)
    n_uniq = int(uniq.shape[0])
    uids = torch.cat([uniq.to(torch.int32),
                      slab.shape[0] + torch.arange(K - n_uniq,
                                                   dtype=torch.int32,
                                                   device=ids.device)])
    perm, offsets = device_push_maps(inv.to(torch.int32), n_valid)
    push_adagrad(slab, grads, perm, offsets, uids, n_uniq, seed, layout,
                 conf)
