"""Pass-lifecycle sparse table on one device.

Counterpart of paddlebox_tpu/embedding/pass_table.py (the full-build path):

  begin_feed_pass / add_keys / end_feed_pass  collect the pass key set and
        give each key a dense pass-local id (its rank in the sorted-unique
        key array)
  begin_pass   host rows -> one [capacity, width] f32 slab on the device
  lookup_ids   keys -> ids (numpy searchsorted); padding -> trash row
  dedup_for_push  the per-batch sorted dedup the push consumes (with
        segment_offsets, its runs over the real occurrences)
  end_pass     slab rows [0, n) -> host store

The last slab row (capacity-1) is the trash row that padding key slots
address; it never reaches the host store. The train step updates the slab
IN PLACE (the JAX step donates it, trainer.py:715-742): there is one live
slab per pass. The incremental (resident) pass and the native route index
wait for a later slice.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from paddlebox_tpu_torch.config.configs import TableConfig
from paddlebox_tpu_torch.device import DeviceLike, resolve_device
from paddlebox_tpu_torch.embedding.accessor import PushLayout, ValueLayout
from paddlebox_tpu_torch.embedding.host_store import HostEmbeddingStore


def dedup_ids(ids: np.ndarray, pad_base: int):
    """Host per-batch dedup (the numpy argsort tier of the JAX dedup_ids,
    pass_table.py:128-189), so uids always come back STRICTLY ASCENDING —
    the blocked write relies on that.

    Returns int32 [K] arrays (uids, perm, inv) and n_uniq:
      uids  unique ids, tail padded with pad_base+i (out of the slab)
      perm  occurrence indices grouped by unique id, ascending within each
      inv   merged-row index per permuted occurrence (nondecreasing)
      n_uniq  how many leading uids are real ids."""
    raw = np.asarray(ids)
    ids = np.ascontiguousarray(raw, dtype=np.int32)
    K = ids.shape[0]
    if K and (ids.min() < 0 or (raw.dtype != np.int32 and
                                np.uint64(raw.max()) > np.uint64(2**31 - 1))):
        raise ValueError("dedup_ids expects nonnegative int32 pass-local "
                         "ids, got range [%s, %s]" % (raw.min(), raw.max()))
    perm = np.argsort(ids, kind="stable").astype(np.int32)
    sorted_ids = ids[perm]
    newseg = np.empty(K, dtype=bool)
    if K:
        newseg[0] = True
        np.not_equal(sorted_ids[1:], sorted_ids[:-1], out=newseg[1:])
    inv = np.cumsum(newseg, dtype=np.int32) - 1
    real = sorted_ids[newseg]
    n_uniq = int(real.shape[0])
    uids = np.empty(K, dtype=np.int32)
    uids[:n_uniq] = real
    uids[n_uniq:] = pad_base + np.arange(K - n_uniq, dtype=np.int32)
    return uids, perm, inv, n_uniq


def segment_offsets(inv: np.ndarray, n_valid: int) -> np.ndarray:
    """[K+1] int32 offsets of each unique's run among the first n_valid
    sorted occurrences: unique j's real occurrences are perm[offsets[j]:
    offsets[j+1]], i.e. offsets = searchsorted(inv[:n_valid], arange(K+1)).

    The padding key slots all address the trash row, the largest id, so
    they sort last: the first n_valid sorted occurrences are the real keys
    and cover uniques 0..m-1. Each run starts where inv steps (the walk
    dedup_ids made); the trash row and the padding tail get empty runs at
    n_valid, so the push merges them to zero rows."""
    K = inv.shape[0]
    offsets = np.full(K + 1, n_valid, np.int32)
    if n_valid:
        live = inv[:n_valid]
        newseg = np.empty(n_valid, bool)
        newseg[0] = True
        np.not_equal(live[1:], live[:-1], out=newseg[1:])
        starts = np.flatnonzero(newseg)
        offsets[:starts.shape[0]] = starts
    return offsets


class PassTable:
    """Single-device sparse table with the BoxPS pass lifecycle."""

    def __init__(self, table: TableConfig, seed: int = 0,
                 device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.config = table
        self.layout = ValueLayout(table.embedx_dim,
                                  table.optimizer.optimizer)
        self.push_layout = PushLayout(table.embedx_dim)
        self.store = HostEmbeddingStore(self.layout, table, seed)
        self.capacity = int(table.pass_capacity)
        self._feed_keys: List[np.ndarray] = []
        self._pass_keys: Optional[np.ndarray] = None
        self._slab: Optional[torch.Tensor] = None
        self._in_feed_pass = False
        self._in_pass = False

    # ------------------------------------------------------- pass lifecycle
    def begin_feed_pass(self) -> None:
        if self._in_feed_pass:
            raise RuntimeError("feed pass already open")
        self._feed_keys = []
        self._in_feed_pass = True

    def add_keys(self, keys: np.ndarray) -> None:
        if not self._in_feed_pass:
            raise RuntimeError("add_keys outside feed pass")
        self._feed_keys.append(np.asarray(keys, dtype=np.uint64))

    def end_feed_pass(self) -> None:
        """Freeze the pass key set; ids are positions in its sorted-unique
        array."""
        if not self._in_feed_pass:
            raise RuntimeError("end_feed_pass without begin_feed_pass")
        if self._feed_keys:
            self._pass_keys = np.unique(np.concatenate(self._feed_keys))
        else:
            self._pass_keys = np.empty(0, dtype=np.uint64)
        if self._pass_keys.size > self.capacity - 1:
            raise RuntimeError(
                "pass working set %d exceeds table pass_capacity %d"
                % (self._pass_keys.size, self.capacity))
        self._feed_keys = []
        self._in_feed_pass = False

    def begin_pass(self) -> None:
        """Build the slab: host rows of every pass key (created on first
        sight) in [0, n), zeros after, one host-to-device copy."""
        if self._in_pass:
            raise RuntimeError("pass already open")
        if self._pass_keys is None:
            raise RuntimeError("begin_pass before feed pass completed")
        n = self._pass_keys.size
        slab = torch.zeros((self.capacity, self.layout.width),
                           dtype=torch.float32, device=self.device)
        if n:
            rows = self.store.lookup_or_create(self._pass_keys)
            slab[:n].copy_(torch.from_numpy(rows))
        self._slab = slab
        self._in_pass = True

    def end_pass(self) -> None:
        """Write the slab's pass rows back to the host store; drop the
        slab."""
        if not self._in_pass:
            raise RuntimeError("end_pass without begin_pass")
        n = self._pass_keys.size
        if n:
            rows = self._slab[:n].cpu().numpy()
            self.store.write_back(self._pass_keys, rows)
        self._slab = None
        self._in_pass = False

    # ------------------------------------------------------------- id space
    @property
    def pass_size(self) -> int:
        return 0 if self._pass_keys is None else int(self._pass_keys.size)

    @property
    def pass_keys(self) -> Optional[np.ndarray]:
        return self._pass_keys

    @property
    def padding_id(self) -> int:
        return self.capacity - 1

    def lookup_ids(self, keys: np.ndarray,
                   valid: Optional[np.ndarray] = None) -> np.ndarray:
        """Feasign keys -> int32 pass-local ids; positions where ``valid``
        is False map to the trash row. Unregistered keys raise."""
        keys = np.asarray(keys, dtype=np.uint64)
        if self._pass_keys is None:
            raise RuntimeError("no active pass key set")
        n = self._pass_keys.size
        ids = np.minimum(np.searchsorted(self._pass_keys, keys),
                         max(n - 1, 0))
        hit = (self._pass_keys[ids] == keys if n
               else np.zeros(keys.shape, bool))
        if valid is not None:
            ids = np.where(valid, ids, self.padding_id)
            hit = hit | ~valid
        if not hit.all():
            raise KeyError("keys not registered in feed pass (first few: "
                           "%s)" % keys[~hit][:5])
        return ids.astype(np.int32)

    def dedup_for_push(self, ids: np.ndarray):
        """dedup_ids with padding uids starting at this table's capacity."""
        return dedup_ids(ids, self.capacity)

    @property
    def slab(self) -> torch.Tensor:
        """The live pass slab; train steps update it in place."""
        if self._slab is None:
            raise RuntimeError("no slab outside begin_pass/end_pass")
        return self._slab
