"""A shard store over the CPU parameter server: the GPUPS composition.

Counterpart of paddlebox_tpu/embedding/ps_store.py. ``PSBackedStore``
puts a sparse table of the PS (ps/, in process through a PsLocalClient or
over TCP through a TcpPSClient) behind the store interface the sharded
table's owned shard reads (PSGPUWrapper, ps_gpu_wrapper.cc):

  the pass's keys -> a bulk fetch from the PS (BuildPull, cc:337) -> the
  shard's device slab (BuildGPUTask, cc:684) -> the steps, the rule in
  the slab -> EndPass writes the touched rows back to the PS (cc:983+,
  dump_to_cpu)

A fetch and a write-back go in chunks of ``chunk_keys`` keys, so a large
pass never makes one giant frame (heter_comm build_ps's chunk_size,
heter_comm_inl.h:597). The store has no ``lookup_present`` (the PS cannot
tell a found row from a created zero row over pull_sparse, so the preload
prefetcher skips the shard and its rows resolve at the pass boundary) and
no ``set_journal_sink`` (a spill on the server's tier is invisible to
this client, so it taints an attached journal's epoch). Table-wide
operations (len, shrink, the day's aging, the spill) reach the server
once, through the one store made ``primary``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from paddlebox_tpu_torch.config.configs import TableConfig
from paddlebox_tpu_torch.embedding.accessor import ValueLayout
from paddlebox_tpu_torch.utils.stats import stat_add


class PSBackedStore:
    """lookup_or_create / lookup / write_back over a PS client's sparse
    table ``table_id`` (BuildPull and EndPass over RPC)."""

    def __init__(self, client, table_id: int, layout: ValueLayout,
                 table: TableConfig, chunk_keys: int = 1 << 18,
                 primary: bool = True) -> None:
        """primary: exactly one of the stores fronting one table_id must be
        primary, or a table-wide operation (shrink, len) reaches the server
        once a store (a P-fold decay)."""
        self.client = client
        self.table_id = table_id
        self.layout = layout
        self.table = table
        self.chunk_keys = chunk_keys
        self.primary = primary

    def _pull(self, keys: np.ndarray, create: bool) -> np.ndarray:
        out = np.empty((keys.size, self.layout.width), np.float32)
        for lo in range(0, keys.size, self.chunk_keys):
            chunk = keys[lo:lo + self.chunk_keys]
            out[lo:lo + chunk.size] = self.client.pull_sparse(
                self.table_id, chunk, create=create)
        stat_add("ps_build_keys_pulled", int(keys.size))
        return out

    def lookup_or_create(self, keys: np.ndarray) -> np.ndarray:
        """BuildPull: the pass's rows from the PS, missing features created
        on the server (FleetWrapper::PullSparseVarsSync). Under the
        incremental lifecycle the shard asks for the keys it does not hold
        resident only; ps_build_keys_pulled counts what went over the
        wire."""
        return self._pull(np.asarray(keys, np.uint64), create=True)

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """The test-mode fetch: a missing key reads as a zero row."""
        return self._pull(np.asarray(keys, np.uint64), create=False)

    def write_back(self, keys: np.ndarray, values: np.ndarray) -> None:
        """EndPass: slab rows to the PS verbatim (the rule ran in the slab).
        assign_sparse creates or overwrites, so the touched-row write-back
        goes through the same call; ps_build_keys_dumped counts its
        rows."""
        keys = np.asarray(keys, np.uint64)
        for lo in range(0, keys.size, self.chunk_keys):
            chunk = keys[lo:lo + self.chunk_keys]
            self.client.assign_sparse(self.table_id, chunk,
                                      values[lo:lo + chunk.size])
        stat_add("ps_build_keys_dumped", int(keys.size))

    # ---- the table-wide operations, through the primary only
    def __len__(self) -> int:
        # the table's count, from the primary alone, so that a sum over a
        # table's stores counts each row once
        return self.client.sparse_size(self.table_id) if self.primary else 0

    def shrink(self) -> int:
        # one decay a shrink (the show/click decay is multiplicative)
        return self.client.shrink(self.table_id) if self.primary else 0

    def age_unseen_days(self) -> None:
        # one +1 a day boundary
        if self.primary:
            self.client.age_unseen_days(self.table_id)

    # the spill budget is the server table's: check_need_limit_mem hands
    # the primary the whole budget once
    spill_table_wide = True

    def spill(self, max_resident: int) -> int:
        """The server's DRAM limit (CheckNeedLimitMem on the PS table's SSD
        tier), through the primary."""
        if not self.primary:
            return 0
        n = int(self.client.limit_mem(self.table_id, max_resident))
        if n:
            stat_add("ps_rows_spilled", n)
        return n

    def tick_spill_age(self) -> None:
        # the age=False day boundary assumes the checkpoint's stat rewrite
        # aged the resident rows, but the PS checkpoints through its own
        # save, which does not: the server's rows age here, once
        if self.primary:
            self.client.age_unseen_days(self.table_id)

    def state_items(self) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError(
            "PS-backed shards checkpoint server-side: PSClient.save()")

    def save(self, path: str) -> None:
        raise NotImplementedError(
            "PS-backed shards checkpoint server-side: PSClient.save()")

    def load(self, path: str) -> None:
        raise NotImplementedError(
            "PS-backed shards checkpoint server-side: PSClient.load()")


def ps_store_factory(client, table_id: int, process_primary: bool = True):
    """A store factory, ``factory(layout, table, seed) -> PSBackedStore``,
    whose stores all front the PS table ``table_id`` (the PS routes keys
    itself; a shard only asks for its own keys). The first store it makes
    is the primary when ``process_primary``; a job of several processes
    passes process_primary=(rank == 0), so that one store in the job is
    primary. A caller that learns its rank only after the store is made
    (train/factory.py's PSGPUTrainer: the rank is the trainer's mesh
    position) passes process_primary=False and sets that store's
    ``primary`` itself."""
    state = {"made_primary": not process_primary}

    def factory(layout: ValueLayout, table: TableConfig, seed: int):
        primary = not state["made_primary"]
        state["made_primary"] = True
        return PSBackedStore(client, table_id, layout, table,
                             primary=primary)

    return factory
