"""The key-mod sharded pass table: one rank's shard, the global routing.

Counterpart of paddlebox_tpu/parallel/sharded_table.py:69-1110 for the
port's topology, one process a GPU and one shard a process (rank = shard
= mesh position). Every rank keeps the GLOBAL routing state (each shard's
sorted pass key list, and one native route index over all of them, so any
batch routes to any shard) and the host store and device slab of its own
shard only (the reference's ``owned_shards`` with one entry):

  feed pass    each rank adds its own files' keys; ``end_feed_pass``
        unions them across ranks (``allgather``, fleet.all_gather) and
        splits the union by the policy's ``shard_of``, so every rank holds
        the same routing (the role the shared PS plays in the reference's
        feed pass, box_wrapper.h:1201-1278)
  build        ``build_owned_slabs``: the shard's slab of pass_capacity / P
        rows, with the single-device table's incremental lifecycle (the
        shard is an embedding/pass_table.py PassTable of that capacity
        over the shard's keys, its store seeded seed + shard as the
        reference's): a delta promote of the resident rows, a full build
        otherwise, test mode, the touched-row write-back on gather_rows,
        check_need_limit_mem, shrink and the day boundary
  route        ``bucketize``: one batch's keys -> [P, KB] local-id buckets
        (first occurrence order, deduplicated, padding the shard's trash
        row shard_cap - 1) and the [K] restore index, with overflow
        counted, warned about once a feed pass, and raised under
        ShardFlags.strict_bucket_overflow (the PADDLE_ENFORCE discipline,
        box_wrapper_impl.h:139)

The host plane's per-step products (reference :155-417):
``exchange_incoming_p2p`` ships each owner only its column of the
buckets over the fleet's MeshComm, so this rank learns the ids every
source sends its shard; ``stage_push_dedup`` turns them into the push's
sorted dedup (uids, perm, offsets, n_uniq) and marks the touched rows.

The router is native (native/route.cc rt_bucketize) and nothing falls
back; ``bucketize_plain`` is its numpy twin, bit for bit (the same
buckets, restore and overflow: first occurrences fill a shard's bucket in
order, and the late ones overflow), which the tests hold it to.
``save``, ``load``, ``store_view``, the SSD tier under sharding, the
journal hooks and the PS store wait for their slice (ROADMAP.md A10).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.config.configs import TableConfig
from paddlebox_tpu_torch.config.flags import PassFlags, ShardFlags
from paddlebox_tpu_torch.device import DeviceLike
from paddlebox_tpu_torch.embedding.pass_table import (PassTable, dedup_ids,
                                                      segment_offsets)
from paddlebox_tpu_torch.native import host_lib
from paddlebox_tpu_torch.obs import log as obs_log
from paddlebox_tpu_torch.obs.tracer import record_span
from paddlebox_tpu_torch.parallel.sharding import (ShardingPolicy,
                                                   resolve_sharding_policy)
from paddlebox_tpu_torch.utils.stats import hist_observe, stat_add


@dataclasses.dataclass
class ShardedBatchIndex:
    """Host-built routing of one batch's keys.

    buckets:  [P, KB] int32: per destination shard the LOCAL ids the batch
              pulls there (deduplicated); padding slots hold shard_cap - 1
              (the trash row)
    restore:  [K] int32: the flat bucket slot (s * KB + j) of each key
              position (occurrences of a key share one); invalid positions
              point at slot 0 and are masked by the batch's valid
    overflow: key occurrences dropped because their shard's bucket was full
    """

    buckets: np.ndarray
    restore: np.ndarray
    overflow: int


def bucketize_plain(shard_keys: Sequence[np.ndarray], keys: np.ndarray,
                    valid: np.ndarray, bucket_cap: int, trash_id: int,
                    shard: np.ndarray) -> ShardedBatchIndex:
    """The numpy twin of the native router (host_lib.bucketize), bit for
    bit: each valid key's first occurrence takes the next slot of its
    shard's bucket (``shard``: each key position's owner) until the
    bucket is full; a key whose first occurrence found it full overflows
    with every occurrence (dropped from ``valid`` IN PLACE). The local id
    is the key's position in its shard's sorted keys; a kept key not there
    raises KeyError (the first in occurrence order)."""
    P, KB = len(shard_keys), bucket_cap
    buckets = np.full((P, KB), trash_id, np.int32)
    restore = np.zeros(keys.shape[0], np.int32)
    idx = np.flatnonzero(valid)
    if idx.size == 0:
        return ShardedBatchIndex(buckets, restore, 0)
    keys = np.asarray(keys, np.uint64)
    uniq, first, inv = np.unique(keys[idx], return_index=True,
                                 return_inverse=True)
    sh_u = np.asarray(shard, np.int64)[idx[first]]
    if sh_u.size and (sh_u.min() < 0 or sh_u.max() >= P):
        bad = np.flatnonzero((sh_u < 0) | (sh_u >= P))
        raise ValueError("shard out of range [0, %d) for key %d"
                         % (P, int(uniq[bad[np.argmin(first[bad])]])))
    # the uniques in first-occurrence order, each one's rank in its shard
    order = np.argsort(first, kind="stable")
    sh_o = sh_u[order]
    by_shard = np.argsort(sh_o, kind="stable")
    starts = np.concatenate([[0], np.cumsum(np.bincount(sh_o,
                                                        minlength=P))[:-1]])
    rank_o = np.empty(order.size, np.int64)
    rank_o[by_shard] = np.arange(order.size) - starts[sh_o[by_shard]]
    kept_o = rank_o < KB
    local_o = np.zeros(order.size, np.int64)
    bad_o = np.zeros(order.size, bool)
    for s in range(P):
        m = np.flatnonzero((sh_o == s) & kept_o)
        if not m.size:
            continue
        g = uniq[order[m]]
        sk = shard_keys[s]
        pos = np.minimum(np.searchsorted(sk, g), max(sk.size - 1, 0))
        hit = sk[pos] == g if sk.size else np.zeros(g.size, bool)
        local_o[m] = pos
        bad_o[m] = ~hit
    if bad_o.any():
        raise KeyError("key %d not registered in feed pass"
                       % int(uniq[order[np.flatnonzero(bad_o)[0]]]))
    buckets[sh_o[kept_o], rank_o[kept_o]] = local_o[kept_o]
    slot_u = np.empty(order.size, np.int64)
    slot_u[order] = np.where(kept_o, sh_o * KB + rank_o, -1)
    occ = slot_u[inv]
    drop = occ < 0
    valid[idx[drop]] = False
    restore[idx[~drop]] = occ[~drop]
    return ShardedBatchIndex(buckets, restore, int(drop.sum()))


def _dest_plan(mesh, local_positions, num_devices: int,
               policy: Optional[ShardingPolicy]):
    from paddlebox_tpu_torch.parallel.sharding import default_dest_plan
    plan = policy.dest_plan if policy is not None else default_dest_plan
    return plan(mesh, local_positions, num_devices)


def exchange_incoming_p2p(buckets_local: np.ndarray,
                          local_positions: List[int], num_devices: int,
                          mesh, policy: Optional[ShardingPolicy] = None
                          ) -> Dict[int, np.ndarray]:
    """The per-step bucket exchange (reference :155-215): rank r ships the
    owner of destination shard d only its buckets[:, d, :] column over
    ``mesh`` (fleet.make_mesh_comm), with a header of its source and
    destination positions. Returns {d: [num_devices, KB] int32 incoming
    ids in source order} for this rank's owned destinations: the ids the
    device a2a's pull serves and the push dedups. Counts the reference's
    hostplane_exchange_* stats (bytes sent to and received from peers)."""
    bl = np.ascontiguousarray(buckets_local, np.int32)
    n_local, P, KB = bl.shape
    dest_of_rank = _dest_plan(mesh, local_positions, num_devices, policy)
    t0 = time.perf_counter()
    parts = {}
    for r, dests in enumerate(dest_of_rank):
        header = np.array([n_local, KB, len(dests)] + list(local_positions)
                          + list(dests), np.int32)
        parts[r] = np.concatenate([header, bl[:, dests, :].ravel()])
    got = mesh.exchange(parts)
    mine = dest_of_rank[mesh.rank]
    out = {d: np.empty((num_devices, KB), np.int32) for d in mine}
    seen = np.zeros(num_devices, bool)
    for part in got.values():
        part = np.asarray(part, np.int32)
        nl, kb2, nd = int(part[0]), int(part[1]), int(part[2])
        if kb2 != KB:
            raise ValueError("bucket exchange KB mismatch: peer sent KB=%d, "
                             "local is KB=%d" % (kb2, KB))
        srcs = part[3:3 + nl]
        dests = part[3 + nl:3 + nl + nd]
        if sorted(dests.tolist()) != sorted(mine):
            raise ValueError("bucket exchange routed to the wrong owner: "
                             "got destinations %s, own %s"
                             % (dests.tolist(), mine))
        block = part[3 + nl + nd:].reshape(nl, nd, KB)
        for j, d in enumerate(dests.tolist()):
            out[d][srcs] = block[:, j, :]
        seen[srcs] = True
    if not seen.all():
        raise RuntimeError("bucket exchange incomplete: no contribution for "
                           "source positions %s"
                           % np.flatnonzero(~seen).tolist())
    wire = sum(int(p.nbytes) for r, p in parts.items() if r != mesh.rank) \
        + sum(int(p.nbytes) for r, p in got.items() if r != mesh.rank)
    t1 = time.perf_counter()
    stat_add("hostplane_exchange_bytes", wire)
    stat_add("hostplane_exchange_us", int((t1 - t0) * 1e6))
    stat_add("hostplane_exchange_steps")
    hist_observe("hostplane_exchange_us", (t1 - t0) * 1e6)
    record_span("hostplane_p2p_exchange", t0, t1)
    return out


def stage_push_dedup(incoming: Mapping[int, np.ndarray], shard_cap: int,
                     note_touched: Optional[Callable] = None
                     ) -> Dict[str, list]:
    """The push's host products of each owned destination shard d from the
    ids it receives (``incoming[d]``, [num_devices, KB] in source order,
    flattened): the sorted dedup (dedup_ids over the padding base
    shard_cap: ``push_uids``, ``push_perm``, ``push_inv``), ``n_uniq`` and
    the segment ``push_offsets`` over the real occurrences (padding slots
    hold the trash id shard_cap - 1, the largest, so they sort last and
    merge to a zero row). ``note_touched(d, uids)`` marks the rows the
    push will write (reference :321-415, its sorted tier). Lists in
    destination order."""
    def dedup_dest(d):
        ids = np.ascontiguousarray(incoming[d], np.int32).reshape(-1)
        uids, perm, inv, n_uniq = dedup_ids(ids, shard_cap)
        offsets = segment_offsets(inv, int((ids != shard_cap - 1).sum()))
        if note_touched is not None:
            note_touched(d, uids)
        return uids, perm, inv, offsets, n_uniq

    out: Dict[str, list] = {"push_uids": [], "push_perm": [], "push_inv": [],
                            "push_offsets": [], "n_uniq": []}
    for prod in map(dedup_dest, sorted(incoming)):
        for k, v in zip(("push_uids", "push_perm", "push_inv",
                         "push_offsets", "n_uniq"), prod):
            out[k].append(v)
    return out


class ShardedPassTable:
    """The global routing of a P-shard pass table and the pass lifecycle
    of this rank's shard (``owned_shards=[rank]``)."""

    def __init__(self, table: TableConfig, num_shards: int, bucket_cap: int,
                 seed: int = 0, owned_shards: Optional[Sequence[int]] = None,
                 policy: Optional[ShardingPolicy] = None,
                 device: DeviceLike = None,
                 pass_flags: Optional[PassFlags] = None,
                 shard_flags: Optional[ShardFlags] = None, store=None,
                 embed_dtype: str = "float32") -> None:
        """``owned_shards``: the one shard this process hosts (None: [0],
        for a table of one shard). ``policy``: the key -> shard rule
        (default: resolve_sharding_policy, ShardFlags' sharding_policy).
        ``store``: the owned shard's host store (default: the native
        store, seeded seed + shard). ``device``: the shard slab's device
        (the card unless the caller asks for the CPU)."""
        self.shard_flags = shard_flags or ShardFlags()
        self.policy = policy or resolve_sharding_policy(
            num_shards, self.shard_flags.sharding_policy)
        if self.policy.num_shards != num_shards:
            raise ValueError("sharding policy built for %d shards, table has "
                             "%d" % (self.policy.num_shards, num_shards))
        if table.pass_capacity % num_shards:
            raise ValueError("pass_capacity must divide evenly into shards")
        if owned_shards is None:
            if num_shards != 1:
                raise ValueError("a table of %d shards needs owned_shards="
                                 "[rank]" % num_shards)
            owned_shards = [0]
        self.owned_shards = [int(s) for s in owned_shards]
        if len(self.owned_shards) != 1:
            raise NotImplementedError(
                "the port hosts one shard a process (owned_shards=[rank]); "
                "got %s" % self.owned_shards)
        self.rank = self.owned_shards[0]
        if not 0 <= self.rank < num_shards:
            raise ValueError("owned shard %d outside [0, %d)"
                             % (self.rank, num_shards))
        self.config = table
        self.num_shards = int(num_shards)
        self.bucket_cap = int(bucket_cap)
        self.shard_cap = table.pass_capacity // num_shards
        # the owned shard: a single-device table of shard_cap rows over the
        # shard's keys, its store seeded as the reference's shard store
        self.shard = PassTable(
            dataclasses.replace(table, pass_capacity=self.shard_cap),
            seed=seed + self.rank, device=device, flags=pass_flags,
            store=store, embed_dtype=embed_dtype)
        self.layout = self.shard.layout
        self.push_layout = self.shard.push_layout
        self.stores = [self.shard.store if s == self.rank else None
                       for s in range(num_shards)]
        self._feed_keys: List[np.ndarray] = []
        self._in_feed_pass = False
        self._shard_keys: Optional[List[np.ndarray]] = None
        self._route_index: Optional[int] = None
        self._overflow_warned = False

    # ------------------------------------------------------------ feed pass
    def begin_feed_pass(self) -> None:
        if self._in_feed_pass:
            raise RuntimeError("feed pass already open")
        self._feed_keys = []
        self._in_feed_pass = True

    def add_keys(self, keys: np.ndarray) -> None:
        if not self._in_feed_pass:
            raise RuntimeError("add_keys outside feed pass")
        keys = np.asarray(keys, dtype=np.uint64)
        self._feed_keys.append(keys)
        if self.policy.wants_observe:
            self.policy.observe(keys)

    def end_feed_pass(self, allgather: Optional[Callable] = None) -> None:
        """Freeze the pass: this rank's keys, unioned across ranks by
        ``allgather`` (fleet.all_gather; None: this rank's alone), split
        by the policy into each shard's sorted list; the route index over
        all of them; the owned shard's pass key set."""
        if not self._in_feed_pass:
            raise RuntimeError("end_feed_pass without begin_feed_pass")
        local = (np.unique(np.concatenate(self._feed_keys))
                 if self._feed_keys else np.empty(0, np.uint64))
        if allgather is not None:
            allk = np.unique(np.concatenate(
                [np.asarray(p, np.uint64) for p in allgather(local)]))
        else:
            allk = local
        shard = self.policy.shard_of(allk)
        shard_keys = []
        for s in range(self.num_shards):
            ks = allk[shard == s]
            if ks.size > self.shard_cap - 1:
                raise RuntimeError(
                    "shard %d working set %d exceeds shard capacity %d "
                    "(raise TableConfig.pass_capacity)"
                    % (s, ks.size, self.shard_cap))
            shard_keys.append(ks)
        self._drop_route_index()
        self._shard_keys = shard_keys
        self._route_index = host_lib.create_route_index(shard_keys)
        self.shard.begin_feed_pass()
        self.shard.add_keys(shard_keys[self.rank])
        self.shard.end_feed_pass()
        self._feed_keys = []
        self._in_feed_pass = False
        self._overflow_warned = False

    def _drop_route_index(self) -> None:
        host_lib.destroy_route_index(self._route_index)
        self._route_index = None

    def __del__(self) -> None:
        try:
            self._drop_route_index()
        except Exception:  # an interpreter that is shutting down
            pass

    def shard_keys(self, s: int) -> np.ndarray:
        """Shard s's sorted pass keys (every rank holds every shard's)."""
        if self._shard_keys is None:
            raise RuntimeError("no active pass key set")
        return self._shard_keys[s]

    @property
    def pass_size(self) -> int:
        return sum(k.size for k in self._shard_keys or [])

    # ------------------------------------------------------- pass lifecycle
    def build_owned_slabs(self):
        """BeginPass of the owned shard: its [shard_cap, width] slab on the
        device (PassTable.begin_pass: a delta promote or a full build)."""
        if self._shard_keys is None:
            raise RuntimeError("build_owned_slabs before feed pass completed")
        self.shard.begin_pass()
        return self.shard.slab

    @property
    def slab(self):
        return self.shard.slab

    @property
    def resident_slab(self):
        return self.shard.resident_slab

    def note_touched(self, dest: int, uids: np.ndarray) -> None:
        """Mark the rows of the owned shard's push uids touched (padding
        uids, shard_cap and up, drop; the trash row never reaches the
        store); other destinations are other ranks'."""
        if dest == self.rank:
            self.shard.note_touched(uids[uids < self.shard_cap])

    def end_pass(self) -> None:
        """EndPass of the owned shard: the touched-row write-back (one
        gather_rows of the touched rows and one copy to the host), then
        check_need_limit_mem (PassTable.end_pass)."""
        self.shard.end_pass()

    # the reference's names for the owned shard's EndPass
    write_back_addressable = end_pass_write_back = end_pass

    def check_need_limit_mem(self) -> int:
        return self.shard.check_need_limit_mem()

    def invalidate_residency(self) -> None:
        self.shard.invalidate_residency()

    def set_test_mode(self, test: bool) -> None:
        self.shard.set_test_mode(test)

    @property
    def test_mode(self) -> bool:
        return self.shard.test_mode

    @property
    def counters(self) -> Dict[str, int]:
        return self.shard.counters

    def shrink_table(self) -> int:
        return self.shard.shrink_table()

    def end_day(self, age: bool = True) -> int:
        return self.shard.end_day(age)

    # ---------------------------------------------------------- batch index
    def bucketize(self, keys: np.ndarray, valid: np.ndarray,
                  plain: bool = False) -> ShardedBatchIndex:
        """Route one batch's keys (shard = policy.shard_of(key), the local
        id its position in the shard's sorted keys, deduplicated into
        bucket slots): the native router, or with ``plain`` its numpy
        twin. Drops overflowed occurrences from ``valid`` (contiguous
        bool) IN PLACE, and counts, warns or raises on overflow."""
        if self._shard_keys is None:
            raise RuntimeError("no active pass key set")
        if valid.dtype != np.bool_ or not valid.flags.c_contiguous:
            raise TypeError("valid must be a contiguous bool array")
        trash = self.shard_cap - 1
        keymod = self.policy.native_keymod
        if plain:
            idx = bucketize_plain(self._shard_keys, keys, valid,
                                  self.bucket_cap, trash,
                                  self.policy.shard_of(keys))
        else:
            idx = ShardedBatchIndex(*host_lib.bucketize(
                self._route_index, keys, valid, self.num_shards,
                self.bucket_cap, trash,
                None if keymod else self.policy.shard_of(keys)))
        if idx.overflow:
            self._note_overflow(idx.overflow)
        return idx

    def _note_overflow(self, count: int) -> None:
        """An overflow drops those keys' gradients this batch: the
        sharded_bucket_overflow stat always, one warning a feed pass, and
        under strict_bucket_overflow an error."""
        stat_add("sharded_bucket_overflow", count)
        if self.shard_flags.strict_bucket_overflow:
            raise RuntimeError(
                "sharded bucket overflow: %d keys dropped this batch "
                "(bucket_cap=%d too small for this key skew) — their "
                "gradients would be silently lost; raise bucket_cap or unset "
                "strict_bucket_overflow" % (count, self.bucket_cap))
        if not self._overflow_warned:
            self._overflow_warned = True
            obs_log.warning("sharded bucket overflow: keys dropped this "
                            "batch, their gradients lost; further overflows "
                            "this pass count in sharded_bucket_overflow only",
                            dropped=count, bucket_cap=self.bucket_cap)
