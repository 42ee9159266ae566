"""The sharded pass table: one rank's shard, the global routing.

Counterpart of paddlebox_tpu/parallel/sharded_table.py:69-1110 for the
port's topology, one process a GPU and one shard a process (rank = shard
= mesh position). Every rank keeps the GLOBAL routing state (each shard's
sorted pass key list, and one native route index over all of them, so any
batch routes to any shard) and the host store and device slab of its own
shard only (the reference's ``owned_shards`` with one entry):

  feed pass    each rank adds its own files' keys; ``end_feed_pass``
        unions them across ranks (``allgather``, fleet.all_gather) and
        splits the union by the policy's ``shard_of`` (key-mod,
        table-wise or the 2-D grid, parallel/sharding.py), so every rank
        holds the same routing (the role the shared PS plays in the
        reference's feed pass, box_wrapper.h:1201-1278); the grid's hot
        tier is fed the key stream (``add_keys``) and freezes here, its
        ranks' sketches summed over the same collective
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
source sends its shard (the full wire); ``exchange_push_uids_p2p``
dedups each column before the wire and the owner unions the vectors (the
lean wires, whose ids ride the device a2a), the frozen hot ids kept off
the wire and added back by the owner; ``stage_push_dedup`` turns
either into the push's products (the sorted dedup: uids, perm, offsets,
n_uniq, and the rebuild write's position map; or the sorted uids alone)
and marks the touched rows.

The checkpoint plane (reference :498-520, 1131-1304): ``attach_journal``
hands the owned shard's PassTable the touched-row journal; ``save`` and
``load`` write and read the owned shard at ``{prefix}.shard{s:03d}`` in
the stores' own format; ``load_split`` reads any set of checkpoint files
and keeps the keys the live policy routes to the owned shard;
``store_view`` (and ``store``) is what the CheckpointManager drives at
world 1, where the one shard is every shard: the owned shard's store
itself. Above world 1 it raises the reference's TypeError: every such
job is multi-process in the port, and checkpoints per owned shard.

The router is native (native/route.cc rt_bucketize, and
rt_bucketize_sharded under the other policies) and nothing falls back;
``bucketize_plain`` is its numpy twin, bit for bit (the same buckets,
restore and overflow: first occurrences fill a shard's bucket in order,
and the late ones overflow), which the tests hold it to.

The SSD tier (reference :1066-1151, 1199-1270): the owned shard's
PassTable spills at every end_pass, its store keeping the host's budget
divided by the ranks on the host (``host_ranks``, ShardMesh.chips: P
ranks on a host hold what the reference's one process with P shards
holds); ``load_ssd_to_mem`` and the tier queries (``spilled_snapshot``,
``spilled_count``, ``spilled_keys``, ``rebase_spill_ages``) read the owned
shard's tier. Each rank's SpillTier tags its block files with its pid,
so ranks sharing one ssd_dir never touch each other's blocks. A
PS-backed shard (``store_factory``, embedding/ps_store.py) spills on the
server through its primary with the whole budget, and its store_view
raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from paddlebox_tpu_torch.config.configs import TableConfig
from paddlebox_tpu_torch.config.flags import PassFlags, ShardFlags
from paddlebox_tpu_torch.device import DeviceLike
from paddlebox_tpu_torch.embedding.accessor import ValueLayout
from paddlebox_tpu_torch.embedding.pass_table import (PassTable, dedup_ids,
                                                      dedup_uids_sorted,
                                                      pos_for_rebuild,
                                                      segment_offsets,
                                                      sorted_member,
                                                      uniq_count)
from paddlebox_tpu_torch.embedding.ps_store import PSBackedStore
from paddlebox_tpu_torch.native import host_lib
from paddlebox_tpu_torch.obs import log as obs_log
from paddlebox_tpu_torch.obs.tracer import record_span
from paddlebox_tpu_torch.parallel.sharding import (ShardingPolicy,
                                                   resolve_sharding_policy)
from paddlebox_tpu_torch.utils.lockwatch import make_lock
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


def exchange_push_uids_p2p(buckets_local: np.ndarray,
                           local_positions: List[int], num_devices: int,
                           shard_cap: int, mesh,
                           policy: Optional[ShardingPolicy] = None,
                           hot_counts: Optional[Dict[str, int]] = None
                           ) -> Tuple[Dict[int, np.ndarray], Dict[int, int]]:
    """Dedup before the wire (reference :218-318): for every destination
    shard this rank sorts the uniques of its own column and ships the
    owner only that vector over ``mesh``; the owner unions the sources'
    vectors: the same id set, so the same sorted uids as deduping the full
    concatenation after exchange_incoming_p2p, at a fraction of the bytes.
    Returns ({d: uids [num_devices * KB] int32, tail-padded with
    shard_cap + i as dedup_uids_sorted pads}, {d: the real occurrences
    the device a2a will carry there}) for this rank's owned destinations.
    The second dict is the port's: a source's column holds each id once,
    so its real occurrences are its uniques other than the trash id
    shard_cap - 1, and the header carries their count (the push's device
    maps take it as their n_valid). Counts the hostplane_exchange_*
    stats.

    Under a policy with a frozen hot tier (the 2-D grid) the hot local ids
    never travel: each sender drops ``policy.hot_local_ids(d)`` from its
    vector for d, and the owner adds its whole hot set back, so the uid
    vector may hold hot ids this step did not touch (the push leaves
    their rows unchanged). The real-id counts are taken before the
    filter: the device a2a still carries the hot ids in the buckets. A
    union over num_devices * KB raises RuntimeError. The ids kept off the
    wire and the ids added back count in the stats
    sharding_hot_ids_dropped and sharding_hot_ids_readded, and in
    ``hot_counts`` (keys 'dropped' and 'readded') when given."""
    bl = np.ascontiguousarray(buckets_local, np.int32)
    n_local, P, KB = bl.shape
    K = num_devices * KB
    if bl.size and int(bl.min()) < 0:
        raise ValueError("exchange_push_uids_p2p expects nonnegative int32 "
                         "pass-local ids")
    dest_of_rank = _dest_plan(mesh, local_positions, num_devices, policy)
    hot_of = (policy.hot_local_ids if policy is not None
              else (lambda d: None))
    t0 = time.perf_counter()
    uniq_of = [np.unique(bl[:, d, :]) for d in range(num_devices)]
    trash = shard_cap - 1
    real_of = [int(u.size - (u.size and u[-1] == trash)) for u in uniq_of]
    dropped = 0
    for d in range(num_devices):
        hot = hot_of(d)
        if hot is not None and hot.size and uniq_of[d].size:
            keep = ~sorted_member(hot, uniq_of[d])[1]
            dropped += int(keep.size - keep.sum())
            uniq_of[d] = uniq_of[d][keep]
    parts = {}
    for r, dests in enumerate(dest_of_rank):
        header = np.array([KB, len(dests)] + list(dests)
                          + [uniq_of[d].size for d in dests]
                          + [real_of[d] for d in dests], np.int32)
        parts[r] = np.concatenate([header] + [uniq_of[d] for d in dests])
    got = mesh.exchange(parts)
    mine = dest_of_rank[mesh.rank]
    vecs: Dict[int, List[np.ndarray]] = {d: [] for d in mine}
    n_valid = dict.fromkeys(mine, 0)
    for part in got.values():
        part = np.asarray(part, np.int32)
        kb2, nd = int(part[0]), int(part[1])
        if kb2 != KB:
            raise ValueError("uid exchange KB mismatch: peer sent KB=%d, "
                             "local is KB=%d" % (kb2, KB))
        dests = part[2:2 + nd].tolist()
        lens = part[2 + nd:2 + 2 * nd]
        reals = part[2 + 2 * nd:2 + 3 * nd]
        offs = np.concatenate([[0], np.cumsum(lens)]) + 2 + 3 * nd
        for j, d in enumerate(dests):
            vecs[d].append(part[offs[j]:offs[j + 1]])
            n_valid[d] += int(reals[j])
    out = {}
    readded = 0
    for d in mine:
        hot = hot_of(d)
        if hot is not None and hot.size:
            vecs[d].append(np.asarray(hot, np.int32))
            readded += int(hot.size)
        uniq = np.unique(np.concatenate(vecs[d]))
        n = uniq.size
        if n > K:
            raise RuntimeError(
                "uid exchange: union of %d incoming and replicated ids "
                "exceeds the staged vector length %d for dest %d — "
                "sharding_hot_cap/bucket_cap are inconsistent" % (n, K, d))
        uids = np.empty(K, np.int32)
        uids[:n] = uniq
        uids[n:] = shard_cap + np.arange(K - n, dtype=np.int32)
        out[d] = uids
    wire = sum(int(p.nbytes) for r, p in parts.items() if r != mesh.rank) \
        + sum(int(p.nbytes) for r, p in got.items() if r != mesh.rank)
    t1 = time.perf_counter()
    stat_add("hostplane_exchange_bytes", wire)
    stat_add("hostplane_exchange_us", int((t1 - t0) * 1e6))
    stat_add("hostplane_exchange_steps")
    hist_observe("hostplane_exchange_us", (t1 - t0) * 1e6)
    record_span("hostplane_uid_exchange", t0, t1)
    if dropped or readded:
        stat_add("sharding_hot_ids_dropped", dropped)
        stat_add("sharding_hot_ids_readded", readded)
        if hot_counts is not None:
            hot_counts["dropped"] = hot_counts.get("dropped", 0) + dropped
            hot_counts["readded"] = hot_counts.get("readded", 0) + readded
    return out, n_valid


def stage_push_dedup(incoming: Mapping[int, np.ndarray], shard_cap: int,
                     note_touched: Optional[Callable] = None,
                     rebuild: bool = False, uid_only: bool = False,
                     uids_by_dest: Optional[Mapping[int, np.ndarray]] = None
                     ) -> Dict[str, list]:
    """The push's host products of each owned destination shard d
    (reference :321-416), lists in destination order:

      * the full wire, from the ids it receives (``incoming[d]``,
        [num_devices, KB] in source order, flattened): the sorted dedup
        (dedup_ids over the padding base shard_cap: ``push_uids``,
        ``push_perm``, ``push_inv``), ``n_uniq`` and the segment
        ``push_offsets`` over the real occurrences (padding slots hold the
        trash id shard_cap - 1, the largest, so they sort last and merge
        to a zero row); with ``rebuild`` the write's [shard_cap]
        ``push_pos`` map (pos_for_rebuild);
      * ``uid_only`` (the uid, delta and ids-only wires): the sorted uid
        vector alone (``push_uids``, dedup_uids_sorted of ``incoming[d]``,
        or ``uids_by_dest[d]`` as exchange_push_uids_p2p unioned it) and
        its ``n_uniq``; the device derives perm and offsets from the ids
        its a2a carries.

    The reference's ``sort_uids`` arm (the blocked write's bucketize
    trusts sorted uids) is the port's only behaviour: its dedup always
    sorts. ``note_touched(d, uids)`` marks the rows the push will
    write."""
    def dedup_dest(d):
        perm = inv = offsets = pos = None
        if uids_by_dest is not None:
            uids = uids_by_dest[d]
        else:
            ids = np.ascontiguousarray(incoming[d], np.int32).reshape(-1)
            if uid_only:
                uids = dedup_uids_sorted(ids, shard_cap)
            else:
                uids, perm, inv, _ = dedup_ids(ids, shard_cap)
                offsets = segment_offsets(
                    inv, int((ids != shard_cap - 1).sum()))
        if note_touched is not None:
            note_touched(d, uids)
        if rebuild and not uid_only:
            pos = pos_for_rebuild(uids, shard_cap)
        return uids, perm, inv, offsets, uniq_count(uids, shard_cap), pos

    dests = sorted(uids_by_dest if uids_by_dest is not None else incoming)
    out: Dict[str, list] = {"push_uids": [], "n_uniq": []}
    if not uid_only:
        out.update(push_perm=[], push_inv=[], push_offsets=[])
    if rebuild and not uid_only:
        out["push_pos"] = []
    for uids, perm, inv, offsets, n_uniq, pos in map(dedup_dest, dests):
        out["push_uids"].append(uids)
        out["n_uniq"].append(n_uniq)
        if not uid_only:
            out["push_perm"].append(perm)
            out["push_inv"].append(inv)
            out["push_offsets"].append(offsets)
        if pos is not None:
            out["push_pos"].append(pos)
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
                 embed_dtype: str = "float32", store_factory=None,
                 host_ranks: int = 1) -> None:
        """``owned_shards``: the one shard this process hosts (None: [0],
        for a table of one shard). ``policy``: the key -> shard rule
        (default: resolve_sharding_policy over ``shard_flags``).
        ``store``: the owned shard's host store, or ``store_factory``
        (layout, table, seed) -> store makes it (embedding/ps_store.py
        ps_store_factory puts the CPU PS behind the shard); default the
        native store. Each is seeded seed + shard. ``host_ranks``: the
        ranks on this process's host, which share the host's SSD budget
        (ShardMesh.chips). ``device``: the shard slab's device (the card
        unless the caller asks for the CPU)."""
        self.shard_flags = shard_flags or ShardFlags()
        self.policy = policy or resolve_sharding_policy(
            num_shards, flags=self.shard_flags)
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
            # the port's topology, not a missing mode (ROADMAP.md,
            # deliberate differences)
            raise ValueError(
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
        if store is not None and store_factory is not None:
            raise ValueError("pass store or store_factory, not both")
        if store_factory is not None:
            store = store_factory(
                ValueLayout(table.embedx_dim, table.optimizer.optimizer,
                            expand_dim=table.expand_embed_dim),
                table, seed + self.rank)
        # the owned shard: a single-device table of shard_cap rows over the
        # shard's keys, its store seeded as the reference's shard store
        self.shard = PassTable(
            dataclasses.replace(table, pass_capacity=self.shard_cap),
            seed=seed + self.rank, device=device, flags=pass_flags,
            store=store, embed_dtype=embed_dtype)
        # the reference divides the budget over a process's owned shards
        # (:1075); the port's process is a rank, so the host's budget
        # divides over the host's ranks
        self.shard.budget_split = max(1, int(host_ranks))
        self.layout = self.shard.layout
        self.push_layout = self.shard.push_layout
        self.stores = [self.shard.store if s == self.rank else None
                       for s in range(num_shards)]
        self._feed_keys: List[np.ndarray] = []
        self._in_feed_pass = False
        self._shard_keys: Optional[List[np.ndarray]] = None
        self._route_index: Optional[int] = None
        self._overflow_warned = False
        # the hot keys the last feed pass froze, over every shard
        self.hot_frozen = 0
        # native router calls by entry (bucketize)
        self._route_lock = make_lock("ShardedPassTable._route_lock")
        self.route_counts: Dict[str, int] = {}  # guarded-by: _route_lock

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
        by the policy into each shard's sorted list; the policy's hot tier
        (its sketches summed over ``allgather``, then frozen against those
        lists; reference :581-587); the route index over all of them; the
        owned shard's pass key set."""
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
        # the hot tier (2d-grid) freezes here, where every rank holds the
        # same key set; the ranks' sketches are summed first over the same
        # collective, so every rank freezes the same set
        if allgather is not None and self.policy.wants_observe:
            self.policy.merge_observations(allgather)
        self.policy.freeze_hot(shard_keys)
        self.hot_frozen = sum(0 if h is None else int(h.size) for h in map(
            self.policy.hot_local_ids, range(self.num_shards)))
        if self.hot_frozen:
            stat_add("sharding_hot_keys_frozen", self.hot_frozen)
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
        """The owned shard's pass-end spill (reference :1066-1101): its
        store keeps the host's budget divided by the host's ranks, or a
        table-wide store (PS-backed) the whole budget through its
        primary; a spill on a store with no journal sink taints an
        attached journal. Returns the rows spilled."""
        return self.shard.check_need_limit_mem()

    def load_ssd_to_mem(self) -> int:
        """LoadSSD2Mem over the owned shard (box_wrapper.cc:1319, reference
        :1147-1151): its SSD tier's rows back into its host store, the
        residency dropped. Returns the rows moved (0 for a store without
        a tier of its own)."""
        return self.shard.load_ssd_to_mem()

    # the owned shard's tier, as the reference's checkpoint view reads its
    # owned shards' (:1222-1270); a store without a tier answers empty
    def spilled_snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        """(keys, rows) of the owned shard's SSD tier, at their effective
        values."""
        snap = getattr(self.shard.store, "spilled_snapshot", None)
        if snap is None:
            return (np.empty(0, np.uint64),
                    np.empty((0, self.layout.width), np.float32))
        with self.store_lock:
            return snap()

    def spilled_count(self) -> int:
        probe = getattr(self.shard.store, "spilled_count", None)
        if probe is None:
            return 0
        with self.store_lock:
            return int(probe())

    def spilled_keys(self) -> np.ndarray:
        """Every live tier key of the owned shard (save_base's anchor)."""
        fn = getattr(self.shard.store, "spilled_keys", None)
        if fn is None:
            return np.empty(0, np.uint64)
        with self.store_lock:
            return fn()

    def rebase_spill_ages(self) -> None:
        """Pin the owned shard tier's lazy-aging span (the full save's
        anchor; SpillTier.rebase)."""
        fn = getattr(self.shard.store, "rebase_spill_ages", None)
        if fn is not None:
            with self.store_lock:
                fn()

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

    # ------------------------------------------------- checkpoint plane
    @property
    def store_lock(self):
        """The owned shard's store lock: every store call holds it."""
        return self.shard.store_lock

    def attach_journal(self, journal) -> None:
        """Attach a train.journal.TouchedRowJournal (None detaches) to the
        owned shard (reference :498-520): its write-backs, day events and
        the store's tier moves record there, as the single-device
        table's do."""
        self.shard.attach_journal(journal)

    def save(self, path_prefix: str) -> None:
        """The owned shard's store at ``{path_prefix}.shard{s:03d}``, in the
        stores' own format (reference :1133-1136): a multi-process job's
        checkpoint, one file set a rank."""
        with self.store_lock:
            self.shard.store.save("%s.shard%03d" % (path_prefix, self.rank))

    def load(self, path_prefix: str) -> None:
        """Read the owned shard back from ``save``'s files (or the JAX
        package's, the same format); the residency drops, and an attached
        journal is tainted: the load is outside the checkpoint plane
        (reference :1138-1145)."""
        self.invalidate_residency()
        journal = self.shard._journal
        if journal is not None:
            journal.taint("per-shard store load outside the checkpoint "
                          "plane")
        with self.store_lock:
            self.shard.store.load("%s.shard%03d" % (path_prefix, self.rank))

    def load_split(self, paths: Sequence[str]) -> None:
        """Read the checkpoints at ``paths`` (any format ckpt_store sniffs:
        every shard file of a job, whatever policy wrote it, or one
        store's) and keep in the owned shard's store, replacing its rows,
        the keys the live policy routes to it, so a checkpoint written
        under one policy loads under another (reference :1287-1304). The
        residency drops, and an attached journal is tainted."""
        from paddlebox_tpu_torch.embedding.ckpt_store import load_sparse_any
        blobs = [load_sparse_any(p) for p in paths]
        if not blobs:
            raise ValueError("load_split needs at least one checkpoint")
        keys = np.concatenate([np.asarray(b["keys"], np.uint64)
                               for b in blobs])
        values = np.concatenate([np.asarray(b["values"], np.float32)
                                 for b in blobs])
        m = self.policy.shard_of(keys) == self.rank
        self.invalidate_residency()
        journal = self.shard._journal
        if journal is not None:
            journal.taint("per-shard store load outside the checkpoint "
                          "plane")
        with self.store_lock:
            self.shard.store.load_blob(dict(blobs[0], keys=keys[m],
                                            values=values[m]))

    def store_view(self):
        """The store CheckpointManager and run_day drive (reference
        :1153-1171). It needs every shard in this process: at world 1,
        where the key-mod policy routes every key to the one shard, it is
        the owned shard's store itself (CheckpointManager drops the
        table's residency at each stat rewrite and load); above world 1
        it raises the reference's TypeError, and so it does over a
        PS-backed shard, which checkpoints on the server."""
        if self.num_shards != 1:
            raise TypeError(
                "store_view needs every shard local (single process); "
                "multi-process jobs checkpoint per owned shard via "
                "table.save()")
        if isinstance(self.shard.store, PSBackedStore):
            raise TypeError("PS-backed shards checkpoint server-side "
                            "(PSClient.save), not through store_view")
        return self.shard.store

    @property
    def store(self):
        """``store_view()``: CheckpointManager reads a table's ``store``."""
        return self.store_view()

    # ------------------------------------------------ preload promote hooks
    def promote_prefetch_ctx(self):
        """The owned shard's (known_fn, store, lock) for train.preload's
        PromotePrefetcher, its store behind a _ShardLookupFacade: keys of
        other shards report not found and resolve at the pass boundary."""
        ctx = self.shard.promote_prefetch_ctx()
        if ctx is None:
            return None
        known, _, lock = ctx
        return known, _ShardLookupFacade(self), lock

    def accept_staged_rows(self, keys: np.ndarray, rows: np.ndarray) -> None:
        self.shard.accept_staged_rows(keys, rows)

    # ---------------------------------------------------------- batch index
    def bucketize(self, keys: np.ndarray, valid: np.ndarray,
                  plain: bool = False) -> ShardedBatchIndex:
        """Route one batch's keys (shard = policy.shard_of(key), the local
        id its position in the shard's sorted keys, deduplicated into
        bucket slots): the native router (rt_bucketize under key-mod,
        rt_bucketize_sharded over ``shard_of`` under any other policy;
        ``route_counts`` counts the calls of each), or with ``plain`` its
        numpy twin. Drops overflowed occurrences from ``valid``
        (contiguous bool) IN PLACE, and counts, warns or raises on
        overflow."""
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
            entry = "rt_bucketize" if keymod else "rt_bucketize_sharded"
            with self._route_lock:
                self.route_counts[entry] = self.route_counts.get(entry,
                                                                 0) + 1
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


class _ShardLookupFacade:
    """The owned shard's store as the preload prefetcher reads it
    (reference :1174-1195): lookup_present over any keys, those the live
    policy routes to other shards reported not found."""

    def __init__(self, table: ShardedPassTable) -> None:
        self._table = table

    def lookup_present(self, keys: np.ndarray):
        t = self._table
        keys = np.asarray(keys, np.uint64)
        out = np.zeros((keys.size, t.layout.width), np.float32)
        found = np.zeros(keys.size, bool)
        m = t.policy.shard_of(keys) == t.rank
        if m.any():
            out[m], found[m] = t.shard.store.lookup_present(keys[m])
        return out, found
