"""Sharding policies of the sharded pass table: which shard owns a key,
which peers a rank exchanges with, and the replicated hot tier.

Counterpart of paddlebox_tpu/parallel/sharding.py. A policy owns two
decisions here:

  route     ``shard_of``: [K] uint64 keys -> [K] int64 owning shards (the
            feed pass's shard assignment, the batch router, the
            checkpoint's and the prefetcher's routing). Key-mod keeps the
            native router's rt_bucketize; every other policy routes
            through its rt_bucketize_sharded over the shards ``shard_of``
            gives;
  exchange  ``dest_plan``: the destination shards the host exchange ships
            to each rank, the owner map validated; and the 2-D grid's
            hot-key wire filter (``hot_local_ids``): the frozen hot ids
            never travel the uid wire, senders drop them and the owner
            adds its whole hot set back.

The three policies:

  key-mod     shard = key % P (the BoxPS split_input_to_shard layout,
              heter_comm_inl.h:1117).
  table-wise  shard = table(key) % P: each table whole on one shard, its
              traffic only to its owner.
  2d-grid     shard = table_group(key) * R + key % R: a table axis of P / R
              groups by a row axis of R. Its hot tier: a bounded frequency
              sketch (FreqSketch) fed by the feed pass's key stream,
              summed across the ranks at the feed pass's end
              (``merge_observations``) and frozen against the pass's
              shard key lists (``freeze_hot``); ReplicatedHotTier mirrors
              the frozen keys' rows.

A key's table is (key >> sharding_table_shift) % sharding_num_tables.

The reference's third decision, the device slab layout over a JAX mesh
(``slab_spec`` / ``slab_sharding``, GSPMD placements), has no counterpart:
the port runs one shard a process, and rank t * R + r is grid position
(t, r) (ROADMAP.md C).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.utils.lockwatch import make_lock

# the 2-D grid's axes, as the reference names them
TABLE_AXIS = "table"
ROW_AXIS = "row"


def default_dest_plan(mesh, local_positions: Sequence[int],
                      num_devices: int) -> List[List[int]]:
    """Per-rank destination lists for the host exchange, validated against
    the mesh's ownership map: every position has exactly one owner, and
    this rank stages for the positions it owns."""
    owner = mesh.rank_of_position()
    missing = [d for d in range(num_devices) if d not in owner]
    if missing:
        raise RuntimeError("host plane: mesh positions %s have no owning "
                           "rank" % missing)
    if sorted(mesh.positions_of.get(mesh.rank, [])) != sorted(
            local_positions):
        raise RuntimeError("host plane: this rank owns positions %s but is "
                           "staging for %s"
                           % (mesh.positions_of.get(mesh.rank),
                              list(local_positions)))
    return [mesh.positions_of[r] for r in range(mesh.world)]


def partition_pull(policy: "ShardingPolicy", keys: np.ndarray,
                   hot_keys: Optional[np.ndarray] = None,
                   hot_dest: int = 0) -> List[np.ndarray]:
    """One pull's key positions split by the box that serves them: each
    key's owner by ``policy.shard_of``, and the replicated ``hot_keys``
    (sorted unique uint64) at ``hot_dest % num_shards`` instead. One
    position array a shard; together a permutation of arange(len(keys))."""
    keys = np.asarray(keys, np.uint64).reshape(-1)
    dest = np.asarray(policy.shard_of(keys), np.int64).copy()
    if hot_keys is not None and len(hot_keys) and keys.size:
        hot_keys = np.asarray(hot_keys, np.uint64)
        idx = np.searchsorted(hot_keys, keys)
        hot = (idx < hot_keys.size) & (
            hot_keys[np.minimum(idx, hot_keys.size - 1)] == keys)
        dest[hot] = int(hot_dest) % policy.num_shards
    return [np.nonzero(dest == s)[0] for s in range(policy.num_shards)]


class FreqSketch:
    """A bounded frequency count with halving decay: counts in a dict of at
    most ``cap`` entries; past it every count halves and the zeros drop.
    ``observe`` runs on the dataset's reader thread, so it locks: one
    np.unique a call, then a dict update a unique key."""

    def __init__(self, cap: int = 1 << 16) -> None:
        self.cap = int(cap)
        self._lock = make_lock("FreqSketch._lock")
        self._freq: Dict[int, int] = {}  # guarded-by: _lock

    def observe(self, keys: np.ndarray) -> None:
        keys = np.asarray(keys, np.uint64)
        if not keys.size:
            return
        uniq, counts = np.unique(keys, return_counts=True)
        with self._lock:
            freq = self._freq
            for k, c in zip(uniq.tolist(), counts.tolist()):
                freq[k] = freq.get(k, 0) + c
            if len(freq) > self.cap:
                self._freq = {k: c >> 1 for k, c in freq.items() if c >> 1}

    def items(self):
        """(keys [n] uint64, counts [n] int64): the snapshot the ranks
        exchange at the merge."""
        with self._lock:
            ks = np.fromiter(self._freq.keys(), np.uint64, len(self._freq))
            cs = np.fromiter(self._freq.values(), np.int64, len(self._freq))
        return ks, cs

    @classmethod
    def summed(cls, parts, cap: int) -> "FreqSketch":
        """A new sketch of the element-wise sum of the (keys, counts)
        snapshots ``parts`` (in any order: every rank summing the same
        parts holds the same sketch); past ``cap`` entries the heaviest
        ``cap`` stay (count descending, then key ascending). The inputs
        are not changed, so each rank's sketch keeps its own history and a
        merge at every pass counts each occurrence once."""
        total: Dict[int, int] = {}
        for ks, cs in parts:
            for k, c in zip(np.asarray(ks, np.uint64).tolist(),
                            np.asarray(cs, np.int64).tolist()):
                total[k] = total.get(k, 0) + c
        if len(total) > cap:
            keep = sorted(total.items(), key=lambda kv: (-kv[1], kv[0]))
            total = dict(keep[:cap])
        out = cls(cap)
        out._freq = total
        return out

    def hot_keys(self, threshold: int) -> np.ndarray:
        """The sorted keys whose count reached ``threshold`` (none at
        threshold <= 0)."""
        if threshold <= 0:
            return np.empty(0, np.uint64)
        with self._lock:
            ks = [k for k, c in self._freq.items() if c >= threshold]
        return np.sort(np.asarray(ks, np.uint64))


class ShardingPolicy:
    """Owner of routing and the exchange plan for the sharded pass table;
    immutable during a pass (the hot tier freezes at the feed pass's end,
    where every rank holds the same key set)."""

    name = "abstract"
    #: True only where ``shard_of`` is exactly key % num_shards: the
    #: bucketize then runs the native rt_bucketize
    native_keymod = False
    #: True where the policy wants the feed pass's key stream
    wants_observe = False

    def __init__(self, num_shards: int) -> None:
        if num_shards <= 0:
            raise ValueError("num_shards must be positive")
        self.num_shards = int(num_shards)

    def shard_of(self, keys: np.ndarray) -> np.ndarray:
        """[K] uint64 feasigns -> [K] int64 owning shards in [0,
        num_shards)."""
        raise NotImplementedError

    def dest_plan(self, mesh, local_positions: Sequence[int],
                  num_devices: int) -> List[List[int]]:
        return default_dest_plan(mesh, local_positions, num_devices)

    def observe(self, keys: np.ndarray) -> None:
        """The feed pass's key stream (a no-op without a hot tier)."""

    def merge_observations(self, allgather) -> None:
        """Sum the ranks' sketches over ``allgather`` (a no-op without a
        hot tier)."""

    def freeze_hot(self, shard_keys: Sequence[np.ndarray]) -> None:
        """Resolve the hot keys against the pass's per-shard sorted key
        lists (a no-op without a hot tier)."""

    def hot_local_ids(self, dest: int) -> Optional[np.ndarray]:
        """Sorted int32 pass-local ids of shard ``dest`` kept off the uid
        wire, or None."""
        return None

    def describe(self) -> str:
        """The identity the ranks compare at the exchange's bring-up."""
        return "%s/%d" % (self.name, self.num_shards)


class KeyModPolicy(ShardingPolicy):
    """shard = key % P: the BoxPS/HeterComm layout."""

    name = "key-mod"
    native_keymod = True

    def shard_of(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, np.uint64)
        return (keys % np.uint64(self.num_shards)).astype(np.int64)


class TableWisePolicy(ShardingPolicy):
    """Each table whole on one shard: shard = table(key) % P."""

    name = "table-wise"

    def __init__(self, num_shards: int, num_tables: int,
                 table_shift: int = 48) -> None:
        super().__init__(num_shards)
        if num_tables <= 0:
            raise ValueError("num_tables must be positive")
        if not 0 <= int(table_shift) < 64:
            raise ValueError("table_shift must be in [0, 64)")
        self.num_tables = int(num_tables)
        self.table_shift = int(table_shift)

    def table_of(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, np.uint64)
        return ((keys >> np.uint64(self.table_shift))
                % np.uint64(self.num_tables)).astype(np.int64)

    def shard_of(self, keys: np.ndarray) -> np.ndarray:
        return self.table_of(keys) % self.num_shards

    def describe(self) -> str:
        return "%s/%d/t%d>>%d" % (self.name, self.num_shards,
                                  self.num_tables, self.table_shift)


class TwoDGridPolicy(TableWisePolicy):
    """Table axis x row axis: shard = table_group * R + key % R, with the
    replicated hot tier (module docstring). Senders drop a frozen hot id
    from the uid wire and its owner adds its whole hot set back, so the
    staged uid vector may hold hot ids a step did not touch: their merged
    gradients are zero and the push leaves such a row unchanged."""

    name = "2d-grid"

    def __init__(self, num_shards: int, num_tables: int, rows: int,
                 table_shift: int = 48, hot_threshold: int = 0,
                 hot_cap: int = 1024, sketch_cap: int = 1 << 16) -> None:
        super().__init__(num_shards, num_tables, table_shift)
        if rows <= 0 or num_shards % rows:
            raise ValueError("grid rows (%d) must divide num_shards (%d) "
                             "evenly" % (rows, num_shards))
        self.rows = int(rows)
        self.table_groups = self.num_shards // self.rows
        self.hot_threshold = int(hot_threshold)
        self.hot_cap = int(hot_cap)
        self.sketch = FreqSketch(sketch_cap)
        # the ranks' summed view (merge_observations); ``sketch`` keeps
        # this rank's history only
        self._merged_sketch: Optional[FreqSketch] = None
        self._hot_local: Dict[int, np.ndarray] = {}
        self._hot_keys = np.empty(0, np.uint64)

    def shard_of(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, np.uint64)
        group = self.table_of(keys) % self.table_groups
        row = (keys % np.uint64(self.rows)).astype(np.int64)
        return group * self.rows + row

    @property
    def wants_observe(self) -> bool:
        return self.hot_threshold > 0

    def observe(self, keys: np.ndarray) -> None:
        if self.hot_threshold > 0:
            self.sketch.observe(keys)

    def merge_observations(self, allgather) -> None:
        """Every rank's sketch snapshot over ``allgather`` (one uint64
        payload: n, the keys, the counts), summed into the merged view."""
        if self.hot_threshold <= 0:
            return
        ks, cs = self.sketch.items()
        payload = np.concatenate([np.array([ks.size], np.uint64), ks,
                                  cs.view(np.uint64)])
        parts = []
        for p in allgather(payload):
            p = np.asarray(p, np.uint64)
            n = int(p[0])
            parts.append((p[1:1 + n], p[1 + n:1 + 2 * n].view(np.int64)))
        self._merged_sketch = FreqSketch.summed(parts, self.sketch.cap)

    def freeze_hot(self, shard_keys: Sequence[np.ndarray]) -> None:
        """The hot keys (the merged sketch's, this rank's without a merge)
        at or above hot_threshold that are in the pass, by shard: their
        local ids, ascending. Raises ValueError where a shard holds more
        than hot_cap."""
        self._hot_local = {}
        self._hot_keys = np.empty(0, np.uint64)
        if self.hot_threshold <= 0:
            return
        sk = (self._merged_sketch if self._merged_sketch is not None
              else self.sketch)
        hot = sk.hot_keys(self.hot_threshold)
        if not hot.size:
            return
        shard = self.shard_of(hot)
        kept = []
        for s in range(self.num_shards):
            hk = hot[shard == s]
            if not hk.size:
                continue
            keys = np.asarray(shard_keys[s])
            pos = np.searchsorted(keys, hk)
            ok = pos < keys.size
            ok[ok] = keys[pos[ok]] == hk[ok]
            if not ok.any():
                continue
            local = pos[ok].astype(np.int32)
            if local.size > self.hot_cap:
                raise ValueError(
                    "2d-grid hot tier: shard %d has %d hot keys, over "
                    "sharding_hot_cap=%d — raise the cap or the threshold "
                    "(an unbounded replicated set defeats the wire saving "
                    "it exists for)" % (s, local.size, self.hot_cap))
            self._hot_local[s] = local
            kept.append(hk[ok])
        if kept:
            self._hot_keys = np.concatenate(kept)
            self._hot_keys.sort()

    def hot_local_ids(self, dest: int) -> Optional[np.ndarray]:
        return self._hot_local.get(dest)

    def hot_keys_frozen(self) -> np.ndarray:
        """The frozen pass's sorted hot keys (what ReplicatedHotTier
        mirrors)."""
        return self._hot_keys

    def describe(self) -> str:
        # hot_cap is part of the identity: a split cap would make
        # freeze_hot raise on some ranks only
        return "%s/%d/t%d>>%d/r%d/h%d/c%d" % (
            self.name, self.num_shards, self.num_tables, self.table_shift,
            self.rows, self.hot_threshold, self.hot_cap)


class ReplicatedHotTier:
    """The frozen hot keys' rows on the host: ``refresh`` reads each from
    its owner's store once a pass, ``lookup`` serves any subset, the same
    bits as a read of the owner's store."""

    def __init__(self, policy: TwoDGridPolicy) -> None:
        self.policy = policy
        self._keys = np.empty(0, np.uint64)
        self._rows = np.empty((0, 0), np.float32)

    def refresh(self, stores: Sequence) -> int:
        """Mirror the policy's frozen hot keys from their owners' stores
        (``stores[s]``; None where this process holds no shard s: its keys
        are skipped). Returns the rows mirrored."""
        hot = self.policy.hot_keys_frozen()
        self._keys = np.empty(0, np.uint64)
        self._rows = np.empty((0, 0), np.float32)
        if not hot.size:
            return 0
        shard = self.policy.shard_of(hot)
        keys_out, rows_out = [], []
        for s in range(self.policy.num_shards):
            st = stores[s] if s < len(stores) else None
            if st is None:
                continue
            hk = hot[shard == s]
            if hk.size:
                keys_out.append(hk)
                rows_out.append(np.asarray(st.lookup(hk), np.float32))
        if not keys_out:
            return 0
        keys = np.concatenate(keys_out)
        rows = np.vstack(rows_out)
        order = np.argsort(keys, kind="stable")
        self._keys, self._rows = keys[order], rows[order]
        return int(keys.size)

    def lookup(self, keys: np.ndarray):
        """(rows [K, W], found [K]); rows not found are zero."""
        from paddlebox_tpu_torch.embedding.pass_table import sorted_member
        keys = np.asarray(keys, np.uint64)
        W = self._rows.shape[1] if self._rows.size else 0
        rows = np.zeros((keys.size, W), np.float32)
        pos, found = sorted_member(self._keys, keys)
        if found.any():
            rows[found] = self._rows[pos[found]]
        return rows, found


def validate_policy_agreement(fleet, policy: ShardingPolicy) -> None:
    """Every rank runs the same policy: one all_gather of describe();
    raises MeshPolicyMismatch naming every identity seen. Collective."""
    # here, not at the top: the serving plane imports this module and must
    # not load fleet/ (and with it torch)
    from paddlebox_tpu_torch.fleet.mesh_comm import MeshPolicyMismatch
    mine = policy.describe()
    parts = fleet.all_gather(
        np.frombuffer(mine.encode("utf-8"), np.uint8).copy())
    seen = sorted({bytes(np.asarray(p, np.uint8)).decode("utf-8")
                   for p in parts})
    if seen != [mine]:
        raise MeshPolicyMismatch(
            "sharding-policy mismatch across ranks: the cluster published "
            "%s — set sharding_policy identically on every rank" % seen)


def grid_rows_auto(num_shards: int) -> int:
    """The largest divisor of P not above sqrt(P)."""
    return max(r for r in range(1, int(num_shards ** 0.5) + 1)
               if num_shards % r == 0)


def resolve_sharding_policy(num_shards: int, name: Optional[str] = None,
                            flags=None) -> ShardingPolicy:
    """The policy ``name`` (default: the flags' sharding_policy) selects,
    with its parameters from ``flags`` (a ShardFlags; default
    ShardFlags()): 'key-mod', 'table-wise' or '2d-grid' under their
    aliases, the grid's rows automatic at sharding_grid_rows <= 0.
    Anything else raises ValueError."""
    if flags is None:
        from paddlebox_tpu_torch.config.flags import ShardFlags
        flags = ShardFlags()
    v = str(name if name is not None
            else flags.sharding_policy).strip().lower()
    if v in ("key-mod", "keymod", "key_mod"):
        return KeyModPolicy(num_shards)
    num_tables = int(flags.sharding_num_tables)
    shift = int(flags.sharding_table_shift)
    if v in ("table-wise", "tablewise", "table_wise"):
        return TableWisePolicy(num_shards, num_tables, table_shift=shift)
    if v in ("2d-grid", "2d_grid", "2dgrid", "grid"):
        rows = int(flags.sharding_grid_rows)
        if rows <= 0:
            rows = grid_rows_auto(num_shards)
        return TwoDGridPolicy(
            num_shards, num_tables, rows, table_shift=shift,
            hot_threshold=int(flags.sharding_hot_threshold),
            hot_cap=int(flags.sharding_hot_cap))
    raise ValueError("sharding_policy must be 'key-mod', 'table-wise' or "
                     "'2d-grid', got %r" % v)
