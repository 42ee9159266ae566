"""Sharding policies of the sharded pass table: which shard owns a key, and
which peers a rank exchanges with.

Counterpart of paddlebox_tpu/parallel/sharding.py:74-96, 198-290,
525-574. The port routes by key-mod, shard = key % P (the BoxPS
split_input_to_shard layout, heter_comm_inl.h:1117), which keeps the
native router's rt_bucketize. A policy owns two decisions here:

  route     ``shard_of``: [K] uint64 keys -> [K] int64 owning shards (the
            feed pass's shard assignment and the batch router);
  exchange  ``dest_plan``: the destination shards the host exchange ships
            to each rank, the owner map validated.

The reference's third decision, the device slab layout over a JAX mesh,
has no counterpart: each rank's slab is its own shard. Its other policies
(table-wise, the 2-D grid with its frequency sketch and replicated hot
tier) raise NotImplementedError naming their ROADMAP.md item.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.fleet.mesh_comm import MeshPolicyMismatch

# the ROADMAP.md A10 item that ports the other policies
OTHER_POLICIES = ("ROADMAP.md A10: the other sharding policies and the "
                  "hot tier")


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


class ShardingPolicy:
    """Owner of routing and the exchange plan for the sharded pass table;
    immutable during a pass."""

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

    def hot_local_ids(self, dest: int) -> Optional[np.ndarray]:
        """Replicated ids of shard ``dest`` (none without a hot tier)."""
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


class _NotPorted:
    """A reference policy or hot-tier class the port has not ported."""

    def __init__(self, *args, **kwargs) -> None:
        raise NotImplementedError("%s is not ported yet (%s)"
                                  % (type(self).__name__, OTHER_POLICIES))


class TableWisePolicy(_NotPorted, ShardingPolicy):
    """Each table whole on one shard (reference sharding.py:292-340)."""


class TwoDGridPolicy(_NotPorted, ShardingPolicy):
    """The table x row grid with a replicated hot tier (reference
    sharding.py:343-470)."""


class FreqSketch(_NotPorted):
    """The hot tier's bounded frequency sketch (reference
    sharding.py:124-195)."""


class ReplicatedHotTier(_NotPorted):
    """The hot rows every rank holds (reference sharding.py:473-522)."""


def validate_policy_agreement(fleet, policy: ShardingPolicy) -> None:
    """Every rank runs the same policy: one all_gather of describe();
    raises MeshPolicyMismatch naming every identity seen. Collective."""
    mine = policy.describe()
    parts = fleet.all_gather(
        np.frombuffer(mine.encode("utf-8"), np.uint8).copy())
    seen = sorted({bytes(np.asarray(p, np.uint8)).decode("utf-8")
                   for p in parts})
    if seen != [mine]:
        raise MeshPolicyMismatch(
            "sharding-policy mismatch across ranks: the cluster published "
            "%s — set sharding_policy identically on every rank" % seen)


def resolve_sharding_policy(num_shards: int,
                            name: Optional[str] = None) -> ShardingPolicy:
    """The policy ``name`` (default: ShardFlags().sharding_policy)
    selects. 'key-mod' is ported; the reference's 'table-wise' and
    '2d-grid' raise NotImplementedError; anything else ValueError."""
    if name is None:
        from paddlebox_tpu_torch.config.flags import ShardFlags
        name = ShardFlags().sharding_policy
    v = str(name).strip().lower()
    if v in ("key-mod", "keymod", "key_mod"):
        return KeyModPolicy(num_shards)
    if v in ("table-wise", "tablewise", "table_wise"):
        return TableWisePolicy(num_shards)
    if v in ("2d-grid", "2d_grid", "2dgrid", "grid"):
        return TwoDGridPolicy(num_shards)
    raise ValueError("sharding_policy must be 'key-mod', 'table-wise' or "
                     "'2d-grid', got %r" % v)
