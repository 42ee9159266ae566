"""One process a GPU: the port's mesh and its torch.distributed bring-up.

Counterpart of paddlebox_tpu/parallel/mesh.py:37-80 (init_distributed,
device_mesh_1d). The reference runs a P-device mesh in one process, or
one process a host over jax.distributed. The port has one topology: one
process a GPU, one shard a process, rank = shard = mesh position. A
``ShardMesh`` is that 1-D mesh seen from one rank: its world and rank, its
device, the device process group (NCCL where the device is CUDA, gloo on
the CPU) and a gloo group for host arrays (the fleet's collectives).
``device_mesh_2d`` gives the reference's hierarchical (node, chip) mesh
(mesh.py:82-103) over the same ranks: rank = node * chips + chip, key
routing still over the P flat shards, and two families of subgroups made
once with ``dist.new_group`` on the device backend: each node's chips
(the reduce-scatter and all_gather of the dense sync) and each chip
position's nodes (its all_reduce). device_mesh_grid and make_mesh wait
for their slice (ROADMAP.md A10).

``init_distributed`` joins the process group from the role's rendezvous
(fleet/role_maker.py: PBTPU_TRAINER_ID, PBTPU_TRAINERS_NUM and the
TCPStore at PBTPU_STORE_ENDPOINT), or from a store the caller passes (a
FileStore, a TCPStore). Every group gets ``timeout``: a rank whose peer
died fails its next collective then instead of waiting for ever. Nothing
falls back: a CUDA device without a GPU raises, and NCCL's failure is not
retried on gloo.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from paddlebox_tpu_torch.device import DeviceLike, resolve_device

# seconds a collective waits for its peers before it raises
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass
class ShardMesh:
    """world ranks, this one ``rank`` (its shard and mesh position), its
    ``device``, the device collectives' ``group`` and the host arrays'
    ``host_group`` (gloo). A 2-D mesh (``device_mesh_2d``) adds ``nodes``
    x ``chips`` and this rank's ``chip_group`` (its node's chips) and
    ``node_group`` (the ranks at its chip position); a 1-D mesh has
    neither."""

    world: int
    rank: int
    device: torch.device
    group: object
    host_group: object
    nodes: int = 1
    chips: int = 0
    chip_group: object = None
    node_group: object = None

    def __post_init__(self) -> None:
        if not self.chips:
            self.chips = self.world

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    @property
    def hier(self) -> bool:
        """A 2-D (node, chip) mesh: the dense sync goes hierarchical."""
        return self.chip_group is not None

    @property
    def chip(self) -> int:
        """This rank's position on the chip axis."""
        return self.rank % self.chips

    def close(self) -> None:
        """Destroy the process group (every group of this process)."""
        if dist.is_initialized():
            dist.destroy_process_group()


def device_mesh_2d(mesh: ShardMesh, n_nodes: Optional[int] = None,
                   chips_per_node: Optional[int] = None,
                   timeout: float = DEFAULT_TIMEOUT_S) -> ShardMesh:
    """The hierarchical (node, chip) view of the 1-D ``mesh`` (reference
    mesh.py:82-103): rank = node * chips_per_node + chip. ``n_nodes``
    defaults to world // chips_per_node, and ``chips_per_node`` to the
    host's GPUs on the card (the world on the CPU). Collective: every rank
    makes every subgroup, in the same order (each node's chip group, then
    each chip position's node group), on the device backend with
    ``timeout``."""
    world = mesh.world
    if chips_per_node is None:
        chips_per_node = (torch.cuda.device_count()
                          if mesh.device.type == "cuda" else world)
        if n_nodes is not None:
            chips_per_node = world // max(1, n_nodes)
    if n_nodes is None:
        n_nodes = world // max(1, chips_per_node)
    if n_nodes < 1 or chips_per_node < 1 or n_nodes * chips_per_node != world:
        raise ValueError("mesh needs %s nodes x %s chips, have %d ranks"
                         % (n_nodes, chips_per_node, world))
    td = datetime.timedelta(seconds=timeout)
    backend = mesh.backend
    chip_group = node_group = None
    for n in range(n_nodes):
        g = dist.new_group([n * chips_per_node + c
                            for c in range(chips_per_node)],
                           backend=backend, timeout=td)
        if mesh.rank // chips_per_node == n:
            chip_group = g
    for c in range(chips_per_node):
        g = dist.new_group([n * chips_per_node + c for n in range(n_nodes)],
                           backend=backend, timeout=td)
        if mesh.rank % chips_per_node == c:
            node_group = g
    return dataclasses.replace(mesh, nodes=n_nodes, chips=chips_per_node,
                               chip_group=chip_group, node_group=node_group)


def rank_device(device: DeviceLike, rank: int) -> torch.device:
    """The rank's device: ``device`` resolved, and a bare 'cuda' taken as
    GPU rank % device_count (one process a GPU on a host)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def connect_store(role: "RoleMaker", timeout: float = DEFAULT_TIMEOUT_S):
    """The rendezvous store of ``role``: a TCPStore client at its
    endpoint (the launcher or the caller hosts the server), or for a
    world of one without an endpoint a HashStore of this process. The
    run id (PBTPU_RUN_ID) prefixes every key."""
    td = datetime.timedelta(seconds=timeout)
    if role.store_endpoint:
        host, port = role.store_addr()
        store = dist.TCPStore(host, port, None, is_master=False, timeout=td)
    elif role.world == 1:
        store = dist.HashStore()
    else:
        raise ValueError("a world of %d ranks needs a rendezvous store "
                         "(PBTPU_STORE_ENDPOINT=host:port)" % role.world)
    return dist.PrefixStore(os.environ.get("PBTPU_RUN_ID", "0"), store)


def init_distributed(device: DeviceLike = None, rank: Optional[int] = None,
                     world: Optional[int] = None, store=None,
                     timeout: float = DEFAULT_TIMEOUT_S) -> ShardMesh:
    """Join the process group: rank and world from the role (the
    environment) unless given, the store from ``connect_store`` unless
    given; NCCL on a CUDA device (set as the process's current device),
    gloo on the CPU, and a gloo group for host arrays, each with
    ``timeout``. Raises if torch.distributed is already initialized."""
    # fleet/ imports this module: its role maker is imported at the call
    from paddlebox_tpu_torch.fleet.role_maker import RoleMaker
    role = RoleMaker(rank, world)
    dev = rank_device(device, role.rank)
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized in "
                           "this process")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if store is None:
        store = connect_store(role, timeout)
    td = datetime.timedelta(seconds=timeout)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=store, rank=role.rank,
                            world_size=role.world, timeout=td)
    host = dist.new_group(backend="gloo", timeout=td)
    return ShardMesh(role.world, role.rank, dev, dist.group.WORLD, host)
