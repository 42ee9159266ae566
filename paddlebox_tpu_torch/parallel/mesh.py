"""One process a GPU: the port's mesh and its torch.distributed bring-up.

Counterpart of paddlebox_tpu/parallel/mesh.py (init_distributed,
device_mesh_1d, device_mesh_2d, make_mesh). The reference runs a P-device
mesh in one process, or one process a host over jax.distributed. The port
has one topology: one process a GPU, one shard a process, rank = shard =
mesh position. A ``ShardMesh`` is that 1-D mesh seen from one rank: its
world and rank, its device, the device process group (NCCL where the
device is CUDA, gloo on the CPU) and a gloo group for host arrays (the
fleet's collectives). ``device_mesh_2d`` gives the reference's
hierarchical (node, chip) mesh (mesh.py:82-103) over the same ranks: rank
= node * chips + chip, key routing still over the P flat shards, and two
families of subgroups made once with ``dist.new_group`` on the device
backend: each node's chips (the reduce-scatter and all_gather of the dense
sync) and each chip position's nodes (its all_reduce).

``make_mesh`` (reference :125-137) lays the first prod(sizes) ranks out
row-major over a MeshConfig's (data, model, pipeline) axes, as the
reference reshapes ``devs[:need]``, and ``device_mesh_1d`` (:67-72) puts
the first n ranks on one axis: an ``AxisMesh`` says this rank's coordinate
and its process group on each axis, the groups made once with
``dist.new_group`` on the device backend. An axis of size 1 is
``tensor_parallel.LOCAL``: no collective and no send (NCCL cannot send a
rank to itself). The reference's device_mesh_grid is declined: the port
has no slab placement to give a (table, row) grid, and rank t * R + r is
grid position (t, r) already (parallel/sharding.py's TwoDGridPolicy routes
on it).

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
import itertools
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from paddlebox_tpu_torch.config.configs import MeshConfig
from paddlebox_tpu_torch.device import DeviceLike, resolve_device
from paddlebox_tpu_torch.parallel.tensor_parallel import LOCAL

# the 1-D axis that is both data- and table-shard-parallel, as BoxPS's
BOX_AXIS = "dp"

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


@dataclasses.dataclass
class AxisMesh:
    """A named mesh over the first prod(``sizes``) ranks, row-major, seen
    from one rank: its world ``rank``, its ``coords`` on each axis and its
    ``groups`` there (LOCAL on an axis of size 1), and the ``device`` its
    ShardMesh put it on (None without one). A rank past the mesh has
    ``coords`` and ``groups`` None."""

    names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: int
    coords: Optional[Tuple[int, ...]]
    groups: Optional[Tuple[object, ...]]
    device: Optional[torch.device] = None

    @property
    def size(self) -> int:
        """The ranks the mesh holds."""
        n = 1
        for s in self.sizes:
            n *= s
        return n

    @property
    def shape(self) -> dict:
        """{axis name: size}, as jax.sharding.Mesh.shape."""
        return dict(zip(self.names, self.sizes))

    @property
    def member(self) -> bool:
        return self.coords is not None

    def group(self, name: str):
        """This rank's process group on axis ``name`` (LOCAL at size 1)."""
        if not self.member:
            raise ValueError("rank %d is outside the %s mesh"
                             % (self.rank, self.shape))
        return self.groups[self.names.index(name)]


def _world_of(mesh: Optional[ShardMesh]):
    """(world, rank, device, backend) of ``mesh``, else of the default
    process group, else of this process alone."""
    if mesh is not None:
        return mesh.world, mesh.rank, mesh.device, mesh.backend
    if dist.is_available() and dist.is_initialized():
        return (dist.get_world_size(), dist.get_rank(), None,
                dist.get_backend())
    return 1, 0, None, None


def _axis_mesh(names, sizes, need_msg: str, mesh: Optional[ShardMesh],
               timeout: float) -> AxisMesh:
    """The AxisMesh of ``names`` x ``sizes``; ``need_msg`` % (need, world)
    is the error of a mesh larger than the world. Collective: every rank
    makes every group, axis by axis, each axis's groups in row-major order
    of the other coordinates."""
    world, rank, device, backend = _world_of(mesh)
    names, sizes = tuple(names), tuple(int(s) for s in sizes)
    need = 1
    for s in sizes:
        need *= s
    if need > world:
        raise ValueError(need_msg % (need, world))
    coords = None
    if rank < need:
        coords, r = [], rank
        for s in reversed(sizes):
            coords.append(r % s)
            r //= s
        coords = tuple(reversed(coords))
    strides = [1] * len(sizes)
    for k in range(len(sizes) - 2, -1, -1):
        strides[k] = strides[k + 1] * sizes[k + 1]
    td = datetime.timedelta(seconds=timeout)
    groups = []
    for k, size in enumerate(sizes):
        mine = LOCAL
        if size > 1:
            others = [range(s) if j != k else range(1)
                      for j, s in enumerate(sizes)]
            for pos in itertools.product(*others):
                base = sum(p * st for p, st in zip(pos, strides))
                ranks = [base + i * strides[k] for i in range(size)]
                g = dist.new_group(ranks, backend=backend, timeout=td)
                if rank in ranks:
                    mine = g
        groups.append(mine)
    return AxisMesh(names, sizes, rank, coords,
                    tuple(groups) if coords is not None else None, device)


def device_mesh_1d(n_devices: Optional[int] = None, axis: str = BOX_AXIS,
                   mesh: Optional[ShardMesh] = None,
                   timeout: float = DEFAULT_TIMEOUT_S) -> AxisMesh:
    """The first ``n_devices`` ranks (default: all) on one axis ``axis``
    (reference mesh.py:67-72) of ``mesh``'s world (None: the default
    process group's, or this process alone). Collective."""
    world = _world_of(mesh)[0]
    n = n_devices or world
    return _axis_mesh((axis,), (n,), "requested %d devices, have %d", mesh,
                      timeout)


def make_mesh(cfg: MeshConfig, mesh: Optional[ShardMesh] = None,
              timeout: float = DEFAULT_TIMEOUT_S) -> AxisMesh:
    """The (data, model, pipeline) mesh of ``cfg`` (reference mesh.py:
    125-137): an axis where its size is above 1 or ``cfg.axis_names``
    names it, in that order; rank = row-major position over the first
    prod(sizes) ranks of ``mesh``'s world (None: the default process
    group's, or this process alone). A mesh larger than the world raises.
    Collective: every rank of the world calls it."""
    names, sizes = [], []
    for name, size in zip(("data", "model", "pipeline"),
                          (cfg.data, cfg.model, cfg.pipeline)):
        if size > 1 or name in cfg.axis_names:
            names.append(name)
            sizes.append(size)
    return _axis_mesh(names, sizes, "mesh needs %d devices, have %d", mesh,
                      timeout)


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
