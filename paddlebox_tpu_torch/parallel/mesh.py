"""One process a GPU: the port's mesh and its torch.distributed bring-up.

Counterpart of paddlebox_tpu/parallel/mesh.py:37-80 (init_distributed,
device_mesh_1d). The reference runs a P-device mesh in one process, or
one process a host over jax.distributed. The port has one topology: one
process a GPU, one shard a process, rank = shard = mesh position. A
``ShardMesh`` is that 1-D mesh seen from one rank: its world and rank, its
device, the device process group (NCCL where the device is CUDA, gloo on
the CPU) and a gloo group for host arrays (the fleet's collectives).
device_mesh_2d, device_mesh_grid and make_mesh (a 2-D node x chip mesh)
wait for their slice (ROADMAP.md A10).

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
from paddlebox_tpu_torch.fleet.role_maker import RoleMaker

# seconds a collective waits for its peers before it raises
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass
class ShardMesh:
    """world ranks, this one ``rank`` (its shard and mesh position), its
    ``device``, the device collectives' ``group`` and the host arrays'
    ``host_group`` (gloo)."""

    world: int
    rank: int
    device: torch.device
    group: object
    host_group: object

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def close(self) -> None:
        """Destroy the process group (every group of this process)."""
        if dist.is_initialized():
            dist.destroy_process_group()


def rank_device(device: DeviceLike, rank: int) -> torch.device:
    """The rank's device: ``device`` resolved, and a bare 'cuda' taken as
    GPU rank % device_count (one process a GPU on a host)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def connect_store(role: RoleMaker, timeout: float = DEFAULT_TIMEOUT_S):
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
