"""Fleet: the multi-process control plane on torch.distributed.

Counterpart of paddlebox_tpu/fleet/fleet.py:42-186 (fleet.init and the
GlooWrapper host collectives, gloo_wrapper.h:185-244). The reference
rendezvouses through its own TCP key-value store and runs its host
collectives over it; the port rendezvouses at a torch.distributed
TCPStore at the role's endpoint (parallel/mesh.py connect_store) and runs
them on the gloo host group of its ShardMesh. They move small host data:
the feed pass's key union, batch-count equalization, metric partials.

Method names and results are the reference's: ``all_gather`` returns
every rank's array in rank order (any length and dtype: the headers go
first), ``all_reduce`` reduces those with numpy in rank order (sum, max,
min), ``metric_allreduce`` and ``equalize_batches`` are the adapters the
metrics and BoxDataset.split_batches take. Every rank calls the same
collectives in the same order. A world of one still runs them through
its group.

Above world 1 the fleet also runs the reference's KV store
(fleet/store.py): at ``init_distributed`` rank 0 starts a KVStoreServer
on a free port and publishes its endpoint through the torch.distributed
store the ranks rendezvous at, and every rank keeps a TcpStoreClient
(``store_client``; None at world 1, as in the reference). The cluster
aggregator's store transport (obs/aggregate.py), elastic heartbeats
(fleet/elastic.py) and the telemetry namespace (``obs_namespace``) ride
it. ``make_shuffler`` builds the cross-host instance shuffle's
TcpShuffler (data/shuffle.py), its endpoints exchanged by ``all_gather``:
the reference's MeshShuffler rides its own socket mesh, which the port
does not have (its MeshComm is gloo's all_to_all), so under both
hostplane values the port builds the TcpShuffler (ROADMAP.md C).
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from paddlebox_tpu_torch.device import DeviceLike
from paddlebox_tpu_torch.fleet.mesh_comm import (DTYPES, MeshComm,
                                                 MeshConnectError,
                                                 MeshPolicyMismatch, header)
from paddlebox_tpu_torch.fleet.role_maker import RoleMaker
from paddlebox_tpu_torch.fleet.store import KVStoreServer, TcpStoreClient
from paddlebox_tpu_torch.parallel.mesh import (DEFAULT_TIMEOUT_S, ShardMesh,
                                               connect_store,
                                               init_distributed)

_OPS = {
    "sum": lambda arrs: np.sum(arrs, axis=0),
    "max": lambda arrs: np.max(arrs, axis=0),
    "min": lambda arrs: np.min(arrs, axis=0),
}


class Fleet:
    def __init__(self) -> None:
        self.role: Optional[RoleMaker] = None
        self.mesh: Optional[ShardMesh] = None
        self._store = None
        self._comm: Optional[MeshComm] = None
        self._comm_policy: Optional[str] = None
        self._timeout = DEFAULT_TIMEOUT_S
        self._kv_server: Optional[KVStoreServer] = None
        self._kv_client: Optional[TcpStoreClient] = None
        self._run_id = "0"

    # ----------------------------------------------------------------- init
    def init(self, role: Optional[RoleMaker] = None, store=None) -> "Fleet":
        """The role (the environment's unless given) and, optionally, the
        rendezvous store init_distributed joins (a FileStore or TCPStore;
        default: the role's endpoint)."""
        self.role = role or RoleMaker()
        self._store = store
        self._run_id = os.environ.get("PBTPU_RUN_ID", "0")
        return self

    @property
    def initialized(self) -> bool:
        return self.role is not None

    def init_distributed(self, timeout: float = DEFAULT_TIMEOUT_S,
                         device: DeviceLike = None) -> ShardMesh:
        """Join the process group for ``device`` (parallel/mesh.py
        init_distributed: NCCL on CUDA, gloo on the CPU, a gloo host
        group) within ``timeout`` seconds, the groups' and the
        collectives' default timeout after it (the reference's first
        argument); once, the mesh is kept. Call after init()."""
        if self.role is None:
            raise RuntimeError("Fleet.init_distributed before init()")
        if self.mesh is None:
            self._timeout = float(timeout)
            store = self._store or connect_store(self.role, timeout)
            self.mesh = init_distributed(device, self.role.rank,
                                         self.role.world, store=store,
                                         timeout=timeout)
            if self.role.world > 1:
                self._start_kv_store(store)
        return self.mesh

    def _my_host(self) -> str:
        """This rank's address as its peers dial it: PBTPU_HOST, else the
        loopback for a rendezvous on this machine (or none), else the
        host name."""
        host = os.environ.get("PBTPU_HOST")
        if host:
            return host
        store_host = (self.role.store_addr()[0] if self.role.store_endpoint
                      else "127.0.0.1")
        if store_host in ("127.0.0.1", "localhost", "::1"):
            return "127.0.0.1"
        return socket.gethostname()

    def _start_kv_store(self, store) -> None:
        """Rank 0 serves the KV store on a free port and publishes
        host:port under ``pbtpu/kv_endpoint`` in the rendezvous store;
        every rank connects a client."""
        key = "pbtpu/kv_endpoint"
        if self.role.rank == 0:
            host = self._my_host()
            bind = host if host in ("127.0.0.1", "localhost") else "0.0.0.0"
            self._kv_server = KVStoreServer(bind, 0)
            store.set(key, "%s:%d" % (host, self._kv_server.port))
        host, port = store.get(key).decode().rsplit(":", 1)
        self._kv_client = TcpStoreClient(host, int(port),
                                         timeout=self._timeout)

    def store_client(self) -> Optional[TcpStoreClient]:
        """This rank's KV store client (None at world 1 and before
        init_distributed)."""
        return self._kv_client

    def obs_namespace(self) -> str:
        """The run-scoped key namespace of the telemetry reports."""
        return "%s/obs" % self._run_id

    def worker_index(self) -> int:
        return self.role.rank

    def worker_num(self) -> int:
        return self.role.world

    def is_first_worker(self) -> bool:
        return self.role.is_first_worker()

    def _group(self):
        if self.mesh is None:
            raise RuntimeError("fleet collectives need init_distributed() "
                               "first")
        return self.mesh.host_group

    # ---------------------------------------------------------- collectives
    def _wait(self, work, timeout: Optional[float]) -> None:
        """Wait for a collective's ``work`` for ``timeout`` seconds (None:
        the group's timeout, init_distributed's); past it, raise."""
        if timeout is None:
            work.wait()
        else:
            work.wait(timeout=datetime.timedelta(seconds=float(timeout)))

    def barrier_worker(self, timeout: Optional[float] = None) -> None:
        """All ranks reach this point (GlooWrapper::Barrier) within
        ``timeout`` seconds (None: the group's timeout)."""
        self._wait(dist.barrier(group=self._group(), async_op=True), timeout)

    def all_gather(self, arr, timeout: Optional[float] = None
                   ) -> List[np.ndarray]:
        """[rank0_arr, rank1_arr, ...] on every rank
        (GlooWrapper::AllGather): each rank's header (bytes, dtype, shape)
        first, then the payloads padded to the largest; each of the two
        exchanges within ``timeout`` seconds (None: the group's
        timeout)."""
        group = self._group()
        world = self.role.world
        a = np.ascontiguousarray(np.asarray(arr))
        head = torch.tensor(header(a), dtype=torch.int64)
        heads = [torch.empty_like(head) for _ in range(world)]
        self._wait(dist.all_gather(heads, head, group=group, async_op=True),
                   timeout)
        heads = [h.numpy() for h in heads]
        width = max(int(h[0]) for h in heads)
        buf = np.zeros(width, np.uint8)
        buf[:a.nbytes] = a.reshape(-1).view(np.uint8)
        bufs = [torch.empty(width, dtype=torch.uint8) for _ in range(world)]
        self._wait(dist.all_gather(bufs, torch.from_numpy(buf), group=group,
                                   async_op=True), timeout)
        out = []
        for h, b in zip(heads, bufs):
            n, code, ndim = int(h[0]), int(h[1]), int(h[2])
            shape = tuple(int(d) for d in h[3:3 + ndim])
            out.append(b.numpy()[:n].view(DTYPES[code]).reshape(shape))
        return out

    def all_reduce(self, arr, op: str = "sum",
                   timeout: Optional[float] = None) -> np.ndarray:
        """Elementwise reduce across ranks (GlooWrapper::AllReduce), in
        rank order on every rank, so every rank gets the same bits; the
        gather within ``timeout`` seconds, as all_gather's."""
        if op not in _OPS:
            raise ValueError("allreduce op must be one of %s" % list(_OPS))
        return _OPS[op](np.stack(self.all_gather(np.asarray(arr), timeout)))

    def metric_allreduce(self) -> Callable[[np.ndarray], np.ndarray]:
        """Adapter matching MetricRegistry.get_metric_msg's
        ``allreduce(vec) -> vec``."""
        return lambda v: self.all_reduce(np.asarray(v, np.float64), "sum")

    def equalize_batches(self) -> Callable[[int], int]:
        """Adapter for BoxDataset.split_batches(equalize=...): the max of
        the ranks' local batch counts (compute_paddlebox_thread_batch_nccl,
        data_set.cc:2690-2755)."""
        return lambda n: int(self.all_reduce(
            np.asarray([n], np.int64), "max")[0])

    # ------------------------------------------------------------ transports
    def make_mesh_comm(self, positions=(), timeout: Optional[float] = None,
                       policy_id: Optional[str] = None) -> MeshComm:
        """This rank's per-step exchange (fleet/mesh_comm.py), made once
        and kept, on a gloo group of its own. Collective: every rank calls
        it in the same order. The ranks' mesh positions and sharding
        policy identities are gathered first, each gather within
        ``timeout`` seconds (None: the group's timeout); different
        identities raise MeshPolicyMismatch on every rank."""
        if self._comm is not None:
            if policy_id is not None and policy_id != self._comm_policy:
                raise ValueError(
                    "make_mesh_comm: the exchange was made under policy "
                    "%r; requested %r — one policy a fleet lifetime"
                    % (self._comm_policy, policy_id))
            return self._comm
        pos = self.all_gather(np.asarray(list(positions), np.int64),
                              timeout)
        ident = (policy_id or "").encode("utf-8")
        seen = sorted({bytes(p).decode("utf-8") for p in self.all_gather(
            np.frombuffer(ident, np.uint8).copy(), timeout)})
        if policy_id is not None and seen != [policy_id]:
            raise MeshPolicyMismatch(
                "sharding-policy mismatch across ranks: the cluster "
                "published %s — set sharding_policy identically on every "
                "rank" % seen)
        try:
            group = dist.new_group(backend="gloo", timeout=datetime.timedelta(
                seconds=self._timeout))
        except RuntimeError as e:
            raise MeshConnectError("the host exchange's gloo group could "
                                   "not be made: %s" % e) from e
        self._comm = MeshComm(self.role.rank, self.role.world, group,
                              {r: p.tolist() for r, p in enumerate(pos)})
        self._comm_policy = policy_id
        return self._comm

    def make_shuffler(self, batch_records: int = 512,
                      host: Optional[str] = None,
                      timeout: float = DEFAULT_TIMEOUT_S):
        """This rank's cross-host instance shuffle (data/shuffle.py
        TcpShuffler, listening on ``host``, default this rank's address),
        its endpoints exchanged by ``all_gather``; None at world 1.
        Collective: every rank calls it in the same order. The dial
        timeout is HostFlags().shuffle_connect_secs; ``timeout`` is the
        shuffle's flush wait."""
        from paddlebox_tpu_torch.data.shuffle import TcpShuffler
        if self.role.world <= 1:
            return None
        host = host or self._my_host()
        sh = TcpShuffler(self.role.rank, self.role.world,
                         [(host, 0)] * self.role.world,
                         batch_records=batch_records, flush_timeout=timeout)
        ep = ("%s:%d" % (host, sh.port)).encode().ljust(64)
        endpoints = []
        for e in self.all_gather(np.frombuffer(ep, np.uint8).copy()):
            h, p = bytes(e).rstrip(b" \x00").decode().rsplit(":", 1)
            endpoints.append((h, int(p)))
        sh.endpoints = endpoints
        return sh

    # ------------------------------------------------------------- lifecycle
    def stop(self) -> None:
        """Close the exchange and the KV store, and destroy the process
        group."""
        if self._comm is not None:
            self._comm.close()
            self._comm = None
            self._comm_policy = None
        if self._kv_client is not None:
            self._kv_client.close()
            self._kv_client = None
        if self._kv_server is not None:
            self._kv_server.stop()
            self._kv_server = None
        if self.mesh is not None:
            self.mesh.close()
            self.mesh = None
        self._store = None
        self.role = None


# module-level singleton, like `from paddle.distributed import fleet`
fleet = Fleet()
