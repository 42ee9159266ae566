"""Fleet: the multi-process control plane (one process a GPU).

Counterpart of paddlebox_tpu/fleet/: the env-driven role maker, the fleet
facade with its host collectives and the per-step host exchange, both on
torch.distributed gloo groups, the launcher that spawns one worker a GPU
around a rendezvous TCPStore, the reference's KV store over the framed
RPC transport (fleet/store.py, utils/rpc.py), the elastic heartbeat
manager (fleet/elastic.py), heterogeneous training's dense service and CPU
worker (fleet/heter.py) and the fleet executor's interceptors and carriers
(fleet/executor.py), both over the framed RPC.
"""

from paddlebox_tpu_torch.fleet.elastic import DeadRankError, ElasticManager
from paddlebox_tpu_torch.fleet.executor import (Carrier, FleetExecutor,
                                                Interceptor,
                                                InterceptorMessage)
from paddlebox_tpu_torch.fleet.fleet import Fleet, fleet
from paddlebox_tpu_torch.fleet.heter import (HeterDenseClient,
                                             HeterDenseService, HeterTrainer)
from paddlebox_tpu_torch.fleet.mesh_comm import MeshComm
from paddlebox_tpu_torch.fleet.role_maker import RoleMaker
from paddlebox_tpu_torch.fleet.store import KVStoreServer, TcpStoreClient

__all__ = ["RoleMaker", "Fleet", "fleet", "MeshComm", "KVStoreServer",
           "TcpStoreClient", "ElasticManager", "DeadRankError",
           "HeterDenseService", "HeterDenseClient", "HeterTrainer",
           "InterceptorMessage", "Interceptor", "Carrier", "FleetExecutor"]
