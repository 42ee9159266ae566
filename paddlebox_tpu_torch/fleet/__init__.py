"""Fleet: the multi-process control plane (one process a GPU).

Counterpart of paddlebox_tpu/fleet/: the env-driven role maker, the fleet
facade with its host collectives and the per-step host exchange, both on
torch.distributed gloo groups, the launcher that spawns one worker a GPU
around a rendezvous TCPStore, the reference's KV store over the framed
RPC transport (fleet/store.py, utils/rpc.py) and the elastic heartbeat
manager (fleet/elastic.py). Heter and the executor wait for their slices
(ROADMAP.md A10).
"""

from paddlebox_tpu_torch.fleet.elastic import DeadRankError, ElasticManager
from paddlebox_tpu_torch.fleet.fleet import Fleet, fleet
from paddlebox_tpu_torch.fleet.mesh_comm import MeshComm
from paddlebox_tpu_torch.fleet.role_maker import RoleMaker
from paddlebox_tpu_torch.fleet.store import KVStoreServer, TcpStoreClient

__all__ = ["RoleMaker", "Fleet", "fleet", "MeshComm", "KVStoreServer",
           "TcpStoreClient", "ElasticManager", "DeadRankError"]
