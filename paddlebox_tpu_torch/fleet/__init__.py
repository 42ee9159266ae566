"""Fleet: the multi-process control plane (one process a GPU).

Counterpart of paddlebox_tpu/fleet/: the env-driven role maker, the fleet
facade with its host collectives and the per-step host exchange, both on
torch.distributed gloo groups, and the launcher that spawns one worker a
GPU around a rendezvous TCPStore. The reference's KV store and socket
mesh (fleet/store.py, utils/rpc.py), elastic, heter and executor wait for
their slices (ROADMAP.md A10).
"""

from paddlebox_tpu_torch.fleet.fleet import Fleet, fleet
from paddlebox_tpu_torch.fleet.mesh_comm import MeshComm
from paddlebox_tpu_torch.fleet.role_maker import RoleMaker

__all__ = ["RoleMaker", "Fleet", "fleet", "MeshComm"]
