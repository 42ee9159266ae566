"""Env-driven role maker (the reference's fleet/role_maker.py:22-44, a copy:
the port imports nothing of the JAX package): rank, world and the
rendezvous store's endpoint come from environment variables set by the
launcher (fleet/launch.py) or a cluster scheduler; the PADDLE_* names are
accepted as aliases, so reference launch configs carry over.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple


def _env(*names: str, default: Optional[str] = None) -> Optional[str]:
    for n in names:
        v = os.environ.get(n)
        if v is not None:
            return v
    return default


class RoleMaker:
    def __init__(self, rank: Optional[int] = None,
                 world: Optional[int] = None,
                 store_endpoint: Optional[str] = None) -> None:
        self.rank = rank if rank is not None else int(
            _env("PBTPU_TRAINER_ID", "PADDLE_TRAINER_ID", default="0"))
        self.world = world if world is not None else int(
            _env("PBTPU_TRAINERS_NUM", "PADDLE_TRAINERS_NUM", default="1"))
        self.store_endpoint = store_endpoint or _env(
            "PBTPU_STORE_ENDPOINT", "PADDLE_GLOO_HTTP_ENDPOINT")
        if not (0 <= self.rank < self.world):
            raise ValueError("rank %d outside world %d"
                             % (self.rank, self.world))

    def is_first_worker(self) -> bool:
        return self.rank == 0

    def store_addr(self) -> Tuple[str, int]:
        if not self.store_endpoint:
            raise ValueError("no store endpoint configured "
                             "(PBTPU_STORE_ENDPOINT=host:port)")
        host, port = self.store_endpoint.rsplit(":", 1)
        return host, int(port)
