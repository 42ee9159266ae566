"""The parameter server's service: the handler table and its clients.

Counterpart of paddlebox_tpu/ps/service.py (distributed/ps/service/):
``PSCore`` is the handler table behind the server (PsService,
brpc_ps_server.cc), ``PsLocalClient`` the in-process client
(ps_local_client.h), and ``PSServer`` / ``TcpPSClient`` the TCP pair over
the host plane's framed transport (utils/rpc.py: the same frames as the
reference's, one request dict ``{"method", "args"}`` a call).

The trust domain is the training cluster. Unpickling is limited to the
globals of an ndarray round trip and this package's TableConfig and
SparseOptimizerConfig, and a frame may call only PSCore's operations. The
pull, push, assign, shrink, age, limit_mem, size and barrier frames, which carry
numpy and builtins only, cross between this package's and the reference's
ends both ways; ``create_sparse_table``'s frame carries a TableConfig of
the sender's package, and goes between ends of one package only.
"""

from __future__ import annotations

import os
import pickle
import threading
from typing import Any, Dict, Optional

import numpy as np

from paddlebox_tpu_torch.config.configs import TableConfig
from paddlebox_tpu_torch.embedding.ckpt_store import safe_load
from paddlebox_tpu_torch.ps.table import DenseTable, SparseTable
from paddlebox_tpu_torch.utils.rpc import (NDARRAY_GLOBALS, FramedClient,
                                           FramedServer, allow_globals,
                                           make_loads)


# the globals an ndarray, a numpy scalar and the two configs resolve when
# unpickled
_ALLOWED = NDARRAY_GLOBALS | frozenset(
    ("paddlebox_tpu_torch.config.configs", n)
    for n in ("TableConfig", "SparseOptimizerConfig"))

# what a request frame may call on the PSCore
_METHODS = frozenset([
    "create_sparse_table", "create_dense_table", "pull_sparse",
    "push_sparse", "assign_sparse", "shrink", "age_unseen_days",
    "limit_mem", "sparse_size", "pull_dense", "push_dense", "save", "load",
    "barrier"])


_loads = make_loads(allow_globals(_ALLOWED))


class PSCore:
    """The server's tables and their operations."""

    def __init__(self) -> None:
        self.sparse: Dict[int, SparseTable] = {}
        self.dense: Dict[str, DenseTable] = {}
        self._barrier_lock = threading.Condition()
        self._barrier_count = 0
        self._barrier_gen = 0

    # ---- table management
    def create_sparse_table(self, table_id: int, table: TableConfig,
                            shard_num: int = 8, seed: int = 0) -> None:
        self.sparse[table_id] = SparseTable(table, shard_num, seed=seed)

    def create_dense_table(self, name: str, size: int = 0, rule: str = "adam",
                           lr: float = 1e-3,
                           init: Optional[np.ndarray] = None) -> None:
        self.dense[name] = DenseTable(size, rule, lr, init)

    # ---- sparse
    def pull_sparse(self, table_id: int, keys: np.ndarray,
                    create: bool = True) -> np.ndarray:
        return self.sparse[table_id].pull(keys, create=create)

    def push_sparse(self, table_id: int, keys: np.ndarray,
                    grads: np.ndarray) -> None:
        self.sparse[table_id].push(keys, grads)

    def assign_sparse(self, table_id: int, keys: np.ndarray,
                      values: np.ndarray) -> None:
        self.sparse[table_id].assign(keys, values)

    def shrink(self, table_id: int) -> int:
        return self.sparse[table_id].shrink()

    def age_unseen_days(self, table_id: int) -> None:
        self.sparse[table_id].age_unseen_days()

    def limit_mem(self, table_id: int,
                  max_resident: Optional[int] = None) -> int:
        return self.sparse[table_id].check_need_limit_mem(max_resident)

    def sparse_size(self, table_id: int) -> int:
        return len(self.sparse[table_id])

    # ---- dense
    def pull_dense(self, name: str) -> np.ndarray:
        return self.dense[name].pull()

    def push_dense(self, name: str, grad: np.ndarray) -> None:
        self.dense[name].push(grad)

    # ---- checkpoint
    def save(self, dirpath: str) -> None:
        for tid, t in self.sparse.items():
            t.save(os.path.join(dirpath, "sparse-%d" % tid))
        dense_state = {n: t.state() for n, t in self.dense.items()}
        with open(os.path.join(dirpath, "dense.pkl"), "wb") as f:
            pickle.dump(dense_state, f)

    def load(self, dirpath: str) -> None:
        """Reads ``save``'s files back; dense.pkl through safe_load (numpy
        and builtin containers only)."""
        for tid, t in self.sparse.items():
            t.load(os.path.join(dirpath, "sparse-%d" % tid))
        p = os.path.join(dirpath, "dense.pkl")
        if os.path.exists(p):
            with open(p, "rb") as f:
                for n, st in safe_load(f).items():
                    if n in self.dense:
                        self.dense[n].load_state(st)

    # ---- barrier (the BarrierTable role, barrier_table_test.cc)
    def barrier(self, world: int, timeout: float = 120.0) -> None:
        with self._barrier_lock:
            gen = self._barrier_gen
            self._barrier_count += 1
            if self._barrier_count >= world:
                self._barrier_count = 0
                self._barrier_gen += 1
                self._barrier_lock.notify_all()
                return
            ok = self._barrier_lock.wait_for(
                lambda: self._barrier_gen != gen, timeout)
            if not ok:
                raise TimeoutError("ps barrier timed out")


class PsLocalClient:
    """The in-process client: every call goes straight to a PSCore."""

    def __init__(self, core: Optional[PSCore] = None) -> None:
        self.core = core or PSCore()

    def __getattr__(self, name):
        return getattr(self.core, name)

    def stop_server(self) -> None:
        pass


class TcpPSClient:
    """The framed request/answer client (brpc_ps_client's role)."""

    def __init__(self, host: str, port: int, timeout: float = 300.0) -> None:
        self._rpc = FramedClient(host, port, _loads, timeout)

    def _call(self, method: str, _op_timeout=None, **kwargs) -> Any:
        return self._rpc.call({"method": method, "args": kwargs},
                              op_timeout=_op_timeout)

    def create_sparse_table(self, table_id, table, shard_num=8, seed=0):
        return self._call("create_sparse_table", table_id=table_id,
                          table=table, shard_num=shard_num, seed=seed)

    def create_dense_table(self, name, size=0, rule="adam", lr=1e-3,
                           init=None):
        return self._call("create_dense_table", name=name, size=size,
                          rule=rule, lr=lr, init=init)

    def pull_sparse(self, table_id, keys, create=True):
        return self._call("pull_sparse", table_id=table_id, keys=keys,
                          create=create)

    def push_sparse(self, table_id, keys, grads):
        return self._call("push_sparse", table_id=table_id, keys=keys,
                          grads=grads)

    def assign_sparse(self, table_id, keys, values):
        return self._call("assign_sparse", table_id=table_id, keys=keys,
                          values=values)

    def pull_dense(self, name):
        return self._call("pull_dense", name=name)

    def push_dense(self, name, grad):
        return self._call("push_dense", name=name, grad=grad)

    def shrink(self, table_id):
        return self._call("shrink", table_id=table_id)

    def age_unseen_days(self, table_id):
        return self._call("age_unseen_days", table_id=table_id)

    def limit_mem(self, table_id, max_resident=None):
        return self._call("limit_mem", table_id=table_id,
                          max_resident=max_resident)

    def sparse_size(self, table_id):
        return self._call("sparse_size", table_id=table_id)

    def save(self, dirpath):
        return self._call("save", dirpath=dirpath)

    def load(self, dirpath):
        return self._call("load", dirpath=dirpath)

    def barrier(self, world, timeout=120.0):
        return self._call("barrier", _op_timeout=timeout, world=world,
                          timeout=timeout)

    def stop_server(self):
        try:
            self._call("__stop__")
        except (ConnectionError, OSError):
            pass

    def close(self):
        self._rpc.close()


class PSServer:
    """A TCP server over a PSCore on the framed transport (the
    brpc_ps_server.cc role; a barrier call blocks its connection's
    thread). ``port`` 0 takes any free port (``self.port``)."""

    def __init__(self, core: Optional[PSCore] = None,
                 host: str = "127.0.0.1", port: int = 0) -> None:
        self.core = core or PSCore()
        self._rpc = FramedServer(self._handle, _loads, host, port)

    @property
    def port(self) -> int:
        return self._rpc.port

    def _handle(self, req: dict) -> Any:
        method = req["method"]
        if method == "__stop__":
            # stop() closes the listener only; this connection still
            # delivers the frame's answer before its loop ends
            self.stop()
            return True
        if method not in _METHODS:
            raise ValueError("unknown ps method %r" % (method,))
        return getattr(self.core, method)(**req["args"])

    def stop(self) -> None:
        self._rpc.stop()
