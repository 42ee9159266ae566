"""The fleet's TCP key-value store (a copy of paddlebox_tpu/fleet/store.py,
the same requests on the wire).

The role of the GlooWrapper rendezvous store (gloo_wrapper.h:53,169-183):
ranks publish small values (endpoints, heartbeats, telemetry reports)
under string keys, and ``add`` is the atomic counter. The transport is
utils/rpc.py's framed RPC with no class resolution at all (only str,
bytes and int travel). In the port, rank 0 of a fleet of more than one
rank hosts the server and every rank holds a client
(fleet/fleet.py ``Fleet.store_client``); the process group itself
rendezvouses at torch.distributed's store.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from paddlebox_tpu_torch.utils.rpc import (FramedClient, FramedServer,
                                           plain_loads)


class KVStoreServer:
    """The store: values and counters by key, served on (host, port);
    ``port`` is the bound one (port 0: any free port)."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0) -> None:
        self._kv: Dict[str, bytes] = {}  # guarded-by: _cv
        self._counters: Dict[str, int] = {}  # guarded-by: _cv
        self._cv = threading.Condition()
        self._rpc = FramedServer(self._handle, plain_loads, host, port)

    @property
    def port(self) -> int:
        return self._rpc.port

    # ------------------------------------------------------------- handlers
    def _handle(self, req: dict) -> Any:
        op = req["op"]
        key = req.get("key", "")
        if op == "set":
            with self._cv:
                self._kv[key] = req["value"]
                self._cv.notify_all()
            return True
        if op == "get":
            with self._cv:
                return self._kv.get(key)
        if op == "wait":
            deadline = time.monotonic() + req.get("timeout", 60.0)
            with self._cv:
                while key not in self._kv:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._cv.wait(remaining):
                        raise TimeoutError("store wait(%s) timed out" % key)
                return self._kv[key]
        if op == "add":
            with self._cv:
                cur = self._counters.get(key, 0) + int(req.get("amount", 1))
                self._counters[key] = cur
                self._cv.notify_all()
                return cur
        if op == "counter":
            with self._cv:
                return self._counters.get(key, 0)
        if op == "wait_counter_ge":
            target = int(req["target"])
            deadline = time.monotonic() + req.get("timeout", 60.0)
            with self._cv:
                while self._counters.get(key, 0) < target:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._cv.wait(remaining):
                        raise TimeoutError(
                            "store wait_counter(%s>=%d) timed out"
                            % (key, target))
                return self._counters[key]
        if op == "delete":
            with self._cv:
                self._kv.pop(key, None)
                self._counters.pop(key, None)
            return True
        if op == "keys":
            with self._cv:
                return sorted(self._kv)
        raise ValueError("unknown store op " + op)

    def stop(self) -> None:
        self._rpc.stop()


class TcpStoreClient:
    """One connection to a KVStoreServer. ``wait`` and ``wait_counter_ge``
    block on the server up to their timeout and raise there."""

    def __init__(self, host: str, port: int, timeout: float = 300.0) -> None:
        self._rpc = FramedClient(host, port, plain_loads, timeout)

    def set(self, key: str, value: bytes) -> None:
        self._rpc.call({"op": "set", "key": key, "value": value})

    def get(self, key: str) -> Optional[bytes]:
        return self._rpc.call({"op": "get", "key": key})

    def wait(self, key: str, timeout: float = 60.0) -> bytes:
        return self._rpc.call({"op": "wait", "key": key, "timeout": timeout},
                              op_timeout=timeout)

    def add(self, key: str, amount: int = 1) -> int:
        return self._rpc.call({"op": "add", "key": key, "amount": amount})

    def counter(self, key: str) -> int:
        return self._rpc.call({"op": "counter", "key": key})

    def wait_counter_ge(self, key: str, target: int,
                        timeout: float = 60.0) -> int:
        return self._rpc.call({"op": "wait_counter_ge", "key": key,
                               "target": target, "timeout": timeout},
                              op_timeout=timeout)

    def delete(self, key: str) -> None:
        self._rpc.call({"op": "delete", "key": key})

    def keys(self):
        return self._rpc.call({"op": "keys"})

    def close(self) -> None:
        self._rpc.close()
