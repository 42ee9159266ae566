"""The fleet executor: an actor-style pipeline of interceptors.

Counterpart of paddlebox_tpu/fleet/executor.py (paddle/fluid/distributed/
fleet_executor/: FleetExecutor, Carrier, Interceptor, MessageBus).
Interceptors are small actors addressed by integer ids that exchange
``InterceptorMessage``s; a Carrier runs each interceptor registered to it
on a thread of its own, and routes a message whose destination lives on
another carrier over TCP (the message bus, utils/rpc.py's framed
transport, the same frames as the reference's: the two packages' carriers
exchange messages). It is a host-side pipeline runtime beside the BoxPS
path; it runs no kernel.

``Carrier.stop`` ends every interceptor thread, closes the carrier's
clients and stops its server with every live connection, so no thread of
the carrier outlives it.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from paddlebox_tpu_torch.utils.lockwatch import make_lock
from paddlebox_tpu_torch.utils.rpc import (FramedClient, FramedServer,
                                           plain_loads)

STOP = "__stop__"


@dataclasses.dataclass
class InterceptorMessage:
    src_id: int
    dst_id: int
    message_type: str = "DATA"     # DATA | DATA_IS_READY | STOP ...
    payload: Any = None

    def to_wire(self) -> dict:
        return {"src": self.src_id, "dst": self.dst_id,
                "type": self.message_type, "payload": self.payload}

    @classmethod
    def from_wire(cls, d: dict) -> "InterceptorMessage":
        return cls(d["src"], d["dst"], d["type"], d.get("payload"))


class Interceptor:
    """One actor: ``handler(interceptor, message)`` called for each
    message, in arrival order, on the interceptor's own thread
    (interceptor.cc's RegisterMsgHandle and loop)."""

    def __init__(self, interceptor_id: int,
                 handler: Callable[["Interceptor", InterceptorMessage], None]
                 ) -> None:
        self.id = interceptor_id
        self.handler = handler
        self.carrier: Optional["Carrier"] = None
        self._inbox: "queue.Queue[Optional[InterceptorMessage]]" = \
            queue.Queue()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="interceptor-%d" % self.id)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            msg = self._inbox.get()
            if msg is None or msg.message_type == STOP:
                return
            self.handler(self, msg)

    def enqueue(self, msg: InterceptorMessage) -> None:
        self._inbox.put(msg)

    def send(self, dst_id: int, payload: Any = None,
             message_type: str = "DATA") -> None:
        self.carrier.send(InterceptorMessage(self.id, dst_id, message_type,
                                             payload))

    def stop(self) -> None:
        self._inbox.put(None)
        if self._thread is not None:
            self._thread.join()


class Carrier:
    """Hosts interceptors; a local message goes to its interceptor's inbox,
    a remote one through the message bus (carrier.cc Send /
    EnqueueInterceptorMessage). The bus listens on (host, port), port 0
    any free port (``self.port``)."""

    def __init__(self, carrier_id: int = 0, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self.id = carrier_id
        self._interceptors: Dict[int, Interceptor] = {}
        # interceptor id -> (host, port) of a remote destination
        self._routes: Dict[int, Tuple[str, int]] = {}
        self._clients: Dict[Tuple[str, int], FramedClient] = {}
        self._clients_lock = make_lock("Carrier._clients_lock")
        self._rpc = FramedServer(self._on_remote, plain_loads, host, port)

    @property
    def port(self) -> int:
        return self._rpc.port

    # ------------------------------------------------------------- topology
    def add_interceptor(self, interceptor: Interceptor) -> Interceptor:
        interceptor.carrier = self
        self._interceptors[interceptor.id] = interceptor
        interceptor.start()
        return interceptor

    def interceptor(self, interceptor_id: int) -> Interceptor:
        return self._interceptors[interceptor_id]

    def register_route(self, interceptor_id: int, host: str,
                       port: int) -> None:
        """A routing table entry of the message bus (message_bus.cc
        Init)."""
        self._routes[interceptor_id] = (host, port)

    # -------------------------------------------------------------- routing
    def send(self, msg: InterceptorMessage) -> None:
        local = self._interceptors.get(msg.dst_id)
        if local is not None:
            local.enqueue(msg)
            return
        ep = self._routes.get(msg.dst_id)
        if ep is None:
            raise KeyError("no route to interceptor %d" % msg.dst_id)
        with self._clients_lock:
            cl = self._clients.get(ep)
        if cl is None:
            # dial outside the lock: a peer that does not answer stalls
            # only this sender for the connect timeout
            fresh = FramedClient(ep[0], ep[1], plain_loads)
            with self._clients_lock:
                cl = self._clients.setdefault(ep, fresh)
            if cl is not fresh:     # another thread dialed first
                fresh.close()
        cl.call(msg.to_wire())

    def _on_remote(self, wire: dict) -> bool:
        msg = InterceptorMessage.from_wire(wire)
        local = self._interceptors.get(msg.dst_id)
        if local is None:
            raise KeyError("carrier %d hosts no interceptor %d"
                           % (self.id, msg.dst_id))
        local.enqueue(msg)
        return True

    def stop(self) -> None:
        for it in self._interceptors.values():
            it.stop()
        with self._clients_lock:
            clients, self._clients = list(self._clients.values()), {}
        for cl in clients:
            cl.close()
        self._rpc.stop(hang_up=True)


class FleetExecutor:
    """The top-level runner (fleet_executor.cc): a carrier, its
    interceptors, the sources fed, the sinks waited for."""

    def __init__(self, carrier: Optional[Carrier] = None) -> None:
        self.carrier = carrier or Carrier()
        self._done = threading.Event()
        self.results: List[Any] = []  # guarded-by: _results_lock
        self._results_lock = make_lock("FleetExecutor._results_lock")

    def add_sink(self, interceptor_id: int, expect: int) -> Interceptor:
        """A terminal interceptor that collects ``expect`` payloads."""
        remaining = [expect]

        def handler(it, msg):
            with self._results_lock:
                self.results.append(msg.payload)
                remaining[0] -= 1
                if remaining[0] <= 0:
                    self._done.set()

        return self.carrier.add_interceptor(Interceptor(interceptor_id,
                                                        handler))

    def run(self, source_id: int, payloads: List[Any],
            timeout: float = 60.0) -> List[Any]:
        """Feed ``payloads`` to the source interceptor and wait until the
        sink has collected all it expects (TimeoutError after
        ``timeout`` seconds)."""
        src = self.carrier.interceptor(source_id)
        for p in payloads:
            src.enqueue(InterceptorMessage(-1, source_id, "DATA", p))
        if not self._done.wait(timeout):
            raise TimeoutError("fleet executor run timed out")
        with self._results_lock:
            return list(self.results)
