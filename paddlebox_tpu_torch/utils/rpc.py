"""The framed RPC transport of the host control plane (a copy of
paddlebox_tpu/utils/rpc.py, the same frames on the wire).

A frame is a 4-byte little-endian length and a pickle. ``FramedServer``
(one thread a connection) hands each request dict to its handler and
answers every frame with one frame, ``{"ok": True, "result": ...}`` or
``{"ok": False, "error": repr}``, also on a handler's error (counted in
the stat rpc_handler_errors, which the health plane reads), so the
client's stream never loses its place. ``FramedClient`` sends one request
a call over one connection behind a lock, dialing within its timeout
(TCP_NODELAY on both ends). Unpickling goes through ``make_loads``, whose
class lookup an allow-predicate limits; ``plain_loads`` resolves no class
at all (the fleet's KV store, fleet/store.py, and the fleet executor's
message bus, fleet/executor.py); ``ndarray_loads`` resolves only the
globals of an ndarray round trip (heter's dense service, fleet/heter.py;
the CPU PS adds its two configs, ps/service.py).
"""

from __future__ import annotations

import io
import pickle
import socket
import struct
import threading
from typing import Any, Callable, Dict, Optional

from paddlebox_tpu_torch.utils.lockwatch import make_lock
from paddlebox_tpu_torch.utils.stats import stat_add

_LEN = struct.Struct("<I")


def recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def make_loads(allow: Callable[[str, str], bool]) -> Callable[[bytes], Any]:
    """A pickle.loads whose class resolution is limited to `allow`."""

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if allow(module, name):
                return super().find_class(module, name)
            raise pickle.UnpicklingError(
                "refusing to unpickle %s.%s" % (module, name))

    def loads(data: bytes) -> Any:
        return _Unpickler(io.BytesIO(data)).load()

    return loads


# plain containers and scalars only: no class resolution at all
plain_loads = make_loads(lambda m, n: False)

# the globals an ndarray and a numpy scalar resolve when unpickled (numpy
# 1.x names its core ``numpy.core``, 2.x ``numpy._core``)
NDARRAY_GLOBALS = frozenset(
    [("numpy", "ndarray"), ("numpy", "dtype")]
    + [(core + ".multiarray", n) for core in ("numpy.core", "numpy._core")
       for n in ("_reconstruct", "scalar")]
    + [(core + ".numeric", "_frombuffer")
       for core in ("numpy.core", "numpy._core")])


def allow_globals(allowed) -> Callable[[str, str], bool]:
    """An allow-predicate for ``make_loads`` of exactly the (module, name)
    pairs ``allowed``; a dotted name, which would let find_class walk
    attributes past the module, never."""
    allowed = frozenset(allowed)
    return lambda module, name: "." not in name and (module, name) in allowed


ndarray_loads = make_loads(allow_globals(NDARRAY_GLOBALS))


class FramedServer:
    """Accepts connections, one thread each; every request frame gets
    exactly one answer frame, also on a handler's or a decode's error."""

    def __init__(self, handler: Callable[[dict], Any],
                 loads: Callable[[bytes], Any] = plain_loads,
                 host: str = "127.0.0.1", port: int = 0,
                 max_frame_bytes: Optional[int] = None) -> None:
        """Listens on (host, port) (port 0: any free port, ``port``).
        ``max_frame_bytes``: a request whose length prefix exceeds it is
        answered with an error frame and its connection closed unread (a
        sender still writing a larger payload may see a reset instead);
        None: no limit, the cluster's own planes."""
        self._handler = handler
        self._loads = loads
        self._max_frame = max_frame_bytes
        self._stop = threading.Event()
        self._conns_lock = make_lock("FramedServer._conns_lock")
        self._conns: set = set()  # guarded-by: _conns_lock
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host, port))
        self._server.listen(128)
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._server.getsockname()[1]

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            # small request/answer pairs: no Nagle delay on the answers
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                if self._stop.is_set():
                    conn.close()
                    return
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                hdr = recv_exact(conn, _LEN.size)
                if hdr is None:
                    return
                (length,) = _LEN.unpack(hdr)
                if self._max_frame is not None and length > self._max_frame:
                    resp = {"ok": False,
                            "error": "RuntimeError('frame of %d bytes "
                                     "exceeds server max of %d')"
                                     % (length, self._max_frame)}
                    payload = pickle.dumps(
                        resp, protocol=pickle.HIGHEST_PROTOCOL)
                    conn.sendall(_LEN.pack(len(payload)) + payload)
                    return
                body = recv_exact(conn, length)
                if body is None:
                    return
                try:
                    resp = {"ok": True, "result": self._handler(
                        self._loads(body))}
                except Exception as e:  # surfaced to the client
                    resp = {"ok": False, "error": repr(e)}
                    # the health plane reads the rate (obs/health.py)
                    stat_add("rpc_handler_errors")
                payload = pickle.dumps(resp,
                                       protocol=pickle.HIGHEST_PROTOCOL)
                conn.sendall(_LEN.pack(len(payload)) + payload)
        except OSError:
            return    # hung up by stop(hang_up=True), or the peer reset
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            conn.close()

    def stop(self, hang_up: bool = False) -> None:
        """Stop accepting: the listener is shut down, which ends the accept
        thread. A connection already served keeps its thread until its
        peer closes, so a handler may stop its own server and still answer
        the frame; ``hang_up`` also shuts every live connection down, and
        their threads end."""
        self._stop.set()
        for close in (lambda: self._server.shutdown(socket.SHUT_RDWR),
                      self._server.close):
            try:
                close()
            except OSError:
                pass
        if hang_up:
            with self._conns_lock:
                conns = list(self._conns)
            for conn in conns:
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass


class FramedClient:
    def __init__(self, host: str, port: int,
                 loads: Callable[[bytes], Any] = plain_loads,
                 timeout: float = 300.0) -> None:
        # the dial honours the caller's timeout too
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.settimeout(timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._loads = loads
        self._lock = make_lock("FramedClient._lock")
        self._broken = False  # guarded-by: _lock

    def call(self, req: Dict[str, Any],
             op_timeout: Optional[float] = None) -> Any:
        """One request and its answer's result (RuntimeError with the
        server's error where it failed; ConnectionError, for this call and
        every later one, where the transport did). ``op_timeout``: a
        server-side op that blocks (the store's waits) raises the socket's
        deadline past it for this call. The lock holds one request and its
        answer together on the connection; planes that must not wait for
        each other hold clients of their own."""
        payload = pickle.dumps(req, protocol=pickle.HIGHEST_PROTOCOL)
        with self._lock:
            if self._broken:
                raise ConnectionError("rpc connection previously failed")
            prev_timeout = self._sock.gettimeout()
            if op_timeout is not None:
                self._sock.settimeout(
                    max(prev_timeout or 0.0, op_timeout + 30.0))
            try:
                self._sock.sendall(_LEN.pack(len(payload)) + payload)
                hdr = recv_exact(self._sock, _LEN.size)
                body = (recv_exact(self._sock, _LEN.unpack(hdr)[0])
                        if hdr is not None else None)
            except OSError as e:
                self._broken = True
                raise ConnectionError("rpc transport failed") from e
            finally:
                if op_timeout is not None and not self._broken:
                    self._sock.settimeout(prev_timeout)
            if hdr is None or body is None:
                # mid-frame EOF: the stream is unrecoverable
                self._broken = True
                raise ConnectionError("rpc server closed connection")
        resp = self._loads(body)
        if not resp["ok"]:
            raise RuntimeError("rpc %r failed: %s"
                               % (req.get("method") or req.get("op"),
                                  resp["error"]))
        return resp.get("result")

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
