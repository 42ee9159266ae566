"""The cross-host instance shuffle (paddlebox_tpu/data/shuffle.py, the same
frames on the wire).

The pass-load shuffle of PadBoxSlotDataset (ShuffleData /
ReceiveSuffleData, data_set.cc:2438-2602): while a rank reads its files,
every instance goes to rank ``hash(ins) % world`` (general_shuffle_func,
data_set.cc:2420-2436). This rank's own go straight to the dataset's
merge; the others are framed and sent; the frames a rank receives are
merged after its own, at ``flush``, which also waits until every peer
has said it is done (wait_message_done).

Two codecs share every transport: the record codec (data/archive.py
``serialize_records``, magic "PBXR": a batch of ``batch_records``
SlotRecords a frame) and the block codec (data/block_shuffle.py, magic
"PBXB": one ColumnarBlock's sub-block a destination and file).
``_deliver`` tells them apart by the magic.

The merge order is the port's: the local instances in read order, then
the received frames ordered by (source rank, the frame's place in that
source's sends). A source sends in its read order over one connection a
peer, so the order is the same in every run, and a shuffled pass can be
held bit for bit against a second run. The reference merges frames in
arrival order (ROADMAP.md C).

Transports: ``LocalShuffleGroup`` (ranks of one process, for tests) and
``TcpShuffler`` (a listener a rank, one connection a peer opened at the
first send, TCP_NODELAY, the dial bounded by ``connect_secs``:
ShufflePeerUnreachable names the peer). The reference's MeshShuffler
rides its socket mesh, which the port does not have
(fleet/fleet.py ``make_shuffler``).

Frames carry the pass's epoch, so a fast peer's frames of its next pass
wait under their epoch. The counters: shuffle_batches_sent,
shuffle_bytes_sent, shuffle_ins_received, shuffle_bytes_received.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from paddlebox_tpu_torch.data.archive import (deserialize_records,
                                              serialize_records)
from paddlebox_tpu_torch.data.block_shuffle import (BLOCK_MAGIC,
                                                    block_shuffle_dests,
                                                    deserialize_block,
                                                    serialize_block,
                                                    split_block)
from paddlebox_tpu_torch.data.columnar import ColumnarBlock
from paddlebox_tpu_torch.data.slot_record import SlotRecord
from paddlebox_tpu_torch.utils.channel import register_depth_gauge
from paddlebox_tpu_torch.utils.lockwatch import make_lock
from paddlebox_tpu_torch.utils.rpc import recv_exact
from paddlebox_tpu_torch.utils.stats import stat_add

# the flush's wait for the peers' done markers, seconds
FLUSH_TIMEOUT_S = 120.0


class ShufflePeerUnreachable(ConnectionError):
    """A shuffle peer could not be dialed within ``connect_secs``
    (HostFlags.shuffle_connect_secs); the message names its endpoint."""


class ShufflerBase:
    """Routing, buffering and the done barrier; a transport gives
    ``_send`` and ``_send_done``. The merge ``channel`` is anything with
    ``put(item)`` and ``put_many(items)``: it receives lists of
    SlotRecords (record codec) and ColumnarBlocks (block codec)."""

    def __init__(self, rank: int, world: int, batch_records: int = 512,
                 flush_timeout: float = FLUSH_TIMEOUT_S) -> None:
        self.rank = int(rank)
        self.world = int(world)
        self.batch_records = int(batch_records)
        self.flush_timeout = float(flush_timeout)
        # records buffered a destination
        self._out: List[List[SlotRecord]] = [  # guarded-by: _out_lock
            [] for _ in range(world)]
        self._out_lock = make_lock("ShufflerBase._out_lock")
        self.epoch = 0
        # epoch -> source -> frames in arrival order (each a list of
        # SlotRecords or a ColumnarBlock)
        self._inbox: Dict[int, Dict[int, list]] = {}  # guarded-by: _inbox_lock
        self._inbox_lock = make_lock("ShufflerBase._inbox_lock")
        self._done_from: Dict[int, set] = {}  # guarded-by: _done_cv
        self._done_cv = threading.Condition()
        # frame bytes this transport sent and received
        self.bytes_sent = 0  # guarded-by: _out_lock
        self.bytes_received = 0  # guarded-by: _inbox_lock
        register_depth_gauge("shuffle_inbox", self)

    def __len__(self) -> int:
        """Frames received and not merged yet (the depth gauge)."""
        with self._inbox_lock:
            return sum(len(f) for by_src in self._inbox.values()
                       for f in by_src.values())

    # -- the transport's hooks --------------------------------------------
    def _send(self, dest: int, payload: bytes) -> None:
        raise NotImplementedError

    def _send_done(self, dest: int) -> None:
        raise NotImplementedError

    # -- the receive side (the transport's threads) ------------------------
    def _deliver(self, payload: bytes, epoch: int, src: int) -> None:
        """Decode one data frame from ``src`` into the epoch's inbox: a
        block frame as one ColumnarBlock, a record frame as its list of
        SlotRecords."""
        (magic,) = struct.unpack_from("<I", payload, 0)
        if magic == BLOCK_MAGIC:
            item = deserialize_block(payload)
            n = item.n_recs
        else:
            item = deserialize_records(payload)
            n = len(item)
        with self._inbox_lock:
            self._inbox.setdefault(epoch, {}).setdefault(src, []).append(
                item)
            self.bytes_received += len(payload)
        stat_add("shuffle_ins_received", n)
        stat_add("shuffle_bytes_received", len(payload))

    def _peer_done(self, src: int, epoch: int) -> None:
        with self._done_cv:
            self._done_from.setdefault(epoch, set()).add(src)
            self._done_cv.notify_all()

    def _send_payload(self, dest: int, payload: bytes) -> None:
        self._send(dest, payload)
        with self._out_lock:
            self.bytes_sent += len(payload)
        stat_add("shuffle_batches_sent", 1)
        stat_add("shuffle_bytes_sent", len(payload))

    # -- the dataset's side --------------------------------------------------
    def scatter(self, recs: Sequence[SlotRecord], channel) -> None:
        """Route records (ShuffleData, data_set.cc:2438-2545): this rank's
        to ``channel``, the others buffered a destination and sent
        ``batch_records`` at a time."""
        local: List[SlotRecord] = []
        to_send: List[Tuple[int, bytes]] = []
        with self._out_lock:
            for r in recs:
                dest = r.shuffle_hash() % self.world
                if dest == self.rank:
                    local.append(r)
                else:
                    buf = self._out[dest]
                    buf.append(r)
                    if len(buf) >= self.batch_records:
                        to_send.append((dest, serialize_records(buf)))
                        self._out[dest] = []
        for dest, payload in to_send:
            self._send_payload(dest, payload)
        if local:
            channel.put_many(local)

    def scatter_block(self, block: ColumnarBlock, channel) -> None:
        """The block codec's scatter: one vectorized hash routes every
        record, the block splits a destination, each remote sub-block goes
        as one frame and this rank's to ``channel``."""
        subs = split_block(block, block_shuffle_dests(block, self.world),
                           self.world)
        for dest, sub in enumerate(subs):
            if dest == self.rank or sub is None or not sub.n_recs:
                continue
            self._send_payload(dest, serialize_block(sub))
        local = subs[self.rank]
        if local is not None and local.n_recs:
            channel.put(local)

    def flush(self, channel, timeout: Optional[float] = None) -> None:
        """Send the buffered records and a done marker to every peer, wait
        (``timeout``, default flush_timeout) until every peer is done with
        this epoch, then hand ``channel`` the epoch's received frames by
        (source rank, arrival): record lists through ``put_many``, blocks
        through ``put``. Raises TimeoutError naming the count of peers
        done."""
        epoch = self.epoch
        with self._out_lock:
            pending = [(d, serialize_records(buf))
                       for d, buf in enumerate(self._out) if buf]
            self._out = [[] for _ in range(self.world)]
        for dest, payload in pending:
            self._send_payload(dest, payload)
        for dest in range(self.world):
            if dest != self.rank:
                self._send_done(dest)
        wait = self.flush_timeout if timeout is None else float(timeout)
        with self._done_cv:
            ok = self._done_cv.wait_for(
                lambda: len(self._done_from.get(epoch, ())) >= self.world - 1,
                wait)
            n_done = len(self._done_from.get(epoch, ()))
        if not ok:
            raise TimeoutError("shuffle flush: %d/%d peers done"
                               % (n_done, self.world - 1))
        with self._inbox_lock:
            got = self._inbox.pop(epoch, {})
        for src in sorted(got):
            for item in got[src]:
                if isinstance(item, ColumnarBlock):
                    channel.put(item)
                else:
                    channel.put_many(item)
        with self._done_cv:
            self._done_from.pop(epoch, None)
        self.epoch = epoch + 1

    def close(self) -> None:
        pass


class _InProcShuffler(ShufflerBase):
    def __init__(self, rank: int, world: int, group: "LocalShuffleGroup",
                 batch_records: int = 512) -> None:
        super().__init__(rank, world, batch_records)
        self._group = group

    def _send(self, dest: int, payload: bytes) -> None:
        # the frame is decoded all the same: the codec runs
        self._group.members[dest]._deliver(payload, self.epoch, self.rank)

    def _send_done(self, dest: int) -> None:
        self._group.members[dest]._peer_done(self.rank, self.epoch)


class LocalShuffleGroup:
    """``world`` shuffle ranks of one process wired to each other (the
    tests' transport)."""

    def __init__(self, world: int, batch_records: int = 512) -> None:
        self.members = [_InProcShuffler(r, world, self, batch_records)
                        for r in range(world)]

    def __getitem__(self, rank: int) -> _InProcShuffler:
        return self.members[rank]


_MSG_DATA = 0
_MSG_DONE = 1
_HDR = struct.Struct("<IIII")  # type, source rank, epoch, payload length


class TcpShuffler(ShufflerBase):
    """Framed point-to-point shuffle over TCP (module docstring).
    ``endpoints[i]``: rank i's listener (host, port); this rank binds its
    own (port 0: a free port, ``port``; set ``endpoints`` to the ranks'
    bound ones before the first send, as Fleet.make_shuffler does)."""

    def __init__(self, rank: int, world: int,
                 endpoints: Sequence[Tuple[str, int]],
                 batch_records: int = 512,
                 connect_secs: Optional[float] = None,
                 flush_timeout: float = FLUSH_TIMEOUT_S) -> None:
        super().__init__(rank, world, batch_records, flush_timeout)
        if connect_secs is None:
            from paddlebox_tpu_torch.config.flags import HostFlags
            connect_secs = HostFlags().shuffle_connect_secs
        self.connect_secs = float(connect_secs)
        self.endpoints = list(endpoints)
        self._conns: Dict[int, socket.socket] = {}
        # a lock a destination: a slow peer does not hold up the others
        self._dest_locks = [threading.Lock() for _ in range(world)]
        self._stop = threading.Event()
        host, port = self.endpoints[rank]
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host, port))
        self._server.listen(world)
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    @property
    def port(self) -> int:
        return self._server.getsockname()[1]

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            threading.Thread(target=self._recv_loop, args=(conn,),
                             daemon=True).start()

    def _recv_loop(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                hdr = recv_exact(conn, _HDR.size)
                if hdr is None:
                    return
                mtype, src, epoch, length = _HDR.unpack(hdr)
                payload = recv_exact(conn, length) if length else b""
                if length and payload is None:
                    return
                if mtype == _MSG_DATA:
                    self._deliver(payload, epoch, src)
                elif mtype == _MSG_DONE:
                    self._peer_done(src, epoch)
        finally:
            conn.close()

    def _send_frame(self, dest: int, mtype: int, payload: bytes) -> None:
        frame = _HDR.pack(mtype, self.rank, self.epoch, len(payload)) + payload
        with self._dest_locks[dest]:
            conn = self._conns.get(dest)
            if conn is None:
                host, port = self.endpoints[dest]
                try:
                    conn = socket.create_connection(
                        (host, port), timeout=self.connect_secs)
                except OSError as e:
                    raise ShufflePeerUnreachable(
                        "shuffle peer %d unreachable at %s:%d: %r"
                        % (dest, host, port, e)) from e
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conn.settimeout(None)
                self._conns[dest] = conn
            conn.sendall(frame)

    def _send(self, dest: int, payload: bytes) -> None:
        self._send_frame(dest, _MSG_DATA, payload)

    def _send_done(self, dest: int) -> None:
        self._send_frame(dest, _MSG_DONE, b"")

    def close(self) -> None:
        self._stop.set()
        try:
            self._server.close()
        except OSError:
            pass
        for s in self._conns.values():
            try:
                s.close()
            except OSError:
                pass
        self._conns.clear()
