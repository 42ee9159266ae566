"""Streaming ingest: tail a live source into bounded micro-pass windows
(paddlebox_tpu/data/streaming.py, the same rules and window cuts).

A ``StreamingDataset`` tails a watched directory (upstream writers land
MultiSlot text files) or a socket feed (producers push lines over TCP and
``SocketFeedServer`` spools them as files into the same directory) and cuts
it into micro-pass windows: runs of complete files that each become one
ordinary BoxDataset, preloaded and trained like a day's pass
(train/streaming_runner.py).

What keeps a file out until it is whole:

  * the rename convention: a ``.tmp`` / ``.part`` / ``.inprogress`` /
    ``.open`` suffix or a ``.`` / ``_`` name prefix is never read;
  * size stability: a bare file counts as sealed only after its size is
    unchanged and nonzero over ``streaming_stable_polls`` polls;
  * the consumed-file ledger: every file of a committed window is recorded
    (one JSON document replaced atomically) and skipped on a rescan, so a
    restarted tailer does not consume it twice. The runner commits at the
    micro-pass boundary, after the window trained or was refused.

``dataset_kwargs`` go to each window's BoxDataset: the reference's
``read_threads`` (the dataset's default, 4, where it is not given) and
``shuffler`` are passed there, ``dataset_kwargs={"read_threads": 2}``.
Each window's load merges its files in file order at any
``read_threads`` (data/dataset.py), so a window's block, and the
admission gate's score of it, repeat from run to run.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from paddlebox_tpu_torch.config.flags import StreamFlags
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.utils.lockwatch import make_lock
from paddlebox_tpu_torch.utils.stats import gauge_set, stat_add

#: suffixes of a file a writer has not finished
IN_PROGRESS_SUFFIXES = (".tmp", ".part", ".inprogress", ".open")


def _is_in_progress_name(name: str) -> bool:
    """A writer's scratch name (temp suffix, hidden or ``_`` prefix)."""
    if name.startswith(".") or name.startswith("_"):
        return True
    return any(name.endswith(s) for s in IN_PROGRESS_SUFFIXES)


def _count_lines(path: str) -> int:
    """A MultiSlot file's instances: its lines (an unterminated last line
    counts), by a buffered byte scan."""
    n = 0
    last = b"\n"
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            n += chunk.count(b"\n")
            last = chunk[-1:]
    if last != b"\n":
        n += 1
    return n


class FileLedger:
    """Which source files entered a committed window, by basename (the
    watched directory is the namespace), persisted as one JSON document
    replaced atomically (temp file, fsync, os.replace): a crash leaves the
    previous whole document, so a restart at worst re-consumes the windows
    since the last commit."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._files: Dict[str, int] = {}
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        try:
            with open(path, encoding="utf-8") as fh:
                doc = json.load(fh)
            self._files = {str(k): int(v)
                           for k, v in doc.get("files", {}).items()}
        except (OSError, ValueError):
            self._files = {}

    def consumed(self, path: str) -> bool:
        return os.path.basename(path) in self._files

    def record(self, paths: Sequence[str]) -> None:
        """Mark in memory only; ``flush`` persists."""
        for p in paths:
            try:
                size = os.path.getsize(p)
            except OSError:
                size = -1
            self._files[os.path.basename(p)] = size

    def flush(self) -> None:
        """Persist (one writer: the micro-pass boundary)."""
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump({"version": 1, "files": self._files}, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)

    def mark(self, paths: Sequence[str]) -> None:
        if not paths:
            return
        self.record(paths)
        self.flush()

    def __len__(self) -> int:
        return len(self._files)


class DirectoryWatcher:
    """Each ``poll()`` relists the directory and returns the files that
    became ready since the last call, by mtime then name. Ready: not a
    scratch name, not in the ledger, nonzero size unchanged over
    ``stable_polls`` polls. A file is returned once a watcher."""

    def __init__(self, source_dir: str, ledger: Optional[FileLedger] = None,
                 stable_polls: Optional[int] = None,
                 flags: Optional[StreamFlags] = None) -> None:
        self.source_dir = source_dir
        self.ledger = ledger
        self.stable_polls = int(
            stable_polls if stable_polls is not None
            else (flags or StreamFlags()).streaming_stable_polls)
        self._sizes: Dict[str, Tuple[int, int]] = {}  # name -> (size, polls)
        self._yielded: set = set()

    def poll(self) -> List[str]:
        try:
            names = os.listdir(self.source_dir)
        except OSError:
            return []
        ready: List[Tuple[float, str, str]] = []
        for name in sorted(names):
            if _is_in_progress_name(name) or name in self._yielded:
                continue
            path = os.path.join(self.source_dir, name)
            if self.ledger is not None and self.ledger.consumed(path):
                self._yielded.add(name)
                continue
            try:
                st = os.stat(path)
            except OSError:
                continue   # gone between listdir and stat
            if not os.path.isfile(path) or st.st_size == 0:
                continue
            size, stable = self._sizes.get(name, (-1, 0))
            stable = stable + 1 if st.st_size == size else 1
            self._sizes[name] = (st.st_size, stable)
            if stable >= self.stable_polls:
                ready.append((st.st_mtime, name, path))
        out = []
        for _, name, path in sorted(ready):
            self._yielded.add(name)
            self._sizes.pop(name, None)
            out.append(path)
        if out:
            stat_add("streaming_files_discovered", len(out))
        return out


class SocketFeedServer:
    """A TCP listener that spools pushed MultiSlot lines into the watched
    directory: each connection's lines go to a ``spool-NNNNNNNN.txt.tmp``
    file renamed into place every ``spool_lines`` lines and at the
    connection's close (the rename convention the watcher trusts)."""

    def __init__(self, spool_dir: str, port: int = 0,
                 spool_lines: int = 2048, host: str = "127.0.0.1") -> None:
        os.makedirs(spool_dir, exist_ok=True)
        self.spool_dir = spool_dir
        self.spool_lines = int(spool_lines)
        self._srv = socket.create_server((host, port))
        self._srv.settimeout(0.2)
        self.port = self._srv.getsockname()[1]
        self._seq_lock = make_lock("SocketFeedServer._seq_lock")
        self._seq = 0
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._accept = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="stream-accept")
        self._accept.start()

    def _next_spool(self) -> str:
        with self._seq_lock:
            self._seq += 1
            return os.path.join(self.spool_dir,
                                "spool-%08d.txt" % self._seq)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._conn_loop, args=(conn,),
                                 daemon=True, name="stream-spool")
            t.start()
            self._threads.append(t)

    def _conn_loop(self, conn: socket.socket) -> None:
        try:
            buf = b""
            lines: List[bytes] = []
            conn.settimeout(0.5)
            while not self._stop.is_set():
                try:
                    chunk = conn.recv(1 << 16)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if not chunk:
                    break
                buf += chunk
                *full, buf = buf.split(b"\n")
                lines.extend(full)
                if len(lines) >= self.spool_lines:
                    self._seal(lines[:self.spool_lines])
                    lines = lines[self.spool_lines:]
            if buf:
                lines.append(buf)   # closed without a last newline
            self._seal(lines)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _seal(self, lines: List[bytes]) -> None:
        lines = [ln for ln in lines if ln.strip()]
        if not lines:
            return
        path = self._next_spool()
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(b"\n".join(lines) + b"\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        stat_add("streaming_spool_files", 1)
        stat_add("streaming_spool_lines", len(lines))

    def close(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        self._accept.join(timeout=5.0)
        for t in self._threads:
            t.join(timeout=5.0)


class MicroWindow:
    """One micro-pass of source files as a BoxDataset. ``born_ts`` is the
    newest file's mtime (the ingest timestamp the lag gauges measure from)
    and ``born_min_ts`` the oldest's: the pair rides the journal's
    watermark record."""

    def __init__(self, index: int, files: List[str], instances: int,
                 dataset: BoxDataset) -> None:
        self.index = index
        self.files = list(files)
        self.instances = int(instances)
        self.dataset = dataset
        self.born_ts = max((os.path.getmtime(f) for f in files),
                           default=time.time())
        self.born_min_ts = min((os.path.getmtime(f) for f in files),
                               default=self.born_ts)
        self.formed_ts = time.time()


class StreamingDataset:
    """Tail ``source_dir`` into micro-pass windows.

    ``next_window(deadline=...)`` polls every ``streaming_poll_secs`` until
    the ready files fill ``streaming_micro_pass_instances`` instances, or
    until files have waited ``flush_after`` seconds (default ten polls),
    and returns a MicroWindow (None at the deadline or after ``stop``). The
    runner commits a window to the ledger at its boundary
    (``commit_window``). ``socket_port`` (0: any free port) starts a
    SocketFeedServer spooling into ``source_dir``.

    next_window runs on one thread (the runner's fetcher), commit_window
    on the train thread; they share only the ledger, under ``_lock``."""

    def __init__(self, feed, source_dir: str,
                 ledger_dir: Optional[str] = None,
                 read_threads: int = 2, shuffler=None,
                 micro_pass_instances: Optional[int] = None,
                 flush_after: Optional[float] = None,
                 socket_port: Optional[int] = None,
                 dataset_kwargs: Optional[dict] = None,
                 flags: Optional[StreamFlags] = None) -> None:
        flags = flags or StreamFlags()
        self.feed = feed
        self.source_dir = source_dir
        self.read_threads = int(read_threads)
        self.shuffler = shuffler
        self.micro_pass_instances = int(
            micro_pass_instances if micro_pass_instances is not None
            else flags.streaming_micro_pass_instances)
        self.poll_secs = float(flags.streaming_poll_secs)
        # long enough to coalesce a burst, short enough that a trickle
        # still trains within seconds
        self.flush_after = (float(flush_after) if flush_after is not None
                            else 10.0 * self.poll_secs)
        self._dataset_kwargs = dict(dataset_kwargs or {})
        os.makedirs(source_dir, exist_ok=True)
        self.ledger = FileLedger(os.path.join(
            ledger_dir or source_dir, "_streaming", "consumed.json"))
        self.watcher = DirectoryWatcher(source_dir, self.ledger, flags=flags)
        self.server: Optional[SocketFeedServer] = None
        if socket_port is not None:
            self.server = SocketFeedServer(source_dir, port=socket_port)
        self._lock = make_lock("StreamingDataset._lock")
        self._pending: List[Tuple[str, int]] = []   # (path, lines)
        self._pending_since: Optional[float] = None
        self._windows = 0
        self._stop = threading.Event()

    def _pending_instances(self) -> int:
        return sum(n for _, n in self._pending)

    def _cut_window(self) -> MicroWindow:
        """The pending files up to the instance bound, as one window (at
        least one file, however large)."""
        files: List[str] = []
        instances = 0
        while self._pending:
            path, n = self._pending[0]
            if files and instances + n > self.micro_pass_instances:
                break
            files.append(path)
            instances += n
            self._pending.pop(0)
        self._pending_since = time.time() if self._pending else None
        # each window's BoxDataset reads with read_threads and shuffles
        # through shuffler; the same keys in dataset_kwargs win
        kw = {"read_threads": self.read_threads, "shuffler": self.shuffler}
        kw.update(self._dataset_kwargs)
        ds = BoxDataset(self.feed, **kw)
        ds.set_filelist(files)
        win = MicroWindow(self._windows, files, instances, ds)
        self._windows += 1
        gauge_set("streaming_window_instances", float(instances))
        stat_add("streaming_windows_formed")
        return win

    def next_window(self, deadline: Optional[float] = None
                    ) -> Optional[MicroWindow]:
        """Block until a window is ready; None at ``deadline`` (absolute
        time.time()) or after stop()."""
        while not self._stop.is_set():
            for path in self.watcher.poll():
                try:
                    n = _count_lines(path)
                except OSError:
                    continue   # gone mid-count: the next poll relists
                if n == 0:
                    continue
                if not self._pending:
                    self._pending_since = time.time()
                self._pending.append((path, n))
            if self._pending:
                full = self._pending_instances() >= self.micro_pass_instances
                aged = (self._pending_since is not None
                        and time.time() - self._pending_since
                        >= self.flush_after)
                if full or aged:
                    return self._cut_window()
            if deadline is not None and time.time() >= deadline:
                return None
            self._stop.wait(self.poll_secs)
        return None

    def commit_window(self, window: MicroWindow) -> None:
        """The micro-pass boundary: record the window's files as consumed
        (trained or refused: a refused window is dropped, not retried). The
        mark is under the lock, the fsync'd write outside it."""
        if window.files:
            with self._lock:
                self.ledger.record(window.files)
            self.ledger.flush()
        stat_add("streaming_windows_committed")

    def stop(self) -> None:
        """Unblock next_window and stop the socket spooler."""
        self._stop.set()
        if self.server is not None:
            self.server.close()

    def resume(self) -> None:
        """Clear a stop() so a new run tails again (a closed spooler stays
        closed)."""
        self._stop.clear()

    def close(self) -> None:
        self.stop()

    @property
    def socket_port(self) -> Optional[int]:
        return self.server.port if self.server is not None else None
