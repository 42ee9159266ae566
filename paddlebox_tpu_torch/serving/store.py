"""The mmap view store: the serving plane's composition of a day's views.

The port of paddlebox_tpu/serving/store.py, the same files byte for byte.
The trainer writes a day as a base view and cadenced delta views
(train/checkpoint.py); serving answers lookups over the composed view (the
freshest view holding a key wins) without reading the rows into memory:
the replicas of a box map the same files, and the page cache holds the one
copy of the rows.

  * the columnar file: ``write_xbox_columnar`` (magic PBTXBOX1, the sorted
    uint64 key column and the float32 [n, dim] rows, each 64-byte
    aligned) and ``MmapXboxStore``, one file mapped behind the native
    route index (native/route.cc ``rt_lookup_serve``, a miss -1);
  * the view compile: ``compile_view_dir`` writes a legacy
    ``embedding.pkl``'s columnar twin ``view.xcol`` once (atomic, gated by
    mtime); the checkpoint plane writes ``view.xcol`` directly;
  * the precedence rule: ``discover_xbox_sources`` orders a day's views by
    structure (day, then a day's deltas by id before its base) with the
    DONE timestamp only as the last tie-break, the rule XboxModelReader
    composes by too; ``MmapViewStack`` probes newest first;
  * the fleet partition: ``ShardSpec`` filters a view to one box's keys
    (its policy's shard and the replicated hot set of ``write_hot_keys``),
    under a file name whose tag is the reference's, so either package's
    box shares the other's filtered file.

This module imports numpy, the standard library and the native host
library only: a serving replica loads no torch.
"""

from __future__ import annotations

import glob
import os
import re
import threading
import zlib
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from paddlebox_tpu_torch.embedding.ckpt_store import safe_load
from paddlebox_tpu_torch.native import host_lib

XBOX_MAGIC = b"PBTXBOX1"
HOT_MAGIC = b"PBTHOTK1"

#: the columnar view file of a view directory
VIEW_COLUMNAR_NAME = "view.xcol"


def _align64(off: int) -> int:
    return (off + 63) // 64 * 64


def write_xbox_columnar(path: str, keys: np.ndarray,
                        rows: np.ndarray) -> str:
    """One view file: 8-byte magic, int64 n, int64 dim, then the strictly
    sorted uint64 key column and the float32 [n, dim] row matrix, each
    64-byte aligned; written atomically (a tmp named by pid and thread,
    then rename)."""
    keys = np.ascontiguousarray(keys, np.uint64)
    rows = np.ascontiguousarray(rows, np.float32)
    if keys.ndim != 1 or rows.ndim != 2 or rows.shape[0] != keys.size:
        raise ValueError("keys must be [n], rows [n, dim]")
    if keys.size > 1 and not (keys[1:] > keys[:-1]).all():
        raise ValueError("keys must be strictly sorted")
    key_off = _align64(8 + 8 + 8)
    row_off = _align64(key_off + keys.nbytes)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "wb") as f:
        f.write(XBOX_MAGIC)
        f.write(np.int64(keys.size).tobytes())
        f.write(np.int64(rows.shape[1]).tobytes())
        f.seek(key_off)
        keys.tofile(f)
        f.seek(row_off)
        rows.tofile(f)
        # an empty view (a delta save that nothing crossed) writes no array
        # bytes: pad to the full layout so that readers map it as it is
        f.truncate(row_off + rows.nbytes)
    os.replace(tmp, path)
    return path


def _xbox_header(path: str) -> Tuple[int, int, int, int]:
    """(n, dim, key_off, row_off) of one view file."""
    with open(path, "rb") as f:
        if f.read(8) != XBOX_MAGIC:
            raise ValueError(f"{path}: not an xbox columnar store")
        n = int(np.frombuffer(f.read(8), np.int64)[0])
        dim = int(np.frombuffer(f.read(8), np.int64)[0])
    key_off = _align64(8 + 8 + 8)
    return n, dim, key_off, _align64(key_off + n * 8)


def read_xbox_columnar(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(keys [n] uint64, rows [n, dim] f32) read-only maps of one view
    file."""
    n, dim, key_off, row_off = _xbox_header(path)
    if n == 0:
        return np.empty(0, np.uint64), np.empty((0, dim), np.float32)
    return (np.memmap(path, np.uint64, "r", key_off, (n,)),
            np.memmap(path, np.float32, "r", row_off, (n, dim)))


def read_xbox_view(view_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """(keys, embedding rows) of one view directory in either format: the
    legacy ``embedding.pkl`` or the columnar ``view.xcol``."""
    pkl = os.path.join(view_dir, "embedding.pkl")
    if os.path.exists(pkl):
        with open(pkl, "rb") as f:
            blob = safe_load(f)
        return (np.asarray(blob["keys"], np.uint64).ravel(),
                np.asarray(blob["embedding"], np.float32))
    xcol = os.path.join(view_dir, VIEW_COLUMNAR_NAME)
    if os.path.exists(xcol):
        keys, rows = read_xbox_columnar(xcol)
        return np.asarray(keys), np.asarray(rows, np.float32)
    raise FileNotFoundError(
        f"{view_dir}: neither embedding.pkl nor {VIEW_COLUMNAR_NAME}")


class MmapXboxStore:
    """One columnar view file, mapped read-only: the keys behind a native
    hash index (``rt_lookup_serve``, about one probe a key; the index
    holds the keys only), the rows left to the page cache. An empty view
    maps nothing and builds no index. ``close`` (or ``__del__``, when the
    last lookup holding the store drops it) frees the index."""

    def __init__(self, path: str) -> None:
        self.path = path
        n, dim, key_off, row_off = _xbox_header(path)
        self._n, self._dim = n, dim
        self._index = None
        if n:
            self._keys = np.memmap(path, np.uint64, "r", key_off, (n,))
            self._rows = np.memmap(path, np.float32, "r", row_off, (n, dim))
            self._index = host_lib.create_route_index(self._keys)
        else:
            self._keys = np.empty(0, np.uint64)
            self._rows = np.empty((0, dim), np.float32)

    def __len__(self) -> int:
        return self._n

    @property
    def dim(self) -> int:
        return self._dim

    def lookup_ids(self, keys: np.ndarray) -> np.ndarray:
        """[K] uint64 -> [K] int32 row ids, -1 for a key this view lacks."""
        keys = np.ascontiguousarray(np.asarray(keys, np.uint64).reshape(-1))
        if not (self._n and keys.size):
            return np.full(keys.size, -1, np.int32)
        return host_lib.route_lookup_serve(self._index, keys, -1)

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """[K] uint64 -> [K, dim] float32; a missing key is a zero row."""
        keys = np.asarray(keys, np.uint64).reshape(-1)
        out = np.zeros((keys.size, self._dim), np.float32)
        ids = self.lookup_ids(keys)
        hit = ids >= 0
        out[hit] = self._rows[ids[hit]]
        return out

    def close(self) -> None:
        index, self._index = self._index, None
        host_lib.destroy_route_index(index)

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 (an interpreter at exit)
            pass


class XboxSource(NamedTuple):
    """One completed view, sorting into apply order (oldest precedence
    first): day index, then a day's deltas by id before its base (run_day
    writes the base at the day's end), the DONE timestamp only as the last
    tie-break."""
    day_index: int
    is_base: int          # 1: the day's base, after its deltas
    delta_id: int
    done_ts: float
    path: str


def _done_ts(dirpath: str) -> float:
    with open(os.path.join(dirpath, "DONE")) as f:
        return float(f.read().strip())


def discover_xbox_sources(xbox_model_dir: str,
                          days: Sequence[str]) -> List[XboxSource]:
    """The completed views (DONE present) of ``days`` (oldest first) under
    the xbox model root, in apply order. The last day's base need not exist
    yet; raises FileNotFoundError when no day has a base."""
    sources: List[XboxSource] = []
    have_base = False
    for di, day in enumerate(days):
        root = os.path.join(xbox_model_dir, day)
        if os.path.exists(os.path.join(root, "DONE")):
            have_base = True
            sources.append(XboxSource(di, 1, 0, _done_ts(root), root))
        for d in glob.glob(os.path.join(root, "delta-*")):
            m = re.fullmatch(r"delta-(\d+)", os.path.basename(d))
            if m and os.path.exists(os.path.join(d, "DONE")):
                sources.append(
                    XboxSource(di, 0, int(m.group(1)), _done_ts(d), d))
    if not have_base:
        raise FileNotFoundError(
            f"no completed xbox base under {xbox_model_dir} for "
            f"{tuple(days)}")
    return sorted(sources)


def discover_days(xbox_model_dir: str) -> List[str]:
    """The day directories with at least one completed view, in lexical
    order (day names must sort in cadence order: day0, day1, ... or date
    stamps; other names are passed as ``days=``)."""
    try:
        entries = sorted(os.listdir(xbox_model_dir))
    except FileNotFoundError:
        return []
    out = []
    for day in entries:
        root = os.path.join(xbox_model_dir, day)
        if not os.path.isdir(root):
            continue
        if os.path.exists(os.path.join(root, "DONE")) or glob.glob(
                os.path.join(root, "delta-*", "DONE")):
            out.append(day)
    return out


def compile_view_dir(view_dir: str, force: bool = False) -> str:
    """The columnar file of one view directory: ``view.xcol`` as it is
    where no ``embedding.pkl`` exists, else the pickle's keys sorted and
    written beside it, unless a twin at least as new is there (``force``
    rewrites). The pickle is read with ``safe_load``: one holding another
    class than numpy's and the builtin containers raises. Two equal keys
    in one view raise ValueError."""
    src = os.path.join(view_dir, "embedding.pkl")
    out = os.path.join(view_dir, VIEW_COLUMNAR_NAME)
    if not os.path.exists(src):
        if os.path.exists(out):
            return out
        raise FileNotFoundError(
            f"{view_dir}: neither embedding.pkl nor {VIEW_COLUMNAR_NAME}")
    if (not force and os.path.exists(out)
            and os.path.getmtime(out) >= os.path.getmtime(src)):
        return out
    with open(src, "rb") as f:
        blob = safe_load(f)
    keys = np.asarray(blob["keys"], np.uint64).ravel()
    rows = np.asarray(blob["embedding"], np.float32)
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    if keys.size > 1 and not (keys[1:] > keys[:-1]).all():
        raise ValueError(f"{src}: duplicate keys inside one view")
    return write_xbox_columnar(out, keys, rows[order])


# ------------------------------------------------------ the fleet partition

def write_hot_keys(path: str, keys: np.ndarray) -> str:
    """The fleet's replicated hot set: 8-byte magic PBTHOTK1, int64 n, the
    sorted unique uint64 keys; written atomically. Every box and every
    client reads the same file."""
    keys = np.unique(np.ascontiguousarray(keys, np.uint64))
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "wb") as f:
        f.write(HOT_MAGIC)
        f.write(np.int64(keys.size).tobytes())
        keys.tofile(f)
    os.replace(tmp, path)
    return path


def read_hot_keys(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        if f.read(8) != HOT_MAGIC:
            raise ValueError(f"{path}: not a hot-key set")
        n = int(np.frombuffer(f.read(8), np.int64)[0])
        keys = np.fromfile(f, np.uint64, n)
    if keys.size != n:
        raise ValueError(f"{path}: truncated hot-key set")
    return keys


class ShardSpec:
    """One box's slice of the fleet's partition: the keys ``policy``
    (parallel/sharding.py) routes to ``index``, and the replicated hot set
    every box serves. ``filter_view`` writes a view's subset beside it
    (gated by mtime, atomic, so a box's replicas write it once) under a
    name whose tag is a crc32 of the policy's identity, the index and the
    hot keys: a change of any of them never reuses a stale file. A key
    keeps its views through the filter, so the filtered stack answers
    every key the box serves as the full one does."""

    def __init__(self, index: int, policy,
                 hot_keys: Optional[np.ndarray] = None) -> None:
        if not 0 <= int(index) < policy.num_shards:
            raise ValueError(
                f"shard index {index} outside policy range "
                f"[0, {policy.num_shards})")
        self.index = int(index)
        self.policy = policy
        self.hot = (np.unique(np.asarray(hot_keys, np.uint64))
                    if hot_keys is not None and len(hot_keys)
                    else np.empty(0, np.uint64))
        self._tag = "s%dof%d-%08x" % (
            self.index, policy.num_shards,
            zlib.crc32(self.describe().encode() + self.hot.tobytes()))

    def describe(self) -> str:
        """The policy's identity and the index: what a server names when
        it refuses a pull routed to another box."""
        return "%s#%d" % (self.policy.describe(), self.index)

    def mask(self, keys: np.ndarray) -> np.ndarray:
        """[K] bool: the keys this box serves (its shard's, or hot)."""
        keys = np.asarray(keys, np.uint64).reshape(-1)
        m = self.policy.shard_of(keys) == self.index
        if self.hot.size:
            pos = np.minimum(np.searchsorted(self.hot, keys),
                             self.hot.size - 1)
            m |= self.hot[pos] == keys
        return m

    def filter_view(self, columnar_path: str) -> str:
        out = f"{columnar_path}.{self._tag}"
        if (os.path.exists(out) and os.path.getmtime(out)
                >= os.path.getmtime(columnar_path)):
            return out
        keys, rows = read_xbox_columnar(columnar_path)
        keep = self.mask(keys)
        return write_xbox_columnar(
            out, np.asarray(keys[keep]), np.asarray(rows[keep]))


# ------------------------------------------------------ the precedence stack

class MmapViewStack:
    """The composed view as a newest-first probe chain over one
    ``MmapXboxStore`` a view: a key takes its row from the freshest view
    holding it, a key in none is a zero row (XboxModelReader's
    composition, never materialized). A stack is immutable: a refresh
    builds a new one and swaps it in (serving/refresh.py), and a lookup in
    flight keeps the old one alive until it returns."""

    def __init__(self, sources: Sequence[XboxSource],
                 shard_spec: Optional[ShardSpec] = None,
                 extra_files: Sequence[str] = ()) -> None:
        """``sources`` in apply order (oldest first); ``extra_files``:
        columnar files stacked freshest, after the newest source (the
        journal's overlay); ``shard_spec``: every view filtered to this
        box's slice first."""
        if not (sources or extra_files):
            raise ValueError("need at least one source")
        self.sources = tuple(sources)
        paths = [compile_view_dir(s.path) for s in self.sources]
        paths += list(extra_files)
        if shard_spec is not None:
            paths = [shard_spec.filter_view(p) for p in paths]
        self._open_views(paths)

    @classmethod
    def from_files(cls, paths: Sequence[str]) -> "MmapViewStack":
        """A stack over columnar files as they are, oldest first."""
        self = cls.__new__(cls)
        self.sources = ()
        self._open_views(list(paths))
        return self

    def _open_views(self, columnar_paths: Sequence[str]) -> None:
        """Open the files newest first and pin their dim (an empty view
        has a dim in its header but does not vote)."""
        if not columnar_paths:
            raise ValueError("need at least one view")
        self._views = [MmapXboxStore(p) for p in reversed(columnar_paths)]
        dims = {v.dim for v in self._views if len(v)}
        if len(dims) > 1:
            raise ValueError(f"views disagree on dim: {sorted(dims)}")
        self._dim = dims.pop() if dims else self._views[0].dim

    @property
    def dim(self) -> int:
        return self._dim

    @property
    def total_rows(self) -> int:
        """The views' rows summed (a key in k views counts k times)."""
        return sum(len(v) for v in self._views)

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """[K] uint64 -> [K, dim] float32, the freshest view's row."""
        keys = np.asarray(keys, np.uint64).reshape(-1)
        out = np.zeros((keys.size, self._dim), np.float32)
        pending = np.arange(keys.size)
        for v in self._views:
            if not pending.size:
                break
            if not len(v):
                continue
            ids = v.lookup_ids(keys[pending])
            hit = ids >= 0
            if hit.any():
                out[pending[hit]] = v._rows[ids[hit]]
                pending = pending[~hit]
        return out

    def close(self) -> None:
        for v in self._views:
            v.close()


def build_stack(xbox_model_dir: str,
                days: Optional[Sequence[str]] = None,
                shard_spec: Optional[ShardSpec] = None
                ) -> Tuple[MmapViewStack, Tuple[XboxSource, ...]]:
    """The current composed view of ``days`` (default: every day found)
    and its sources, the refresh watcher's key of change."""
    days = list(days) if days else discover_days(xbox_model_dir)
    sources = discover_xbox_sources(xbox_model_dir, days)
    return MmapViewStack(sources, shard_spec=shard_spec), tuple(sources)
