"""Columnar, striped, parallel sparse-checkpoint I/O.

The port's copy of paddlebox_tpu/embedding/ckpt_store.py, in the same
on-disk format, so either package loads what the other wrote. The switches
the reference reads from its flag registry at call time (ckpt_format,
ckpt_parts, ckpt_io_threads) are arguments here, with the defaults of
``config.flags.CkptFlags``.

On-disk layout of a save at ``<path>`` (the manifest path is the
checkpoint path, e.g. ``sparse.xman``):

  <path>             JSON manifest {format, version, mode, n, width,
                     meta{embedx_dim, optimizer}, parts[{file, n}]}
  <path>.p0000...    part files: 8-byte magic PBTSPRS1, int64 n, int64
                     width, then the uint64 key column and the float32
                     [n, width] row matrix, each 64-byte aligned

Part rows are contiguous stripes of the caller's (keys, values), so the
parts concatenated in manifest order are exactly the arrays a legacy
pickle blob carries. Every pickle the checkpoint plane reads (the legacy
``sparse.pkl``, ``dense.pkl``, a legacy ``embedding.pkl`` view) goes
through ``safe_load``, which rebuilds numpy arrays and builtin containers
and refuses any other class: a file written by the JAX package that holds
jax arrays raises instead of importing jax.
"""

from __future__ import annotations

import glob
import json
import os
import pickle
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import BinaryIO, Dict, List, Optional, Tuple

import numpy as np

PART_MAGIC = b"PBTSPRS1"
MANIFEST_FORMAT = "pbtpu-sparse-columnar"
MANIFEST_VERSION = 1
# ckpt_parts' default: part files of a columnar save
DEFAULT_PARTS = 8

# what safe_load lets a pickle rebuild: numpy arrays, dtypes and scalars,
# and these builtins
_SAFE_BUILTINS = frozenset((
    "dict", "list", "tuple", "set", "frozenset", "int", "float", "complex",
    "bool", "str", "bytes", "bytearray", "slice", "range"))


class _NumpyUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        if module == "builtins" and name in _SAFE_BUILTINS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            "checkpoint pickle holds %s.%s: only numpy arrays and builtin "
            "containers load here" % (module, name))


def safe_load(f: BinaryIO):
    """pickle.load restricted to numpy and builtin containers; any other
    class raises pickle.UnpicklingError before its module is imported."""
    return _NumpyUnpickler(f).load()


def _align64(off: int) -> int:
    return (off + 63) // 64 * 64


def io_threads(n_parts: int, threads: int = 0) -> int:
    """Writer/reader pool width: ``threads``, or (at 0) one thread a part
    capped at the cores and at 16."""
    if threads > 0:
        return max(1, min(threads, n_parts))
    return max(1, min(n_parts, os.cpu_count() or 1, 16))


def default_parts(n_rows: int, parts: int = DEFAULT_PARTS) -> int:
    """Part count: ``parts``, trimmed so that no part is empty."""
    p = max(1, int(parts))
    return max(1, min(p, n_rows)) if n_rows else 1


def _fsync_dir(dirpath: str) -> None:
    try:
        fd = os.open(dirpath or ".", os.O_RDONLY)
    except OSError:
        return  # not every filesystem opens a directory; rename is atomic
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_part(path: str, keys: np.ndarray, values: np.ndarray,
               fsync: bool = True) -> str:
    """One part file, atomically (tmp + fsync + rename). keys [n] uint64,
    values [n, width] float32 in any row order. Stray ``<path>.*.tmp``
    files of a writer that died mid-save are removed first."""
    keys = np.ascontiguousarray(keys, np.uint64)
    values = np.ascontiguousarray(values, np.float32)
    if keys.ndim != 1 or values.ndim != 2 or values.shape[0] != keys.size:
        raise ValueError("keys must be [n], values [n, width]")
    for stray in glob.glob(f"{path}.*.tmp"):
        try:
            os.remove(stray)
        except OSError:
            pass
    key_off = _align64(8 + 8 + 8)
    row_off = _align64(key_off + keys.nbytes)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "wb") as f:
        f.write(PART_MAGIC)
        f.write(np.int64(keys.size).tobytes())
        f.write(np.int64(values.shape[1]).tobytes())
        f.seek(key_off)
        keys.tofile(f)
        f.seek(row_off)
        values.tofile(f)
        # an empty part writes no array bytes: pad to the full layout so
        # that readers map it without a special case
        f.truncate(row_off + values.nbytes)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def map_part(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """mmap one part: (keys [n] uint64, values [n, width] f32) views."""
    with open(path, "rb") as f:
        if f.read(8) != PART_MAGIC:
            raise ValueError(f"{path}: not a sparse checkpoint part")
        n = int(np.frombuffer(f.read(8), np.int64)[0])
        width = int(np.frombuffer(f.read(8), np.int64)[0])
    key_off = _align64(8 + 8 + 8)
    row_off = _align64(key_off + n * 8)
    if n == 0:
        return np.empty(0, np.uint64), np.empty((0, width), np.float32)
    keys = np.memmap(path, np.uint64, "r", key_off, (n,))
    values = np.memmap(path, np.float32, "r", row_off, (n, width))
    return keys, values


def _stripe_bounds(n: int, parts: int) -> List[Tuple[int, int]]:
    cuts = np.linspace(0, n, parts + 1).astype(np.int64)
    return [(int(cuts[i]), int(cuts[i + 1])) for i in range(parts)]


def _run_pool(fn, n: int, threads: int) -> None:
    """fn(i) for i in range(n), on a pool when it has more than one
    worker; the first failure is raised."""
    workers = io_threads(n, threads)
    if workers > 1 and n > 1:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(fn, range(n)))
    else:
        for i in range(n):
            fn(i)


def write_sparse_columnar(manifest_path: str, keys: np.ndarray,
                          values: np.ndarray, meta: Dict,
                          parts: Optional[int] = None,
                          fsync: bool = True, threads: int = 0) -> str:
    """The full-save writer: stripe (keys, values) into part files written
    by a pool of ``threads`` (``io_threads``), then land the manifest
    atomically after every part is durable, so a crash leaves the previous
    manifest or the complete new one. ``parts``: the part count, trimmed
    by default_parts when None. meta carries embedx_dim and optimizer."""
    keys = np.ascontiguousarray(keys, np.uint64)
    values = np.ascontiguousarray(values, np.float32)
    if keys.ndim != 1 or values.ndim != 2 or values.shape[0] != keys.size:
        raise ValueError("keys must be [n], values [n, width]")
    n = int(keys.size)
    n_parts = parts if parts else default_parts(n)
    bounds = _stripe_bounds(n, n_parts)
    part_names = [f"{os.path.basename(manifest_path)}.p{i:04d}"
                  for i in range(n_parts)]
    dirpath = os.path.dirname(manifest_path) or "."
    os.makedirs(dirpath, exist_ok=True)

    def write_one(i: int) -> None:
        lo, hi = bounds[i]
        write_part(os.path.join(dirpath, part_names[i]),
                   keys[lo:hi], values[lo:hi], fsync=fsync)

    _run_pool(write_one, n_parts, threads)
    manifest = {
        "format": MANIFEST_FORMAT, "version": MANIFEST_VERSION,
        "mode": "full", "n": n, "width": int(values.shape[1]),
        "meta": {"embedx_dim": int(meta["embedx_dim"]),
                 "optimizer": str(meta["optimizer"])},
        "parts": [{"file": part_names[i], "n": bounds[i][1] - bounds[i][0]}
                  for i in range(n_parts)],
    }
    tmp = f"{manifest_path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, manifest_path)
    if fsync:
        _fsync_dir(dirpath)
    return manifest_path


def read_manifest(path: str) -> Dict:
    with open(path, "r") as f:
        doc = json.load(f)
    if doc.get("format") != MANIFEST_FORMAT:
        raise ValueError(f"{path}: not a sparse checkpoint manifest")
    return doc


def load_sparse_columnar(manifest_path: str, threads: int = 0) -> Dict:
    """Parallel columnar load into the blob dict the pickle path carries
    ({"keys", "values", "embedx_dim", "optimizer"}): the parts are mapped
    and copied into one preallocated (keys, values) pair by a pool of
    ``threads`` readers, each on its own stripe."""
    doc = read_manifest(manifest_path)
    if doc.get("mode") != "full":
        raise ValueError(
            f"{manifest_path}: mode={doc.get('mode')!r} manifests (journal"
            "-over-base) reconstruct through CheckpointManager.load_base, "
            "not a raw store load")
    n, width = int(doc["n"]), int(doc["width"])
    dirpath = os.path.dirname(manifest_path) or "."
    keys = np.empty(n, np.uint64)
    values = np.empty((n, width), np.float32)
    offs = []
    off = 0
    for p in doc["parts"]:
        offs.append(off)
        off += int(p["n"])
    if off != n:
        raise ValueError(f"{manifest_path}: part rows {off} != n {n}")

    def read_one(i: int) -> None:
        p = doc["parts"][i]
        pk, pv = map_part(os.path.join(dirpath, p["file"]))
        if pk.size != int(p["n"]) or pv.shape[1] != width:
            raise ValueError(
                f"{manifest_path}: part {p['file']} shape mismatch")
        lo = offs[i]
        keys[lo:lo + pk.size] = pk
        values[lo:lo + pk.size] = pv

    _run_pool(read_one, len(doc["parts"]), threads)
    return {"keys": keys, "values": values,
            "embedx_dim": doc["meta"]["embedx_dim"],
            "optimizer": doc["meta"]["optimizer"]}


def is_manifest_file(path: str) -> bool:
    """A manifest is JSON (first byte '{'); a pickle of protocol 2 or more
    starts with b'\\x80'."""
    try:
        with open(path, "rb") as f:
            head = f.read(1)
    except OSError:
        return False
    return head == b"{"


def load_sparse_any(path: str, threads: int = 0) -> Dict:
    """A columnar manifest or a legacy pickle blob at ``path`` -> the blob
    dict; the one dispatch every store load rides."""
    if is_manifest_file(path):
        return load_sparse_columnar(path, threads)
    with open(path, "rb") as f:
        return safe_load(f)


def save_sparse_auto(path: str, keys: np.ndarray, values: np.ndarray,
                     meta: Dict, fmt: str = "columnar",
                     parts: int = DEFAULT_PARTS, threads: int = 0) -> str:
    """``fmt`` 'columnar': the manifest and parts at ``path`` (``parts``
    trimmed by default_parts); 'pickle': the legacy one-blob pickle.
    Loaders sniff the format."""
    if fmt == "pickle":
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump({"keys": keys, "values": values,
                         "embedx_dim": int(meta["embedx_dim"]),
                         "optimizer": str(meta["optimizer"])}, f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        return path
    if fmt != "columnar":
        raise ValueError("checkpoint format %r not in ('columnar', "
                         "'pickle')" % (fmt,))
    return write_sparse_columnar(
        path, keys, values, meta,
        parts=default_parts(int(np.asarray(keys).size), parts),
        threads=threads)


def manifest_part_paths(manifest_path: str) -> List[str]:
    """Paths of a full manifest's part files."""
    doc = read_manifest(manifest_path)
    if doc.get("mode") != "full":
        raise ValueError(f"{manifest_path}: expected a full-mode manifest")
    d = os.path.dirname(manifest_path) or "."
    return [os.path.join(d, p["file"]) for p in doc["parts"]]


def link_or_copy(src: str, dst: str) -> None:
    """Hard-link src to dst (one filesystem: how a journal-mode snapshot
    holds its base without copying it), or copy it where the link fails
    (across filesystems)."""
    if os.path.exists(dst):
        os.remove(dst)
    try:
        os.link(src, dst)
    except OSError:
        shutil.copyfile(src, dst)
