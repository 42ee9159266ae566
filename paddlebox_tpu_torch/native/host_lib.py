"""Build and load the port's native host library: the slot parser, the host
store, the route index, the sharded table's batch router and the uid wire's
sorted dedup (``paddlebox_tpu_torch/native/*.cc``).

Counterpart of paddlebox_tpu/native/build.py. The three sources compile
with ``g++ -O3 -shared -fPIC -std=c++17`` into one shared library in
``paddlebox_tpu_torch/native/_build/`` (listed in .gitignore) under a name
that carries a hash of the sources, the compiler and its flags, so an
edited source is rebuilt and an unchanged one is reused. The build runs at
the library's first use, never at import; it writes a per-process
temporary file and renames it into place, so processes that build at once
do not clobber each other.

Unlike the reference, a failed build raises with the compiler's output:
nothing falls back to the Python tier. That tier runs only where a caller
asks for it by name (``BoxDataset(columnar=False)``,
``PassTable(store=HostEmbeddingStore(...))``).

ctypes releases the interpreter lock for the length of each call, so a
parse or a store call on one thread lets Python run on the others.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

from paddlebox_tpu_torch.native.build import BUILD_DIR
from paddlebox_tpu_torch.utils.lockwatch import make_lock

SRC_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("slot_parser.cc", "host_store.cc", "route.cc")
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = make_lock("host_lib._lock")
_lib: Optional[ctypes.CDLL] = None

U8P = ctypes.POINTER(ctypes.c_uint8)
I32P = ctypes.POINTER(ctypes.c_int32)
I64P = ctypes.POINTER(ctypes.c_int64)
U64P = ctypes.POINTER(ctypes.c_uint64)
F32P = ctypes.POINTER(ctypes.c_float)


def lib_path(build_dir: Optional[str] = None) -> str:
    """Where the library of the current sources, built by CXX, lives in
    ``build_dir`` (default BUILD_DIR)."""
    digest = hashlib.sha256(" ".join((CXX,) + CXX_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(SRC_DIR, name), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR if build_dir is None else build_dir,
                        "libpbt_host-%s.so" % digest.hexdigest()[:12])


def build_host_lib(build_dir: Optional[str] = None) -> str:
    """Compile the sources with CXX unless their library exists; returns
    its path. Raises RuntimeError with the compiler's output when the
    compiler fails."""
    path = lib_path(build_dir)
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = "%s.tmp%d" % (path, os.getpid())
    cmd = [CXX, *CXX_FLAGS, "-o", tmp,
           *(os.path.join(SRC_DIR, s) for s in SOURCES)]
    try:
        out = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             timeout=600)
    except OSError as e:
        raise RuntimeError("the host library's compiler %r did not run: %s"
                           % (CXX, e)) from e
    if out.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError("building the host library failed (%s, rc=%d):\n"
                           "%s" % (" ".join(cmd), out.returncode, out.stdout))
    os.replace(tmp, path)
    return path


def bind_parser(lib: ctypes.CDLL) -> ctypes.CDLL:
    """argtypes/restype of the slot parser's entries (psr_*): all a
    parser plugin's library must export (data/plugin.py)."""
    c = ctypes
    p = c.c_void_p
    lib.psr_parse_file2.restype = p
    lib.psr_parse_file2.argtypes = [c.c_char_p, I32P, I32P, I32P,
                                    c.c_int32, c.c_int32, I32P, c.c_int32]
    for name, res in (("psr_n_keys", c.c_int64), ("psr_n_recs", c.c_int64),
                      ("psr_n_bad", c.c_int64), ("psr_keys", U64P),
                      ("psr_key_slot", I32P), ("psr_key_rec", I64P),
                      ("psr_labels", I32P), ("psr_dense_dim", c.c_int32),
                      ("psr_dense", F32P), ("psr_task_labels", I32P)):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = [p]
    lib.psr_free.restype = None
    lib.psr_free.argtypes = [p]
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """argtypes/restype of every entry the port calls."""
    c = ctypes
    p = c.c_void_p
    bind_parser(lib)
    lib.hs_create.restype = p
    lib.hs_create.argtypes = [c.c_int32, c.c_double]
    lib.hs_destroy.restype = None
    lib.hs_destroy.argtypes = [p]
    lib.hs_size.restype = c.c_uint64
    lib.hs_size.argtypes = [p]
    lib.hs_lookup.restype = None
    lib.hs_lookup.argtypes = [p, U64P, c.c_int64, I64P]
    lib.hs_lookup_or_create.restype = None
    lib.hs_lookup_or_create.argtypes = [p, U64P, c.c_int64, I64P, U8P]
    lib.hs_gather.restype = None
    lib.hs_gather.argtypes = [p, I64P, c.c_int64, F32P]
    lib.hs_scatter.restype = None
    lib.hs_scatter.argtypes = [p, I64P, c.c_int64, F32P]
    lib.hs_items.restype = c.c_int64
    lib.hs_items.argtypes = [p, U64P, I64P]
    lib.hs_lookup_gather.restype = c.c_int64
    lib.hs_lookup_gather.argtypes = [p, U64P, c.c_int64, F32P, U8P]
    lib.hs_erase.restype = c.c_int64
    lib.hs_erase.argtypes = [p, U64P, c.c_int64]
    lib.hs_add_col.restype = c.c_int64
    lib.hs_add_col.argtypes = [p, c.c_int32, c.c_float]
    lib.hs_coldest.restype = c.c_int64
    lib.hs_coldest.argtypes = [p, c.c_int64, c.c_int32, U64P, I64P]

    lib.rt_index_create.restype = p
    lib.rt_index_create.argtypes = [U64P, I64P, c.c_int32]
    lib.rt_index_destroy.restype = None
    lib.rt_index_destroy.argtypes = [p]
    lib.rt_lookup.restype = c.c_int64
    lib.rt_lookup.argtypes = [p, U64P, U8P, c.c_int64, c.c_int32, I32P,
                              U64P]
    lib.rt_lookup_serve.restype = c.c_int64
    lib.rt_lookup_serve.argtypes = [p, U64P, c.c_int64, c.c_int32, I32P]
    lib.rt_bucketize.restype = c.c_int64
    lib.rt_bucketize.argtypes = [p, U64P, U8P, c.c_int64, c.c_int32,
                                 c.c_int32, I32P, I32P, U64P]
    lib.rt_bucketize_sharded.restype = c.c_int64
    lib.rt_bucketize_sharded.argtypes = [p, U64P, I32P, U8P, c.c_int64,
                                         c.c_int32, c.c_int32, I32P, I32P,
                                         U64P]
    lib.rt_dedup_sorted.restype = c.c_int64
    lib.rt_dedup_sorted.argtypes = [I32P, c.c_int64, c.c_int32, I32P, I64P]
    return lib


def host_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed. Raises RuntimeError
    when the build fails (and again on the next call: nothing is
    cached)."""
    global _lib
    lib = _lib
    if lib is None:
        with _lock:
            if _lib is None:
                _lib = _bind(ctypes.CDLL(build_host_lib()))
            lib = _lib
    return lib


def ptr(a: np.ndarray, ptr_t):
    """ctypes pointer of a C-contiguous array; the caller keeps ``a``
    alive for the call."""
    return a.ctypes.data_as(ptr_t)


# ------------------------------------------------------------ route index

def create_route_index(sorted_keys) -> int:
    """A native key -> pass-local id hash index (rt_index_create; the
    index copies the keys) over one pass's sorted unique keys, or over a
    list of shards' sorted unique key arrays (the sharded table's global
    routing). Id i is the key's position in its array. Free it with
    destroy_route_index."""
    shards = ([sorted_keys] if isinstance(sorted_keys, np.ndarray)
              else list(sorted_keys))
    keys = np.ascontiguousarray(
        np.concatenate(shards) if shards else np.empty(0), dtype=np.uint64)
    if max((s.size for s in shards), default=0) > 2**31 - 1:
        raise ValueError("route index: a shard of %d keys overflows its "
                         "int32 ids" % max(s.size for s in shards))
    off = np.concatenate([[0], np.cumsum([s.size for s in shards])]
                         ).astype(np.int64)
    handle = host_lib().rt_index_create(ptr(keys, U64P), ptr(off, I64P),
                                        len(shards))
    if not handle:
        raise MemoryError("rt_index_create could not allocate an index of "
                          "%d keys" % keys.size)
    return handle


def destroy_route_index(handle: Optional[int]) -> None:
    if handle:
        host_lib().rt_index_destroy(handle)


def route_lookup(handle: int, keys: np.ndarray,
                 valid: Optional[np.ndarray], padding_id: int) -> np.ndarray:
    """int32 ids of ``keys`` (rt_lookup); positions where ``valid`` is
    False map to ``padding_id``. Raises KeyError for a valid key the index
    does not hold."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    v = (None if valid is None
         else np.ascontiguousarray(valid, dtype=bool).view(np.uint8))
    if v is not None and v.shape != keys.shape:
        raise ValueError("valid has shape %s, keys %s"
                         % (v.shape, keys.shape))
    out = np.empty(keys.size, np.int32)
    missing = np.zeros(1, np.uint64)
    rc = host_lib().rt_lookup(
        handle, ptr(keys, U64P), None if v is None else ptr(v, U8P),
        keys.size, padding_id, ptr(out, I32P), ptr(missing, U64P))
    if rc == -1:
        raise KeyError("key not registered in feed pass: %d"
                       % int(missing[0]))
    return out


def route_lookup_serve(handle: int, keys: np.ndarray,
                       miss_id: int) -> np.ndarray:
    """int32 ids of ``keys`` (rt_lookup_serve), ``miss_id`` for a key the
    index does not hold."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    out = np.empty(keys.size, np.int32)
    host_lib().rt_lookup_serve(handle, ptr(keys, U64P), keys.size, miss_id,
                               ptr(out, I32P))
    return out


def bucketize(handle: int, keys: np.ndarray, valid: np.ndarray,
              num_shards: int, bucket_cap: int, trash_id: int,
              shard: Optional[np.ndarray] = None):
    """Route one batch over a sharded route index (rt_bucketize: shard =
    key % num_shards; with ``shard``, the per-key owner array,
    rt_bucketize_sharded): (buckets [num_shards, bucket_cap] int32 local
    ids in first-occurrence order, padding ``trash_id``; restore [K]
    int32 bucket slot of each valid key position, 0 elsewhere; overflow,
    the valid occurrences dropped because their shard's bucket was full).
    ``valid`` (contiguous bool) loses the dropped occurrences IN PLACE.
    Raises KeyError for a kept key the index does not hold, ValueError
    for a shard outside [0, num_shards)."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    if valid.dtype != np.bool_ or not valid.flags.c_contiguous \
            or valid.shape != keys.shape:
        raise TypeError("valid must be a contiguous bool array of the keys' "
                        "shape")
    buckets = np.full((num_shards, bucket_cap), trash_id, np.int32)
    restore = np.zeros(keys.size, np.int32)
    missing = np.zeros(1, np.uint64)
    v = valid.view(np.uint8)
    lib = host_lib()
    if shard is None:
        rc = lib.rt_bucketize(handle, ptr(keys, U64P), ptr(v, U8P),
                              keys.size, num_shards, bucket_cap,
                              ptr(buckets, I32P), ptr(restore, I32P),
                              ptr(missing, U64P))
    else:
        sh = np.ascontiguousarray(shard, dtype=np.int32)
        rc = lib.rt_bucketize_sharded(handle, ptr(keys, U64P), ptr(sh, I32P),
                                      ptr(v, U8P), keys.size, num_shards,
                                      bucket_cap, ptr(buckets, I32P),
                                      ptr(restore, I32P), ptr(missing, U64P))
    if rc == -1:
        raise KeyError("key %d not registered in feed pass" % int(missing[0]))
    if rc == -3:
        raise ValueError("shard out of range [0, %d) for key %d"
                         % (num_shards, int(missing[0])))
    if rc < 0:
        raise MemoryError("rt_bucketize could not allocate its scratch")
    return buckets, restore, int(rc)


# ------------------------------------------------------------ uid dedup

def dedup_sorted(ids: np.ndarray, pad_base: int) -> Optional[np.ndarray]:
    """[K] int32 sorted unique ids of ``ids`` (int32, contiguous), the
    tail padded with pad_base + i (rt_dedup_sorted: a presence mark over
    the occurrences, then a radix sort of the uniques), or None where the
    kernel declines (-1): an id outside [0, pad_base), or a live id span
    (the trash id pad_base - 1 aside) above K / 2. Raises MemoryError
    where its scratch could not be allocated."""
    K = ids.shape[0]
    out = np.empty(K, np.int32)
    scratch = np.empty(K, np.int64)
    n_u = host_lib().rt_dedup_sorted(ptr(ids, I32P), K, pad_base,
                                     ptr(out, I32P), ptr(scratch, I64P))
    if n_u == -1:
        return None
    if n_u < 0:
        raise MemoryError("rt_dedup_sorted could not allocate its presence "
                          "table for %d ids" % K)
    return out
