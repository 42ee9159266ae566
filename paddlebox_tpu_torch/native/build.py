"""Build and load the port's CUDA kernels (``paddlebox_tpu_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` on its own into a shared library with a
plain C interface and loaded with ctypes — seconds per file, against the
minutes a build that includes PyTorch's headers takes. All sources of one
``build_kernels`` call compile in parallel, one ``nvcc`` process each.

Libraries land in ``paddlebox_tpu_torch/native/_build/`` (listed in
.gitignore) under a name that carries a hash of the source and the flags,
so an edited source is rebuilt and an unchanged one is reused. Building
happens at a kernel's first launch, never at import; a failed ``nvcc``
raises with its output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, List, Optional

from paddlebox_tpu_torch.utils.lockwatch import make_lock

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "native", "_build")

# sm_90a keeps Hopper's wgmma/setmaxnreg available to later kernels.
# --fmad=false and no --use_fast_math: IEEE sqrt/div and no contracted
# multiply-adds, so each kernel matches its plain PyTorch version exactly.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

KERNEL_SOURCES = ("push_adagrad", "blocked_write", "scale_copy",
                  "gather_rows")

_lock = make_lock("build._lock")
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc from PATH, else under CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the port's CUDA "
                       "kernels are compiled from csrc/ at first use")


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "%s-%s.so" % (name, digest.hexdigest()[:12]))


def _declare(name: str, lib: ctypes.CDLL) -> None:
    """argtypes/restype of each C entry (pointers and the stream as
    c_void_p so ctypes never truncates them)."""
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    if name == "push_adagrad":
        # one entry for every rule, expand width and slab form; the plan
        # (the bf16 slab's column plan) may be NULL
        fns = {"pbt_push": [p, p, p, p, p, p, i, i, i, i, i, i,
                            ctypes.POINTER(ctypes.c_float),
                            ctypes.POINTER(ctypes.c_int), p]}
    elif name == "blocked_write":
        fns = {"pbt_blocked_write": [p, p, p, p, i, i, i, p],
               "pbt_blocked_write_2byte": [p, p, p, p, i, i, i, p]}
    elif name == "scale_copy":
        fns = {"pbt_scale_copy": [p, p, i64, p]}
    elif name == "gather_rows":
        fns = {"pbt_gather_rows": [p, p, p, i64, i64, i, p],
               "pbt_gather_rows_2byte": [p, p, p, i64, i64, i, p],
               "pbt_gather_rows_decode": [p, p, p, i64, i64, i, i,
                                          ctypes.POINTER(ctypes.c_int), p]}
    else:
        raise ValueError("unknown kernel %r" % name)
    for entry, argtypes in fns.items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


def build_kernels(names: Optional[Iterable[str]] = None,
                  verbose: bool = False) -> Dict[str, str]:
    """Compile the named kernels (default: all) that are not built yet, in
    parallel; returns name -> library path. ``verbose`` adds -Xptxas -v
    (registers, spills) to the compiler output that is printed."""
    names = list(KERNEL_SOURCES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    if not todo:
        return paths
    nvcc = find_nvcc()
    procs: List = []
    for n in todo:
        tmp = "%s.tmp%d" % (paths[n], os.getpid())
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, os.path.join(CSRC_DIR, n + ".cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for n, tmp, proc in procs:
        out, _ = proc.communicate()
        if verbose and out:
            print("[nvcc %s]\n%s" % (n, out.rstrip()), flush=True)
        if proc.returncode != 0:
            failed.append("%s (rc=%d):\n%s" % (n, proc.returncode, out))
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building it first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build_kernels([name])[name]
            lib = ctypes.CDLL(path)
            _declare(name, lib)
            _loaded[name] = lib
        return lib
