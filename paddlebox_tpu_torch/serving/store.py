"""The xbox serving view's file format and how its views are found.

The port's copy of the parts of paddlebox_tpu/serving/store.py that the
checkpoint plane writes and XboxModelReader reads (:56-92, :184-226,
:255-299): the columnar view file (magic PBTXBOX1, ``view.xcol``), the read
of one view directory in either format, and the one precedence rule over a
day's views. The serving plane itself (mmap stores, precedence stacks, the
fleet) is not ported: it reads what the port writes as it is.
"""

from __future__ import annotations

import glob
import os
import re
import threading
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

from paddlebox_tpu_torch.embedding.ckpt_store import safe_load

XBOX_MAGIC = b"PBTXBOX1"

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
