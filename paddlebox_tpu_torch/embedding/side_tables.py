"""Side tables whose rows every step reads whole: the replica cache and the
input table.

Counterpart of paddlebox_tpu/embedding/side_tables.py:24-123 (the
reference's GpuReplicaCache and InputTable, box_wrapper.h:62-180). The feed
appends rows on the host (numpy f32); ``to_device(capacity, device)``
freezes them into one [rows, dim] tensor on the caller's device,
zero-padded to ``capacity`` rows so that a consumer (models/aux_input.py
CtrDnnAux, whose ``aux_rows`` the trainer refreshes every pass) keeps one
shape while the table grows. A table holding more rows than ``capacity``
raises.

ReplicaCache  rows by the index ``add_items`` returned (a record's
              ``cache_idx``); row 0 is a real row.
InputTable    string key -> row; row 0 is the zero row, the row of every
              key it does not hold (``miss`` counts those lookups).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from paddlebox_tpu_torch.device import DeviceLike, resolve_device


def _frozen(host: np.ndarray, dim: int, capacity: Optional[int],
            what: str, device: DeviceLike) -> torch.Tensor:
    if capacity is not None:
        if host.shape[0] > capacity:
            raise ValueError("%s holds %d rows > capacity %d"
                             % (what, host.shape[0], capacity))
        host = np.vstack([host, np.zeros((capacity - host.shape[0], dim),
                                         np.float32)])
    return torch.from_numpy(host).to(resolve_device(device))


def _row(vec, dim: int) -> np.ndarray:
    vec = np.asarray(vec, np.float32).reshape(-1)
    if vec.size != dim:
        raise ValueError("expected dim %d, got %d" % (dim, vec.size))
    return vec


class ReplicaCache:
    """Rows appended on the host during the feed, frozen for the pass."""

    def __init__(self, dim: int) -> None:
        self.dim = dim
        self._rows: List[np.ndarray] = []
        self._lock = threading.Lock()

    def add_items(self, emb) -> int:
        """Append one row; returns its index."""
        emb = _row(emb, self.dim)
        with self._lock:
            self._rows.append(emb)
            return len(self._rows) - 1

    def __len__(self) -> int:
        return len(self._rows)

    def host_rows(self) -> np.ndarray:
        """[n, dim] float32 (one zero row while the cache is empty)."""
        with self._lock:
            return (np.stack(self._rows) if self._rows
                    else np.zeros((1, self.dim), np.float32))

    def to_device(self, capacity: Optional[int] = None,
                  device: DeviceLike = None) -> torch.Tensor:
        """The rows as a tensor on ``device``, zero-padded to
        ``capacity`` rows when given."""
        return _frozen(self.host_rows(), self.dim, capacity,
                       "replica cache", device)


class InputTable:
    """String key -> aux row; keys it does not hold map to the zero row
    at offset 0."""

    def __init__(self, dim: int) -> None:
        self.dim = dim
        self._offsets: Dict[str, int] = {}
        self._rows: List[np.ndarray] = []
        self._lock = threading.Lock()
        self.miss = 0
        self.add_index_data("-", np.zeros(dim, np.float32))

    def add_index_data(self, key: str, vec) -> None:
        vec = _row(vec, self.dim)
        with self._lock:
            self._offsets[key] = len(self._rows)
            self._rows.append(vec)

    def get_index_offset(self, key: str) -> int:
        """The key's row, or 0 (counted in ``miss``) for a key the table
        does not hold."""
        off = self._offsets.get(key)
        if off is None:
            with self._lock:
                self.miss += 1
            return 0
        return off

    def __contains__(self, key: str) -> bool:
        return key in self._offsets

    def size(self) -> int:
        return len(self._rows)

    def host_rows(self) -> np.ndarray:
        """[size, dim] float32, the zero row first."""
        with self._lock:
            return np.stack(self._rows)

    def to_device(self, capacity: Optional[int] = None,
                  device: DeviceLike = None) -> torch.Tensor:
        """As ReplicaCache.to_device."""
        return _frozen(self.host_rows(), self.dim, capacity, "input table",
                       device)
