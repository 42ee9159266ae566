"""The hash-striped host embedding store: N independent inner stores.

Counterpart of paddlebox_tpu/embedding/striped_store.py. The key space
splits into N stripes by splitmix64(key) mod N (``stripe_of``); each stripe
owns a native store (NativeHostEmbeddingStore) with its own creation rng
(``RandomState(seed + stripe)``) and its own SSD-tier block namespace, and
every bulk call fans out across the stripes on a small thread pool (the
inner C++ calls release the interpreter lock, so stripes overlap on a
multi-core host). Results come back in the caller's key order.

  * Stripes partition the key space, so the fan-out's workers touch
    disjoint state; a per-stripe ``threading.RLock`` is held around each
    inner call all the same.
  * Creation draws come from the stripes' rngs: a striped store's rows of
    new keys differ from the flat store's. The journal is unaffected (its
    ROWS records carry the rows written, replay draws nothing), but
    changing ``PassFlags.host_store_stripes`` mid-history changes what new
    features start from.
  * ``spill(max_resident)`` budgets each stripe (the floor, and one more
    for the first ``max_resident mod N`` stripes), so victims are each
    stripe's coldest rather than the global coldest.

Unlike the reference, an inner store that cannot be made (the host
library does not build) raises: nothing falls back to the Python store.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from paddlebox_tpu_torch.config.configs import TableConfig
from paddlebox_tpu_torch.config.flags import CkptFlags
from paddlebox_tpu_torch.embedding import ckpt_store
from paddlebox_tpu_torch.embedding.accessor import ValueLayout
from paddlebox_tpu_torch.embedding.native_store import \
    NativeHostEmbeddingStore
from paddlebox_tpu_torch.utils.lockwatch import make_rlock


def stripe_of(keys: np.ndarray, n_stripes: int) -> np.ndarray:
    """splitmix64 finalizer mod N — uint64 keys → int64 stripe ids.
    Feasigns are often slot-structured in the high bits; the finalizer
    mixes all 64 bits so stripes stay balanced regardless."""
    z = np.asarray(keys, np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z % np.uint64(n_stripes)).astype(np.int64)


class StripedHostStore:
    """Same public surface as HostEmbeddingStore / the native store;
    every method routes by stripe and reassembles in input order."""

    def __init__(self, layout: ValueLayout, table: TableConfig,
                 seed: int = 0, stripes: int = 4) -> None:
        if stripes < 1:
            raise ValueError(f"stripes must be >= 1, got {stripes}")
        self.layout = layout
        self.table = table
        self.n_stripes = int(stripes)
        self._spill_dir = table.ssd_dir
        self.stores = [NativeHostEmbeddingStore(layout, table, seed + s)
                       for s in range(self.n_stripes)]
        self._locks = [make_rlock("StripedHostStore.stripe%d" % s)
                       for s in range(self.n_stripes)]
        workers = min(self.n_stripes, max(1, (os.cpu_count() or 1)))
        self._pool: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(max_workers=workers,
                               thread_name_prefix="stripe")
            if self.n_stripes > 1 and workers > 1 else None)
        # the creation streams and the random_state of BoxTrainer: the
        # stripes' own, under one name
        self._rng = _StripeRngs(self.stores)

    def close(self) -> None:
        """Shut the fan-out pool down."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def __len__(self) -> int:
        return sum(len(st) for st in self.stores)

    # ------------------------------------------------------------- plumbing
    def _fan(self, fns) -> List:
        """Run one thunk per stripe; parallel when a pool exists. Result
        order == submission order; worker exceptions re-raise here."""
        fns = list(fns)
        if self._pool is None or len(fns) <= 1:
            return [fn() for fn in fns]
        return [f.result() for f in [self._pool.submit(fn) for fn in fns]]

    def _split(self, keys: np.ndarray) -> List[np.ndarray]:
        """Per-stripe positions into `keys` (empty arrays included, so
        zips stay aligned with self.stores)."""
        sid = stripe_of(keys, self.n_stripes)
        order = np.argsort(sid, kind="stable")
        bounds = np.searchsorted(sid[order], np.arange(self.n_stripes + 1))
        return [order[bounds[s]:bounds[s + 1]]
                for s in range(self.n_stripes)]

    def _keyed(self, keys: np.ndarray, call):
        """Fan `call(store, lock, sub_keys, positions)` across stripes
        with non-empty key subsets; returns the per-stripe results."""
        parts = self._split(keys)

        def thunk(s, pos):
            with self._locks[s]:
                return call(self.stores[s], keys[pos], pos)
        return self._fan(
            (lambda s=s, pos=pos: thunk(s, pos))
            for s, pos in enumerate(parts) if pos.size)

    # ------------------------------------------------------------------ api
    def lookup_or_create(self, keys: np.ndarray) -> np.ndarray:
        keys = np.ascontiguousarray(keys, np.uint64)
        out = np.empty((keys.size, self.layout.width), np.float32)

        def call(st, sub, pos):
            out[pos] = st.lookup_or_create(sub)
        self._keyed(keys, call)
        return out

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        keys = np.ascontiguousarray(keys, np.uint64)
        out = np.zeros((keys.size, self.layout.width), np.float32)

        def call(st, sub, pos):
            out[pos] = st.lookup(sub)
        self._keyed(keys, call)
        return out

    def lookup_present(self, keys: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        keys = np.ascontiguousarray(keys, np.uint64)
        out = np.zeros((keys.size, self.layout.width), np.float32)
        found = np.zeros(keys.size, bool)

        def call(st, sub, pos):
            vals, hit = st.lookup_present(sub)
            out[pos] = vals
            found[pos] = hit
        self._keyed(keys, call)
        return out, found

    def write_back(self, keys: np.ndarray, values: np.ndarray) -> None:
        keys = np.ascontiguousarray(keys, np.uint64)
        values = np.ascontiguousarray(values, np.float32)

        def call(st, sub, pos):
            st.write_back(sub, values[pos])
        self._keyed(keys, call)

    def assign(self, keys: np.ndarray, values: np.ndarray) -> None:
        keys = np.ascontiguousarray(keys, np.uint64)
        values = np.ascontiguousarray(values, np.float32)

        def call(st, sub, pos):
            st.assign(sub, values[pos])
        self._keyed(keys, call)

    # ------------------------------------------------------------ lifecycle
    def shrink(self) -> int:
        return sum(self._fan(
            (lambda s=s: self._with_lock(s, "shrink"))
            for s in range(self.n_stripes)))

    def _with_lock(self, s: int, meth: str, *args):
        with self._locks[s]:
            return getattr(self.stores[s], meth)(*args)

    def age_unseen_days(self) -> None:
        self._fan((lambda s=s: self._with_lock(s, "age_unseen_days"))
                  for s in range(self.n_stripes))

    def tick_spill_age(self) -> None:
        self._fan((lambda s=s: self._with_lock(s, "tick_spill_age"))
                  for s in range(self.n_stripes))

    # ----------------------------------------------------------- SSD tier
    def set_journal_sink(self, sink) -> None:
        """One shared sink: per-stripe MOVE records interleave across
        stripes, which replay tolerates — stripes are disjoint key sets,
        and the flat scratch store replays each record independently."""
        for s in range(self.n_stripes):
            self._with_lock(s, "set_journal_sink", sink)

    def spill(self, max_resident: int) -> int:
        if not self._spill_dir:
            return 0
        base, rem = divmod(int(max_resident), self.n_stripes)
        return sum(self._fan(
            (lambda s=s: self._with_lock(
                s, "spill", base + (1 if s < rem else 0)))
            for s in range(self.n_stripes)))

    def spill_exact(self, keys: np.ndarray) -> int:
        keys = np.ascontiguousarray(keys, np.uint64)
        return sum(self._keyed(
            keys, lambda st, sub, pos: st.spill_exact(sub)))

    def fault_in_keys(self, keys: np.ndarray) -> int:
        keys = np.ascontiguousarray(keys, np.uint64)
        return sum(self._keyed(
            keys, lambda st, sub, pos: st.fault_in_keys(sub)))

    def rebase_spill_ages(self) -> None:
        self._fan((lambda s=s: self._with_lock(s, "rebase_spill_ages"))
                  for s in range(self.n_stripes))

    def load_spilled(self) -> int:
        return sum(self._fan(
            (lambda s=s: self._with_lock(s, "load_spilled"))
            for s in range(self.n_stripes)))

    # ---------------------------------------------------------- checkpoint
    def state_items(self) -> Tuple[np.ndarray, np.ndarray]:
        got = self._fan((lambda s=s: self._with_lock(s, "state_items"))
                        for s in range(self.n_stripes))
        return (np.concatenate([k for k, _ in got]),
                np.vstack([v for _, v in got]))

    def spilled_snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        got = self._fan((lambda s=s: self._with_lock(s, "spilled_snapshot"))
                        for s in range(self.n_stripes))
        return (np.concatenate([k for k, _ in got]),
                np.vstack([v for _, v in got]))

    def spilled_keys(self) -> np.ndarray:
        return np.concatenate(self._fan(
            (lambda s=s: self._with_lock(s, "spilled_keys"))
            for s in range(self.n_stripes)))

    def spilled_count(self) -> int:
        return sum(self._with_lock(s, "spilled_count")
                   for s in range(self.n_stripes))

    def update_stat_after_save(self, table: TableConfig, param: int
                               ) -> None:
        self._fan((lambda s=s: self._with_lock(
            s, "update_stat_after_save", table, param))
            for s in range(self.n_stripes))

    def save(self, path: str, flags: Optional[CkptFlags] = None) -> None:
        """Checkpoint resident AND tier rows of every stripe into ONE
        artifact — a striped store's checkpoint loads into a flat store
        and vice versa (the stripe split is an in-memory routing choice,
        never a persisted format)."""
        flags = flags or CkptFlags()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        keys, values = self.state_items()
        skeys, svals = self.spilled_snapshot()
        if skeys.size:
            keys = np.concatenate([keys, skeys])
            values = np.vstack([values, svals])
        ckpt_store.save_sparse_auto(
            path, keys, values, {"embedx_dim": self.layout.embedx_dim,
                                 "optimizer": self.layout.optimizer},
            fmt=flags.ckpt_format, parts=flags.ckpt_parts,
            threads=flags.ckpt_io_threads)

    def load(self, path: str, threads: int = 0) -> None:
        self.load_blob(ckpt_store.load_sparse_any(path, threads))

    def load_blob(self, blob: Dict) -> None:
        """Split one flat blob by stripe and load each slice — each
        inner load_blob resets its own index, tier and arena."""
        if blob["embedx_dim"] != self.layout.embedx_dim or \
                blob["optimizer"] != self.layout.optimizer:
            raise ValueError("checkpoint layout mismatch")
        keys = np.ascontiguousarray(blob["keys"], np.uint64)
        values = np.ascontiguousarray(blob["values"], np.float32)
        parts = self._split(keys)

        def thunk(s, pos):
            with self._locks[s]:
                self.stores[s].load_blob(
                    {"embedx_dim": blob["embedx_dim"],
                     "optimizer": blob["optimizer"],
                     "keys": keys[pos], "values": values[pos]})
        self._fan((lambda s=s, pos=pos: thunk(s, pos))
                  for s, pos in enumerate(parts))


class _StripeRngs:
    """The stripes' creation RandomStates as one: get_state / set_state
    (what BoxTrainer.random_state saves) take a tuple of theirs."""

    def __init__(self, stores: List) -> None:
        self._stores = stores

    def get_state(self):
        return tuple(st._rng.get_state() for st in self._stores)

    def set_state(self, state) -> None:
        for st, s in zip(self._stores, state, strict=True):
            st._rng.set_state(s)
