"""Two-tier, pass-cadenced checkpoints, and the day that writes them.

Counterpart of paddlebox_tpu/train/checkpoint.py (CheckpointManager
:71-510 in full mode, run_day :518-564, read_batch_sparse :567-581,
XboxModelReader :639-717). SaveBase/SaveDelta semantics
(box_wrapper.cc:1286-1318): a **batch model** is the whole training state
(the sparse store with its optimizer columns, the dense parameters and the
dense Adam state), for resume; an **xbox model** is the serving view (per
key: embed_w and embedx). save_delta writes the features whose delta score
crossed delta_threshold since the last save and then clears those scores
(UpdateStatAfterSave param 1); save_base writes everything and also ages
every row (param 3). Both rewrite store rows outside the pass cadence, so
both drop the table's residency.

A day directory holds, for day ``d``:

  <batch_model_dir>/d/sparse.xman, sparse.xman.p0000..  the columnar sparse
        tier (embedding/ckpt_store.py), or sparse.pkl (ckpt_format pickle)
  <batch_model_dir>/d/dense.pkl   {"params", "opt_state", "extra", "flags"}
        of numpy arrays, Python scalars and dicts (convert.py's names)
  <xbox_model_dir>/d/view.xcol            the base view, all features
  <xbox_model_dir>/d/delta-<i>/view.xcol  each delta view
  DONE in each directory, written last (its content a time stamp)

which the JAX package's loaders and ``serving/`` read as they read their
own. The touched-row journal (save_base mode 'touched', ckpt_journal) and
merge_models are not ported: 'touched' and 'auto' fall back to a full save
with a warning, as the reference does without a journal.

Snapshots and the stat rewrite run on the caller's thread; only the file
writes go to a writer thread (async_save). ``wait`` joins every writer and
raises the first error a writer met. ``seconds`` adds up host-clock
seconds: save_base and save_delta (the caller's part), their writers, and
load_base.
"""

from __future__ import annotations

import logging
import os
import pickle
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from paddlebox_tpu_torch.config.configs import CheckpointConfig
from paddlebox_tpu_torch.config.flags import CkptFlags
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.embedding import ckpt_store as cks
from paddlebox_tpu_torch.serving.store import (VIEW_COLUMNAR_NAME,
                                               discover_xbox_sources,
                                               read_xbox_view,
                                               write_xbox_columnar)
from paddlebox_tpu_torch.train.preload import run_preloaded_passes

log = logging.getLogger(__name__)

#: the batch directory's sparse tier (columnar manifest, legacy pickle)
SPARSE_MANIFEST = "sparse.xman"
SPARSE_PICKLE = "sparse.pkl"
SECONDS = ("save_base", "save_base_writer", "save_delta",
           "save_delta_writer", "load_base")
# leaves dense.pkl may hold, besides dicts, lists and tuples of them
_PLAIN = (np.ndarray, np.generic, int, float, bool, str, type(None))


def _write_done(dirpath: str) -> None:
    """The DONE marker, atomically (tmp + rename): a reader that sees DONE
    never sees it empty; its content is the time stamp view ordering
    breaks ties with."""
    tmp = os.path.join(dirpath, f".DONE.{os.getpid()}.tmp")
    with open(tmp, "w") as f:
        f.write(str(time.time()))
    os.replace(tmp, os.path.join(dirpath, "DONE"))


def _check_plain(obj, where: str) -> None:
    """Raise TypeError unless ``obj`` is numpy arrays and Python scalars in
    dicts, lists and tuples: what the JAX package unpickles without
    torch."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            _check_plain(v, "%s[%r]" % (where, k))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _check_plain(v, "%s[%d]" % (where, i))
    elif not isinstance(obj, _PLAIN):
        raise TypeError("dense.pkl takes numpy arrays and Python scalars; "
                        "%s is a %s" % (where, type(obj).__name__))


class CheckpointManager:
    """Batch and xbox saves of one PassTable's store."""

    def __init__(self, cfg: CheckpointConfig, table,
                 flags: Optional[CkptFlags] = None) -> None:
        self.cfg = cfg
        self.table = table
        self.store = table.store
        self.flags = flags or CkptFlags()
        self._writers: List[threading.Thread] = []
        self._errors: List[BaseException] = []
        self._writers_lock = threading.Lock()
        self.seconds: Dict[str, float] = dict.fromkeys(SECONDS, 0.0)

    # --------------------------------------------------------- async writers
    def _add_seconds(self, name: str, t0: float) -> None:
        with self._writers_lock:
            self.seconds[name] += time.perf_counter() - t0

    def _spawn_writer(self, fn, name: str) -> None:
        """Run ``fn`` (the file writes of one save) on a writer thread, or
        here without async_save; its host-clock seconds go to
        ``seconds[name]``."""
        def run() -> None:
            t0 = time.perf_counter()
            fn()
            self._add_seconds(name, t0)

        if not self.cfg.async_save:
            run()
            return

        def guarded() -> None:
            try:
                run()
            except BaseException as e:  # raised again by wait()
                with self._writers_lock:
                    self._errors.append(e)

        t = threading.Thread(target=guarded, daemon=True, name="ckpt-writer")
        with self._writers_lock:
            self._writers.append(t)
        t.start()

    def wait(self) -> None:
        """Join every outstanding writer; then raise the first error a
        writer met since the last wait."""
        while True:
            with self._writers_lock:
                if not self._writers:
                    break
                t = self._writers.pop()
            t.join()
        with self._writers_lock:
            errors, self._errors = self._errors, []
        if errors:
            raise errors[0]

    # ------------------------------------------------------------ batch tier
    def _meta(self) -> Dict:
        return {"embedx_dim": self.table.layout.embedx_dim,
                "optimizer": self.table.layout.optimizer}

    def _stat_after_save(self, base: bool) -> None:
        """The post-save stat rewrite, in place on the store: clear the
        covered delta scores, and on a base save age every row; then drop
        the residency, which the rewrite made stale."""
        with self.table.store_lock:
            self.store.update_stat_after_save(self.table.config, 1)
            if base:
                self.store.update_stat_after_save(self.table.config, 3)
        self._invalidate_residency()

    def _plan_sparse(self, batch_dir: str, n_rows: int
                     ) -> Tuple[str, Optional[int]]:
        """(sparse path, part count, None for the legacy pickle)."""
        if self.flags.ckpt_format == "pickle":
            return os.path.join(batch_dir, SPARSE_PICKLE), None
        return (os.path.join(batch_dir, SPARSE_MANIFEST),
                cks.default_parts(n_rows, self.flags.ckpt_parts))

    def save_base(self, params: Any, opt_state: Any, day: str,
                  extra: Optional[Dict] = None,
                  mode: str = "full") -> Tuple[str, Optional[str]]:
        """Base save of ``day`` -> (batch_dir, xbox_dir): the sparse tier,
        dense.pkl (``params``, ``opt_state`` and ``extra``, numpy arrays and
        Python scalars in dicts) and the xbox base view. The store snapshot
        and the stat rewrite happen here; the files are written by a writer
        thread. mode 'touched' and 'auto' need the touched-row journal,
        which the port does not have: both save in full, with a
        warning."""
        self.wait()
        if mode in ("touched", "auto"):
            log.warning("save_base(mode=%r) falling back to FULL: no "
                        "touched-row journal (ckpt_journal is not ported)",
                        mode)
            mode = "full"
        if mode != "full":
            raise ValueError(f"save_base mode {mode!r} not in "
                             "('full', 'touched', 'auto')")
        dense = {"params": params, "opt_state": opt_state,
                 "extra": extra or {},
                 # the port's Adam state is per parameter, not optax.flatten's
                 # one vector
                 "flags": {"flatten_dense_opt": False}}
        _check_plain(dense, "dense")
        t0 = time.perf_counter()
        batch_dir = os.path.join(self.cfg.batch_model_dir, day)
        xbox_dir = os.path.join(self.cfg.xbox_model_dir, day)
        os.makedirs(batch_dir, exist_ok=True)
        os.makedirs(xbox_dir, exist_ok=True)
        with self.table.store_lock:
            keys, values = self.store.state_items()  # a copy
        xbox_blob = self._xbox_view(keys, values, base=True)
        sparse_path, n_parts = self._plan_sparse(batch_dir, int(keys.size))
        meta = self._meta()
        self._stat_after_save(base=True)
        flags = self.flags

        def do_save() -> None:
            if n_parts is None:
                cks.save_sparse_auto(sparse_path, keys, values, meta,
                                     fmt="pickle")
            else:
                cks.write_sparse_columnar(sparse_path, keys, values, meta,
                                          parts=n_parts,
                                          threads=flags.ckpt_io_threads)
            with open(os.path.join(batch_dir, "dense.pkl"), "wb") as f:
                pickle.dump(dense, f)
            self._write_xbox(xbox_dir, xbox_blob)
            _write_done(batch_dir)

        self._add_seconds("save_base", t0)
        self._spawn_writer(do_save, "save_base_writer")
        return batch_dir, xbox_dir

    def save_delta(self, day: str, delta_id: int) -> str:
        """Delta save of the features whose delta score reached
        delta_threshold (SaveDelta, box_wrapper.cc:1309) as xbox view
        ``delta-<delta_id>`` of ``day``; then their scores are cleared.
        Returns the view's directory."""
        self.wait()
        t0 = time.perf_counter()
        xbox_dir = os.path.join(self.cfg.xbox_model_dir, day,
                                f"delta-{delta_id}")
        os.makedirs(xbox_dir, exist_ok=True)
        with self.table.store_lock:
            keys, values = self.store.state_items()
        blob = self._xbox_view(keys, values, base=False)
        self._stat_after_save(base=False)
        self._add_seconds("save_delta", t0)
        self._spawn_writer(lambda: self._write_xbox(xbox_dir, blob),
                           "save_delta_writer")
        return xbox_dir

    def _invalidate_residency(self) -> None:
        """A stat rewrite or a load changed store rows outside the pass
        cadence: the table's resident slab no longer mirrors them."""
        self.table.invalidate_residency()

    def _xbox_view(self, keys: np.ndarray, values: np.ndarray,
                   base: bool) -> Dict:
        """The serving view: key -> [embed_w, embedx...] of every feature
        (base) or of those whose delta score reached delta_threshold."""
        layout = self.table.layout
        if keys.size:
            if base:
                keep = np.ones(keys.size, bool)
            else:
                keep = (values[:, acc.DELTA_SCORE]
                        >= self.table.config.delta_threshold)
            D = layout.embedx_dim
            vals = values[keep]
            emb = np.concatenate([
                vals[:, acc.EMBED_W:acc.EMBED_W + 1],
                vals[:, layout.embedx_w:layout.embedx_w + D]], axis=1)
            keys_out = keys[keep]
        else:
            keys_out = keys
            emb = np.empty((0, 1 + layout.embedx_dim), np.float32)
        return {"keys": keys_out, "embedding": emb}

    def _write_xbox(self, xbox_dir: str, blob: Dict) -> None:
        """Land one xbox view: the serving columnar file with sorted keys
        (ckpt_xbox_columnar), or the legacy embedding.pkl; then DONE."""
        if self.flags.ckpt_xbox_columnar:
            keys = np.asarray(blob["keys"], np.uint64).ravel()
            rows = np.asarray(blob["embedding"], np.float32)
            order = np.argsort(keys, kind="stable")
            keys = keys[order]
            if keys.size > 1 and not (keys[1:] > keys[:-1]).all():
                raise ValueError(f"{xbox_dir}: duplicate keys in one view")
            write_xbox_columnar(os.path.join(xbox_dir, VIEW_COLUMNAR_NAME),
                                keys, rows[order])
        else:
            with open(os.path.join(xbox_dir, "embedding.pkl"), "wb") as f:
                pickle.dump(blob, f)
        _write_done(xbox_dir)

    # ---------------------------------------------------------------- resume
    def load_base(self, day: str) -> Tuple[Any, Any, Dict]:
        """Resume from the batch model of ``day`` (a columnar manifest or a
        legacy sparse.pkl, whichever the completed directory holds):
        replaces the store's rows and returns (params, opt_state, extra) of
        dense.pkl. dense.pkl is read before the store is touched, through
        a restricted unpickler: a file holding anything but numpy arrays
        and builtin containers (a JAX-written one holds jax arrays) raises
        pickle.UnpicklingError and leaves the store as it was."""
        self.wait()
        t0 = time.perf_counter()
        batch_dir = os.path.join(self.cfg.batch_model_dir, day)
        if not os.path.exists(os.path.join(batch_dir, "DONE")):
            raise FileNotFoundError(f"no completed checkpoint at {batch_dir}")
        with open(os.path.join(batch_dir, "dense.pkl"), "rb") as f:
            blob = cks.safe_load(f)
        man = os.path.join(batch_dir, SPARSE_MANIFEST)
        if os.path.exists(man):
            if cks.read_manifest(man).get("mode") == "journal":
                raise NotImplementedError(
                    f"{batch_dir}: a journal-over-base snapshot; the port "
                    "has no touched-row journal to replay")
            path = man
        else:
            path = os.path.join(batch_dir, SPARSE_PICKLE)
        self.table.load(path, self.flags.ckpt_io_threads)
        self._add_seconds("load_base", t0)
        return blob["params"], blob["opt_state"], blob["extra"]


def run_day(trainer, datasets, cm: CheckpointManager, day: str,
            preload: bool = True):
    """One training day: per pass train, then a delta save every
    ``cm.cfg.save_delta_every_passes`` passes; at the day's end the base
    save and ``end_day(age=False)`` (save_base already aged the rows).
    ``preload``: run_preloaded_passes (pass N+1's reader runs while pass N
    trains and while its delta is saved), else sequential passes. Returns
    (per-pass stats, (batch_dir, xbox_dir) of the base save)."""
    every = max(1, cm.cfg.save_delta_every_passes)
    state = {"delta_id": 0}

    def on_pass(i: int, _stats) -> None:
        if (i + 1) % every == 0:
            state["delta_id"] += 1
            cm.save_delta(day, state["delta_id"])

    if preload:
        stats = run_preloaded_passes(trainer, datasets, after_pass=on_pass)
    else:
        stats = []
        for i, ds in enumerate(datasets):
            stats.append(trainer.train_pass(ds))
            on_pass(i, stats[-1])
            ds.release_memory()
    dirs = cm.save_base(trainer.params, trainer.opt_state, day)
    trainer.table.end_day(age=False)
    cm.wait()
    return stats, dirs


def read_batch_sparse(batch_dir: str, threads: int = 0) -> Dict:
    """The sparse blob ({"keys", "values", "embedx_dim", "optimizer"}) of
    one full batch-model directory, columnar or legacy pickle."""
    man = os.path.join(batch_dir, SPARSE_MANIFEST)
    if os.path.exists(man):
        if cks.read_manifest(man).get("mode") == "journal":
            raise ValueError(f"{batch_dir}: a journal-over-base snapshot, "
                             "not a full base")
        return cks.load_sparse_columnar(man, threads)
    with open(os.path.join(batch_dir, SPARSE_PICKLE), "rb") as f:
        return cks.safe_load(f)


class XboxModelReader:
    """The serving side of the handoff: a day's xbox base composed with its
    delta views into one key -> [embed_w, embedx] lookup. Views apply in
    the structural order of serving/store.py's discover_xbox_sources (day,
    then deltas by id, then the day's base, DONE time stamps last), the
    freshest view winning a key; unknown keys read as zero rows."""

    def __init__(self, xbox_model_dir: str, *days: str) -> None:
        """days: day directories oldest first; at least one must have a
        completed base."""
        if not days:
            raise ValueError("need at least one day")
        sources = discover_xbox_sources(xbox_model_dir, days)
        self._dim: Optional[int] = None
        self.deltas_applied = sum(1 for s in sources if not s.is_base)
        # every view in apply order, then one lexsort by (key, order)
        # keeping each key's last occurrence: the freshest view wins and the
        # keys come out sorted for searchsorted
        key_blocks: list = []
        row_blocks: list = []
        for src in sources:
            keys_v, emb = read_xbox_view(src.path)
            if self._dim is None and emb.ndim == 2:
                self._dim = int(emb.shape[1])
            key_blocks.append(keys_v)
            row_blocks.append(emb)
        all_keys = np.concatenate(key_blocks)
        seq = np.arange(all_keys.size)
        order = np.lexsort((seq, all_keys))
        sk = all_keys[order]
        last = (np.r_[sk[1:] != sk[:-1], True] if sk.size
                else np.zeros(0, bool))
        self._keys = sk[last]
        self._n = int(self._keys.size)
        self._rows = (np.vstack(row_blocks)[order[last]] if self._n
                      else np.empty((0, self.dim), np.float32))

    def __len__(self) -> int:
        return self._n

    @property
    def dim(self) -> int:
        return self._dim or 0

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """[K] uint64 feasigns -> [K, 1 + embedx_dim]; unknown keys are
        zero rows."""
        keys = np.asarray(keys, np.uint64).reshape(-1)
        out = np.zeros((keys.size, self.dim), np.float32)
        if self._keys.size and keys.size:
            pos = np.minimum(np.searchsorted(self._keys, keys),
                             self._keys.size - 1)
            hit = self._keys[pos] == keys
            out[hit] = self._rows[pos[hit]]
        return out

    def save_columnar(self, path: str) -> str:
        """The composed view as one serving columnar file at ``path``."""
        return write_xbox_columnar(path, self._keys, self._rows)
