"""Two-tier, pass-cadenced checkpoints, and the day that writes them.

Counterpart of paddlebox_tpu/train/checkpoint.py (CheckpointManager
:71-510, run_day :518-564, read_batch_sparse :567-581, merge_models
:584-636, XboxModelReader :639-717). SaveBase/SaveDelta semantics
(box_wrapper.cc:1286-1318): a **batch model** is the whole training state
(the sparse store with its optimizer columns, the dense parameters and the
dense Adam state), for resume; an **xbox model** is the serving view (per
key: embed_w and embedx). save_delta writes the features whose delta score
crossed delta_threshold since the last save and then clears those scores
(UpdateStatAfterSave param 1); save_base writes everything, the SSD tier's
rows at their effective values included, and also ages every resident row
(param 3; the tier's rows age by its day clock). Both rewrite store rows outside the pass cadence, so
both drop the table's residency.

A day directory holds, for day ``d``:

  <batch_model_dir>/d/sparse.xman, sparse.xman.p0000..  the columnar sparse
        tier (embedding/ckpt_store.py), or sparse.pkl (ckpt_format pickle)
  <batch_model_dir>/d/dense.pkl   {"params", "opt_state", "extra", "flags"}
        of numpy arrays, Python scalars and dicts (convert.py's names)
  <batch_model_dir>/_journal/rank0/seg-<epoch>-<seq>.jrnl  the touched-row
        journal's segments (train/journal.py), with ckpt_journal
  <xbox_model_dir>/d/view.xcol            the base view, all features
  <xbox_model_dir>/d/delta-<i>/view.xcol  each delta view
  DONE in each directory, written last (its content a time stamp)

which the JAX package's loaders and ``serving/`` read as they read their
own. With the journal (ckpt_journal, on by default as in the reference),
save_base(mode='touched') writes a journal-mode snapshot in place of the
sparse parts: ``sparse.xman`` with mode 'journal' naming hard links
``base.b0000..`` to the last full base's parts and ``journal-000000.jrnl..``
to the journal's segments since; it has no xbox view. load_base replays
such a snapshot over its base, and every load re-anchors the journal on
what it loaded. A touched save the journal cannot serve (no full base
anchored yet, segments dropped past the rotation bound, a tainted epoch, a
file that will not link) falls back to a full save with a warning, and
counts ckpt_touched_fallback_full in the stat registry.

Snapshots and the stat rewrite run on the caller's thread; only the file
writes go to a writer thread (async_save). ``wait`` joins every writer and
raises the first error a writer met. ``seconds`` adds up host-clock
seconds: save_base and save_delta (the caller's part), their writers, and
load_base.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import shutil
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
from paddlebox_tpu_torch.train import journal as jr
from paddlebox_tpu_torch.train.preload import run_preloaded_passes
from paddlebox_tpu_torch.utils.lockwatch import make_lock
from paddlebox_tpu_torch.utils.stats import stat_add

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
    """Batch and xbox saves of one table's store, and the touched-row
    journal that rides its passes."""

    def __init__(self, cfg: CheckpointConfig, table,
                 flags: Optional[CkptFlags] = None) -> None:
        """``table``: a PassTable, or a ShardedPassTable at world 1, whose
        ``store`` is its store_view (reference checkpoint.py:72-84); above
        world 1 that raises, and such a job checkpoints per owned shard
        with table.save. With ``flags.ckpt_journal`` (the default) a
        touched-row journal is made under
        ``<batch_model_dir>/_journal/rank0`` and attached to the table;
        where that directory cannot be made, a warning says so and the
        manager goes on without it (touched saves then save in full), as
        the reference does."""
        self.cfg = cfg
        self.table = table
        self.store = table.store
        self.flags = flags or CkptFlags()
        self._writers: List[threading.Thread] = []
        self._errors: List[BaseException] = []
        self._writers_lock = make_lock("CheckpointManager._writers_lock")
        self.seconds: Dict[str, float] = dict.fromkeys(SECONDS, 0.0)
        self.journal: Optional[jr.TouchedRowJournal] = None
        if self.flags.ckpt_journal:
            jdir = os.path.join(cfg.batch_model_dir, "_journal", "rank0")
            try:
                self.journal = jr.TouchedRowJournal(
                    jdir, table.layout, table.config,
                    self.flags.ckpt_journal_segment_bytes,
                    self.flags.ckpt_journal_segments)
            except OSError as e:
                log.warning("touched-row journal disabled: cannot create "
                            "its directory %s (%r)", jdir, e)
            else:
                table.attach_journal(self.journal)

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

    @staticmethod
    def _dense(params: Any, opt_state: Any, extra: Optional[Dict]) -> Dict:
        """dense.pkl's dict, checked to hold numpy and Python values only."""
        dense = {"params": params, "opt_state": opt_state,
                 "extra": extra or {},
                 # the port's Adam state is per parameter, not optax.flatten's
                 # one vector
                 "flags": {"flatten_dense_opt": False}}
        _check_plain(dense, "dense")
        return dense

    def _write_dense(self, batch_dir: str, dense: Dict) -> None:
        with open(os.path.join(batch_dir, "dense.pkl"), "wb") as f:
            pickle.dump(dense, f)

    def _stat_after_save(self, base: bool) -> None:
        """The post-save stat rewrite, in place on the store: clear the
        covered delta scores, and on a base save age every row; the
        journal records each, in the same store_lock hold; then drop the
        residency, which the rewrite made stale."""
        with self.table.store_lock:
            jr.apply_stat_after_save(self.store, self.table.config, 1)
            if base:
                jr.apply_stat_after_save(self.store, self.table.config, 3)
            if self.journal is not None:
                self.journal.append_event(jr.EV_STAT_SAVE_DELTA)
                if base:
                    self.journal.append_event(jr.EV_STAT_SAVE_AGE)
        self._invalidate_residency()

    def _plan_sparse(self, batch_dir: str, n_rows: int
                     ) -> Tuple[str, Optional[int], List[str]]:
        """(sparse path, part count or None for the legacy pickle, the
        part files): fixed before the writer runs, so that the journal
        anchors on the files it will write."""
        if self.flags.ckpt_format == "pickle":
            path = os.path.join(batch_dir, SPARSE_PICKLE)
            return path, None, [path]
        path = os.path.join(batch_dir, SPARSE_MANIFEST)
        n_parts = cks.default_parts(n_rows, self.flags.ckpt_parts)
        return path, n_parts, [f"{path}.p{i:04d}" for i in range(n_parts)]

    def save_base(self, params: Any, opt_state: Any, day: str,
                  extra: Optional[Dict] = None,
                  mode: str = "full") -> Tuple[str, Optional[str]]:
        """Base save of ``day`` -> (batch_dir, xbox_dir): dense.pkl
        (``params``, ``opt_state`` and ``extra``, numpy arrays and Python
        scalars in dicts) and the sparse tier. mode 'full': every row, and
        the xbox base view; the journal starts a new epoch anchored on
        this save's parts. mode 'touched': the journal-mode snapshot, no
        xbox view (xbox_dir None), or a full save with a warning where the
        journal cannot serve it. mode 'auto': touched when the journal is
        anchored and whole, else full. The store snapshot and the stat
        rewrite happen here; the files are written by a writer thread."""
        self.wait()
        if mode == "auto":
            mode = ("touched" if self.journal is not None
                    and self.journal.snapshot_ready() else "full")
        if mode == "touched":
            return self._save_base_touched(params, opt_state, day, extra)
        if mode != "full":
            raise ValueError(f"save_base mode {mode!r} not in "
                             "('full', 'touched', 'auto')")
        dense = self._dense(params, opt_state, extra)
        t0 = time.perf_counter()
        batch_dir = os.path.join(self.cfg.batch_model_dir, day)
        xbox_dir = os.path.join(self.cfg.xbox_model_dir, day)
        os.makedirs(batch_dir, exist_ok=True)
        os.makedirs(xbox_dir, exist_ok=True)
        with self.table.store_lock:
            keys, values = self.store.state_items()  # a copy
            # the SSD tier's rows, at their effective values: a base covers
            # them (a load empties the tier); the stat rewrite below
            # touches resident rows only, as in the reference
            skeys, svals = self.store.spilled_snapshot()
            if skeys.size:
                keys = np.concatenate([keys, skeys])
                values = np.vstack([values, svals])
            # the new epoch starts at this snapshot, before the stat
            # rewrite below; its parts exist once the writer is done, and
            # every save and load waits for it first. The base holds the
            # tier's rows as resident ones, so the epoch opens by spilling
            # them again (a replay re-spills them from the loaded base), and
            # the live tier pins a span boundary of its lazy aging here:
            # from now on the live and the replayed tier apply the same
            # missed-day spans
            sparse_path, n_parts, part_paths = self._plan_sparse(
                batch_dir, int(keys.size))
            if self.journal is not None:
                self.journal.anchor_full(part_paths)
                self.journal.append_move(jr.MV_SPILL, skeys)
            self.store.rebase_spill_ages()
        xbox_blob = self._xbox_view(keys, values, base=True)
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
            self._write_dense(batch_dir, dense)
            self._write_xbox(xbox_dir, xbox_blob)
            _write_done(batch_dir)

        self._add_seconds("save_base", t0)
        self._spawn_writer(do_save, "save_base_writer")
        return batch_dir, xbox_dir

    def _save_base_touched(self, params: Any, opt_state: Any, day: str,
                           extra: Optional[Dict]
                           ) -> Tuple[str, Optional[str]]:
        """The journal-mode snapshot: hard links to the anchor's base parts
        and to the journal's segments, and a manifest naming them, written
        by tmp + fsync + rename; then the journal's anchor moves onto these
        links. Where the journal refuses or a link fails (a part pruned, a
        writer that died before writing it): a full save, with a
        warning."""
        dense = self._dense(params, opt_state, extra)
        t0 = time.perf_counter()
        batch_dir = os.path.join(self.cfg.batch_model_dir, day)
        try:
            if self.journal is None:
                raise jr.JournalIncompleteError(
                    "no touched-row journal on this manager (ckpt_journal "
                    "off, or its directory could not be created)")
            refs = self.journal.snapshot_refs()
            os.makedirs(batch_dir, exist_ok=True)
            base_names, seg_names = [], []
            for i, p in enumerate(refs["parts"]):
                name = f"base.b{i:04d}"
                cks.link_or_copy(p, os.path.join(batch_dir, name))
                base_names.append(name)
            for i, p in enumerate(refs["segments"]):
                name = f"journal-{i:06d}.jrnl"
                cks.link_or_copy(p, os.path.join(batch_dir, name))
                seg_names.append(name)
            manifest = {"format": cks.MANIFEST_FORMAT,
                        "version": cks.MANIFEST_VERSION, "mode": "journal",
                        "width": int(self.table.layout.width),
                        "meta": self._meta(), "base": base_names,
                        "segments": seg_names,
                        "dirty_rows": int(refs["dirty_rows"])}
            man_path = os.path.join(batch_dir, SPARSE_MANIFEST)
            tmp = f"{man_path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, man_path)
        except (jr.JournalIncompleteError, OSError) as e:
            # stray base.b*/journal-* links of the attempt are ignored by
            # the full save's manifest
            stat_add("ckpt_touched_fallback_full")
            log.warning("touched base save falling back to FULL: %r", e)
            return self.save_base(params, opt_state, day, extra,
                                  mode="full")
        self.journal.rebase(
            [os.path.join(batch_dir, n) for n in base_names],
            [os.path.join(batch_dir, n) for n in seg_names])
        self._stat_after_save(base=True)

        def do_save() -> None:
            self._write_dense(batch_dir, dense)
            _write_done(batch_dir)

        self._add_seconds("save_base", t0)
        self._spawn_writer(do_save, "save_base_writer")
        return batch_dir, None

    def replay_base_rewrite(self) -> None:
        """Apply to the store what a base save applies after its snapshot
        (clear the covered delta scores, age every row), journaled as
        save_base journals it. A base holds the snapshot from before that
        rewrite, so a store just loaded by load_base, after this, is the
        store its saver went on training."""
        self._stat_after_save(base=True)

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
    def _read_base_files(self, paths) -> Dict:
        """One blob of a journal-mode snapshot's base files, each sniffed:
        a columnar part or a legacy pickle blob."""
        layout = self.table.layout
        key_blocks, val_blocks = [], []
        for p in paths:
            with open(p, "rb") as f:
                head = f.read(8)
            if head == cks.PART_MAGIC:
                k, v = cks.map_part(p)
            else:
                with open(p, "rb") as f:
                    b = cks.safe_load(f)
                if (b["embedx_dim"] != layout.embedx_dim
                        or b["optimizer"] != layout.optimizer):
                    raise ValueError(f"{p}: checkpoint layout mismatch")
                k, v = np.asarray(b["keys"], np.uint64), b["values"]
            if v.shape[1] != layout.width:
                raise ValueError(f"{p}: width {v.shape[1]} != "
                                 f"{layout.width}")
            key_blocks.append(np.asarray(k))
            val_blocks.append(np.asarray(v, np.float32))
        keys = (np.concatenate(key_blocks) if key_blocks
                else np.empty(0, np.uint64))
        vals = (np.vstack(val_blocks) if key_blocks
                else np.empty((0, layout.width), np.float32))
        return {"keys": keys, "values": vals,
                "embedx_dim": layout.embedx_dim,
                "optimizer": layout.optimizer}

    def _reconstruct_journal_manifest(self, batch_dir: str,
                                      doc: Dict) -> Dict:
        """The blob a journal-mode snapshot stands for: its base replayed
        with its segments."""
        base = self._read_base_files(
            os.path.join(batch_dir, n) for n in doc["base"])
        segs = [os.path.join(batch_dir, n) for n in doc["segments"]]
        return jr.reconstruct_blob(base, segs, self.table.layout,
                                   self.table.config)

    def _artifact_refs(self, batch_dir: str) -> Tuple[List[str], List[str]]:
        """(base part files, journal segment files) of a completed batch
        directory: what the journal re-anchors on after a load."""
        man = os.path.join(batch_dir, SPARSE_MANIFEST)
        if os.path.exists(man):
            doc = cks.read_manifest(man)
            if doc.get("mode") == "journal":
                return ([os.path.join(batch_dir, n) for n in doc["base"]],
                        [os.path.join(batch_dir, n)
                         for n in doc["segments"]])
            return cks.manifest_part_paths(man), []
        return [os.path.join(batch_dir, SPARSE_PICKLE)], []

    def load_base(self, day: str) -> Tuple[Any, Any, Dict]:
        """Resume from the batch model of ``day`` (a columnar manifest, a
        journal-mode snapshot replayed over its base, or a legacy
        sparse.pkl, whichever the completed directory holds): replaces the
        store's rows, anchors the journal on what it loaded, and returns
        (params, opt_state, extra) of dense.pkl. dense.pkl is read before
        the store is touched, through a restricted unpickler: a file
        holding anything but numpy arrays and builtin containers (a
        JAX-written one holds jax arrays) raises pickle.UnpicklingError and
        leaves the store as it was."""
        self.wait()
        t0 = time.perf_counter()
        batch_dir = os.path.join(self.cfg.batch_model_dir, day)
        if not os.path.exists(os.path.join(batch_dir, "DONE")):
            raise FileNotFoundError(f"no completed checkpoint at {batch_dir}")
        with open(os.path.join(batch_dir, "dense.pkl"), "rb") as f:
            blob = cks.safe_load(f)
        man = os.path.join(batch_dir, SPARSE_MANIFEST)
        threads = self.flags.ckpt_io_threads
        if not os.path.exists(man):
            sparse = cks.load_sparse_any(
                os.path.join(batch_dir, SPARSE_PICKLE), threads)
        else:
            doc = cks.read_manifest(man)
            sparse = (self._reconstruct_journal_manifest(batch_dir, doc)
                      if doc.get("mode") == "journal"
                      else cks.load_sparse_columnar(man, threads))
        self._invalidate_residency()
        with self.table.store_lock:
            self.store.load_blob(sparse)
        # load_blob emptied the SSD tier (the base holds its rows), so the
        # anchor starts with nothing spilled
        if self.journal is not None:
            parts, segs = self._artifact_refs(batch_dir)
            self.journal.anchor_full(parts, segments=segs)
        self._add_seconds("load_base", t0)
        return blob["params"], blob["opt_state"], blob["extra"]


def run_day(trainer, datasets, cm: CheckpointManager, day: str,
            preload: bool = True):
    """One training day: per pass train, then a delta save every
    ``cm.cfg.save_delta_every_passes`` passes; at the day's end the base
    save and ``end_day(age=False)`` (save_base already aged the rows).
    ``preload``: run_preloaded_passes (pass N+1's reader runs while pass N
    trains and while its delta is saved), else sequential passes.
    ``trainer``: a BoxTrainer or a ShardedBoxTrainer at world 1 (its
    merged dense state is saved); a multi-process sharded trainer raises
    the reference's TypeError (checkpoint.py:537-540). Returns (per-pass
    stats, (batch_dir, xbox_dir) of the base save)."""
    if getattr(trainer, "multiprocess", False):
        raise TypeError("multi-process jobs checkpoint per owned shard "
                        "(table.save) — run_day's single-blob cadence "
                        "drives single-process trainers (Box or Sharded)")
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
    dirs = cm.save_base(trainer.merged_params(),
                        trainer.merged_opt_state(), day)
    trainer.table.end_day(age=False)
    cm.wait()
    return stats, dirs


def read_batch_sparse(batch_dir: str, threads: int = 0) -> Dict:
    """The sparse blob ({"keys", "values", "embedx_dim", "optimizer"}) of
    one FULL batch-model directory, columnar or legacy pickle. A
    journal-over-base snapshot needs a table to replay against
    (CheckpointManager.load_base): it raises ValueError here."""
    man = os.path.join(batch_dir, SPARSE_MANIFEST)
    if os.path.exists(man):
        if cks.read_manifest(man).get("mode") == "journal":
            raise ValueError(
                f"{batch_dir}: journal-over-base snapshot — load it "
                "through CheckpointManager.load_base (merge wants "
                "day-end FULL bases)")
        return cks.load_sparse_columnar(man, threads)
    with open(os.path.join(batch_dir, SPARSE_PICKLE), "rb") as f:
        return cks.safe_load(f)


def merge_models(batch_dirs, out_dir: str,
                 flags: Optional[CkptFlags] = None) -> str:
    """Merge N full batch models into one at ``out_dir`` (MergeModel /
    MergeMultiModels, box_wrapper.h:788-804), by the reference's rule for
    CTR rows: the counters (show, click, delta_score) SUM across models,
    the other columns average weighted by show (at least 1e-6), unseen_days
    takes the min and mf_size the max; in float64, rounded once to f32.
    dense.pkl is the first model's, byte for byte (data-parallel replicas
    hold the same dense state). The sparse tier lands in ``flags``'
    format. Returns out_dir."""
    flags = flags or CkptFlags()
    blobs = [read_batch_sparse(d, flags.ckpt_io_threads) for d in batch_dirs]
    embedx_dim = blobs[0]["embedx_dim"]
    opt = blobs[0]["optimizer"]
    width = blobs[0]["values"].shape[1]
    for b in blobs[1:]:
        if b["embedx_dim"] != embedx_dim or b["optimizer"] != opt:
            raise ValueError("cannot merge models with different layouts")
    counter_cols = [acc.SHOW, acc.CLICK, acc.DELTA_SCORE]
    all_keys = np.concatenate([b["keys"] for b in blobs])
    all_vals = np.concatenate([b["values"] for b in blobs]).astype(np.float64)
    out_keys, inv = np.unique(all_keys, return_inverse=True)
    n = out_keys.size
    w = np.maximum(all_vals[:, acc.SHOW], 1e-6)[:, None]
    wsum = np.zeros((n, width), np.float64)
    np.add.at(wsum, inv, all_vals * w)
    wtot = np.zeros((n, 1), np.float64)
    np.add.at(wtot, inv, w)
    out_vals = (wsum / wtot).astype(np.float32)
    csum = np.zeros((n, len(counter_cols)), np.float64)
    np.add.at(csum, inv, all_vals[:, counter_cols])
    out_vals[:, counter_cols] = csum
    unseen = np.full(n, np.inf)
    np.minimum.at(unseen, inv, all_vals[:, acc.UNSEEN_DAYS])
    out_vals[:, acc.UNSEEN_DAYS] = unseen
    mfsz = np.zeros(n)
    np.maximum.at(mfsz, inv, all_vals[:, acc.MF_SIZE])
    out_vals[:, acc.MF_SIZE] = mfsz
    os.makedirs(out_dir, exist_ok=True)
    out_name = (SPARSE_PICKLE if flags.ckpt_format == "pickle"
                else SPARSE_MANIFEST)
    cks.save_sparse_auto(os.path.join(out_dir, out_name), out_keys,
                         out_vals, {"embedx_dim": embedx_dim,
                                    "optimizer": opt},
                         fmt=flags.ckpt_format, parts=flags.ckpt_parts,
                         threads=flags.ckpt_io_threads)
    dense_src = os.path.join(batch_dirs[0], "dense.pkl")
    if os.path.exists(dense_src):
        shutil.copyfile(dense_src, os.path.join(out_dir, "dense.pkl"))
    _write_done(out_dir)
    return out_dir


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
