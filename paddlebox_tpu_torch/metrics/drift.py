"""Slot-level data-quality drift monitor over the columnar ingest blocks.

Counterpart of paddlebox_tpu/metrics/drift.py:45-407. A window is one pass: the dataset observes each merged
ColumnarBlock (a strided sample of at most SAMPLE_RECS records, taken with
``ColumnarBlock.select``) and the trainer each batch's predictions; at
pass end ``roll()`` closes the window. Per slot it keeps the coverage
(records with a key in the slot), keys per covered record and a distinct-key
estimate from a SKETCH_BITS-bit linear-counting sketch over a splitmix64
hash; beside them the label rate and a PRED_BINS-bin pred histogram. A
window's drift score is the worst relative departure of any of these from
the mean of the last ``history`` windows, in [0, 1]; slots whose coverage
fell below a tenth of it are ``dropped_slots``. ``roll`` publishes the
gauges data_drift_score and data_dropped_slots and logs a warning at
``drift_warn``.

The streaming runner's admission gate (train/streaming_runner.py) scores a
loaded micro-pass window with ``preview_block`` (no reference advance) and
folds an admitted one in with ``admit_block``; the exporter's /quality and
/metrics read ``snapshot``.

numpy and the standard library; one threading.Lock.
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from paddlebox_tpu_torch.obs import log as obs_log
from paddlebox_tpu_torch.utils.lockwatch import make_lock
from paddlebox_tpu_torch.utils.stats import gauge_set

#: per-slot linear-counting sketch bits
SKETCH_BITS = 2048
#: pred-histogram bins over [0, 1]
PRED_BINS = 32
#: records observed a block: a larger block is sampled by an evenly
#: strided select, so the cost a pass is constant
SAMPLE_RECS = 4096


def _hash_u64(keys: np.ndarray) -> np.ndarray:
    """The splitmix64 finalizer, vectorized (uint64 wraparound)."""
    k = keys.astype(np.uint64, copy=True)
    k ^= k >> np.uint64(30)
    k *= np.uint64(0xBF58476D1CE4E5B9)
    k ^= k >> np.uint64(27)
    k *= np.uint64(0x94D049BB133111EB)
    k ^= k >> np.uint64(31)
    return k


class _Window:
    """One window's accumulators (grown to the largest slot seen)."""

    def __init__(self) -> None:
        self.n_recs = 0
        self.slot_keys = np.zeros(0, np.int64)
        self.slot_recs = np.zeros(0, np.int64)
        self.sketch: Dict[int, np.ndarray] = {}     # slot -> bool[SKETCH_BITS]
        self.label_pos = 0.0
        self.label_n = 0.0
        self.pred_hist = np.zeros(PRED_BINS, np.int64)

    def _grow(self, n: int) -> None:
        if n <= self.slot_keys.size:
            return
        for name in ("slot_keys", "slot_recs"):
            old = getattr(self, name)
            new = np.zeros(n, np.int64)
            new[:old.size] = old
            setattr(self, name, new)

    def summary(self) -> dict:
        ns = self.slot_keys.size
        cov = (self.slot_recs / max(self.n_recs, 1)).astype(np.float64)
        kpr = np.where(self.slot_recs > 0,
                       self.slot_keys / np.maximum(self.slot_recs, 1), 0.0)
        card = np.zeros(ns, np.float64)
        for s, bits in self.sketch.items():
            fill = float(bits.sum()) / SKETCH_BITS
            # linear counting; a full sketch reports its ceiling
            card[s] = (-SKETCH_BITS * np.log(max(1.0 - fill, 1e-9))
                       if fill < 1.0 else SKETCH_BITS * 20.0)
        ph = self.pred_hist.astype(np.float64)
        tot = ph.sum()
        return {"n_recs": int(self.n_recs),
                "coverage": cov, "keys_per_rec": kpr, "cardinality": card,
                "label_rate": (self.label_pos / self.label_n
                               if self.label_n else 0.0),
                "pred_hist": (ph / tot if tot else ph)}


class SlotDriftMonitor:
    """observe_* may come from the reader and the trainer's threads; roll
    from the pass driver."""

    def __init__(self, history: int = 4, drift_warn: float = 0.5,
                 min_coverage: float = 0.01) -> None:
        self.drift_warn = float(drift_warn)
        self.history = int(history)
        self.min_coverage = float(min_coverage)
        self._lock = make_lock("SlotDriftMonitor._lock")
        self._cur = _Window()
        self._ref: List[dict] = []
        self.windows = 0
        self.last_roll: Optional[dict] = None

    # ------------------------------------------------------------- observe
    def observe_block(self, block) -> None:
        """One merged ColumnarBlock, in one vectorized pass over (a sample
        of at most SAMPLE_RECS records of) its columns."""
        n_recs = int(block.n_recs)
        if n_recs == 0:
            return
        if n_recs > SAMPLE_RECS:
            idx = np.linspace(0, n_recs - 1, SAMPLE_RECS).astype(np.int64)
            block = block.select(idx)
            n_recs = SAMPLE_RECS
        key_slot = np.asarray(block.key_slot)
        ns = int(key_slot.max()) + 1 if key_slot.size else 0
        counts = (np.bincount(key_slot, minlength=ns).astype(np.int64)
                  if key_slot.size else np.zeros(0, np.int64))
        if key_slot.size:
            # records covered a slot: one presence scatter into a
            # [n_recs, ns] bool plane, no sort
            rec = np.repeat(np.arange(n_recs, dtype=np.int64),
                            np.diff(np.asarray(block.rec_offsets)))
            pres = np.zeros(n_recs * ns, bool)
            pres[rec * ns + key_slot] = True
            prec = pres.reshape(n_recs, ns).sum(axis=0, dtype=np.int64)
            hashed = _hash_u64(np.asarray(block.keys))
            bit = (hashed % np.uint64(SKETCH_BITS)).astype(np.int64)
            sk = np.zeros(ns * SKETCH_BITS, bool)
            sk[key_slot.astype(np.int64) * SKETCH_BITS + bit] = True
            sk = sk.reshape(ns, SKETCH_BITS)
        labels = np.asarray(block.labels)
        pos = float((labels != 0).sum())
        with self._lock:
            w = self._cur
            w.n_recs += n_recs
            w.label_pos += pos
            w.label_n += float(labels.size)
            if ns:
                w._grow(ns)
                w.slot_keys[:ns] += counts
                w.slot_recs[:ns] += prec
                for s in np.nonzero(counts)[0].tolist():
                    bits = w.sketch.get(s)
                    if bits is None:
                        w.sketch[s] = sk[s].copy()
                    else:
                        bits |= sk[s]

    def observe_preds(self, pred, mask=None) -> None:
        """The pred histogram (the trainer's metric path feeds it)."""
        pred = np.asarray(pred, np.float64).reshape(-1)
        if mask is not None:
            pred = pred[np.asarray(mask).reshape(-1).astype(bool)]
        if pred.size == 0:
            return
        idx = np.clip((pred * PRED_BINS).astype(np.int64), 0,
                      PRED_BINS - 1)
        hist = np.bincount(idx, minlength=PRED_BINS)
        with self._lock:
            self._cur.pred_hist += hist

    # ---------------------------------------------------------------- roll
    def _drift_against(self, cur: dict, ref: dict) -> dict:
        """The worst component's relative departure, each clamped to
        [0, 1]."""
        ns = max(cur["coverage"].size, ref["coverage"].size)

        def pad(v):
            out = np.zeros(ns, np.float64)
            out[:v.size] = v
            return out

        ccov, rcov = pad(cur["coverage"]), pad(ref["coverage"])
        ckpr, rkpr = pad(cur["keys_per_rec"]), pad(ref["keys_per_rec"])
        ccard, rcard = pad(cur["cardinality"]), pad(ref["cardinality"])
        watch = rcov >= self.min_coverage
        per_slot = np.zeros(ns, np.float64)
        if watch.any():
            cov_drop = np.clip((rcov - ccov) / np.maximum(rcov, 1e-9),
                               0.0, 1.0)
            kpr_drift = np.clip(np.abs(ckpr - rkpr)
                                / np.maximum(rkpr, 1e-9), 0.0, 1.0)
            card_drop = np.clip(1.0 - ccard / np.maximum(rcard, 1e-9),
                                0.0, 1.0)
            per_slot = np.where(
                watch, np.maximum(cov_drop,
                                  np.maximum(kpr_drift, card_drop)), 0.0)
        dropped = np.nonzero(watch & (ccov < 0.1 * rcov))[0].tolist()
        label_drift = float(min(abs(cur["label_rate"] - ref["label_rate"])
                                / max(ref["label_rate"], 1e-9), 1.0))
        pred_drift = 0.0
        if cur["pred_hist"].sum() > 0 and ref["pred_hist"].sum() > 0:
            # total variation distance of the pred distributions
            pred_drift = float(
                0.5 * np.abs(cur["pred_hist"] - ref["pred_hist"]).sum())
        score = float(max(per_slot.max() if ns else 0.0,
                          label_drift, pred_drift))
        worst = int(np.argmax(per_slot)) if ns and per_slot.max() > 0 else -1
        return {"score": round(score, 4),
                "dropped_slots": dropped,
                "worst_slot": worst,
                "label_drift": round(label_drift, 4),
                "pred_drift": round(pred_drift, 4)}

    @staticmethod
    def _ref_mean(refs: List[dict]) -> dict:
        ns = max(r["coverage"].size for r in refs)

        def mean(key):
            acc = np.zeros(ns, np.float64)
            for r in refs:
                v = r[key]
                acc[:v.size] += v
            return acc / len(refs)

        ph = np.zeros(PRED_BINS, np.float64)
        for r in refs:
            ph += r["pred_hist"]
        return {"coverage": mean("coverage"),
                "keys_per_rec": mean("keys_per_rec"),
                "cardinality": mean("cardinality"),
                "label_rate": float(np.mean([r["label_rate"]
                                             for r in refs])),
                "pred_hist": ph / len(refs)}

    def roll(self) -> Optional[dict]:
        """Close the window: its drift against the reference, the gauges,
        the reference advanced. Returns the window's record (None when the
        window saw nothing)."""
        with self._lock:
            w, self._cur = self._cur, _Window()
            if w.n_recs == 0 and w.pred_hist.sum() == 0:
                return None
            cur = w.summary()
            refs = list(self._ref)
            self.windows += 1
            win_idx = self.windows
        if refs:
            drift = self._drift_against(cur, self._ref_mean(refs))
        else:
            # the first window is the reference
            drift = {"score": 0.0, "dropped_slots": [], "worst_slot": -1,
                     "label_drift": 0.0, "pred_drift": 0.0}
        rec = {
            "window": win_idx,
            "ts": time.time(),
            "n_recs": cur["n_recs"],
            "n_slots": int(cur["coverage"].size),
            "label_rate": round(cur["label_rate"], 6),
            "drift": drift,
        }
        with self._lock:
            # a drifting window enters the reference too: a lasting change
            # becomes the new normal after ``history`` windows
            self._ref.append(cur)
            if len(self._ref) > self.history:
                self._ref.pop(0)
            self.last_roll = rec
        gauge_set("data_drift_score", drift["score"])
        gauge_set("data_dropped_slots", float(len(drift["dropped_slots"])))
        if drift["score"] >= self.drift_warn:
            obs_log.warning(
                "data-quality drift past warn threshold",
                score=drift["score"], warn=self.drift_warn,
                dropped_slots=str(drift["dropped_slots"][:8]),
                worst_slot=drift["worst_slot"])
        return rec

    def preview_block(self, block) -> float:
        """The drift score of ``block`` against the reference, without
        admitting it: no reference advance, no window count, no gauge. 0.0
        until a reference exists. The caller owns this monitor (the
        streaming runner's private one): the live window is swapped out
        while the block is scored."""
        with self._lock:
            saved, self._cur = self._cur, _Window()
        try:
            self.observe_block(block)
            with self._lock:
                cur = self._cur.summary() if self._cur.n_recs else None
                refs = list(self._ref)
        finally:
            with self._lock:
                self._cur = saved
        if cur is None or not refs:
            return 0.0
        return float(self._drift_against(cur, self._ref_mean(refs))["score"])

    def admit_block(self, block) -> None:
        """Fold an admitted window's block into the reference (observe,
        then roll): the commit that pairs with preview_block."""
        self.observe_block(block)
        self.roll()

    def snapshot(self) -> dict:
        """The exporter's view: windows rolled, the live window's records
        and a copy of the last rolled record."""
        with self._lock:
            return {"windows": self.windows,
                    "live_recs": int(self._cur.n_recs),
                    "last": copy.deepcopy(self.last_roll)}


# ------------------------------------------------------------- module API
# the monitor the dataset's ingest hook feeds: the last trainer built (or
# the one whose pass runs) sets it, None when its data_quality is off
_ACTIVE: Optional[SlotDriftMonitor] = None


def active() -> Optional[SlotDriftMonitor]:
    return _ACTIVE


def set_active(m: Optional[SlotDriftMonitor]) -> Optional[SlotDriftMonitor]:
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, m
    return prev


def observe_block(block) -> None:
    """The ingest hook (data/dataset.py, once a merged block): feeds the
    active monitor, if any. Never raises: a monitoring fault must not fail
    the load."""
    m = _ACTIVE
    if m is None:
        return
    try:
        m.observe_block(block)
    except Exception as e:  # noqa: BLE001 (telemetry degrades, never kills)
        obs_log.warning("data-quality observe failed", error=repr(e)[:200])


def observe_preds(pred, mask=None) -> None:
    """The pred histogram of the active monitor, if any."""
    m = _ACTIVE
    if m is not None:
        m.observe_preds(pred, mask=mask)


def set_active_new() -> SlotDriftMonitor:
    """A fresh default monitor, made the active one."""
    global _ACTIVE
    _ACTIVE = SlotDriftMonitor()
    return _ACTIVE


def roll_gauges(monitor: Optional[SlotDriftMonitor]) -> Optional[dict]:
    """Pass end: roll ``monitor`` (None: nothing) and return its record.
    Never raises, as observe_block."""
    if monitor is None:
        return None
    try:
        return monitor.roll()
    except Exception as e:  # noqa: BLE001 (telemetry degrades, never kills)
        obs_log.warning("data-quality roll failed", error=repr(e)[:200])
        return None


def make_from_flags(flags) -> Optional[SlotDriftMonitor]:
    """An ObsFlags-configured monitor (None when data_quality is off),
    made the active one."""
    m = (SlotDriftMonitor(drift_warn=flags.data_quality_warn)
         if flags.data_quality else None)
    set_active(m)
    return m
