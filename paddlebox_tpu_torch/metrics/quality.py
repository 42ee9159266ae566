"""Tagged quality metrics: per-tag masked AUC, COPC, actual and predicted
CTR, and per-slot CTR.

Counterpart of paddlebox_tpu/metrics/quality.py:45-452 (the MetricMsg
family of the reference's fleet/metrics.cc): every tag owns a [2,
table_size] float64 neg/pos bucket table with BasicAucCalculator's
bucketing (``min(int(pred * T), T - 1)``) and five scalar accumulators
(abserr, sqrerr, pred_sum, click_sum, n), so two states merge by
elementwise addition. Per tag it computes auc (the trapezoid of
metrics/auc.py, -0.5 for a one-class window), copc (sum(label) /
sum(pred)), actual_ctr, predicted_ctr, mae, rmse and size; per slot, the
actual and predicted CTR and copc of the instances with a key in it.

numpy and the standard library. The trainer feeds ``add_batch`` and
``add_slot_batch`` a batch at a time and puts ``report()`` on its pass_end
record (``attach_pass_extras``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.metrics import drift as _drift
from paddlebox_tpu_torch.metrics.auc import trapezoid_auc
from paddlebox_tpu_torch.obs import log as obs_log
from paddlebox_tpu_torch.utils.lockwatch import make_lock
from paddlebox_tpu_torch.utils.stats import gauge_set, stat_add

STATE_VERSION = 1

#: the tag of the unmasked all-instances stream
ALL_TAG = "all"


def table_auc(table: np.ndarray) -> float:
    """Trapezoid AUC of a [2, T] neg/pos bucket table; -0.5 for a
    one-class or empty table."""
    return trapezoid_auc(np.asarray(table, np.float64))[0]


class TaggedQuality:
    """The tagged quality plane of one process. add_*, report and state
    hold one lock; report takes its copies under it and computes outside
    it."""

    _S_ABSERR, _S_SQRERR, _S_PRED, _S_CLICK, _S_N = range(5)

    def __init__(self, table_size: int = 65536) -> None:
        self.table_size = int(table_size)
        self._lock = make_lock("TaggedQuality._lock")
        self._tables: Dict[str, np.ndarray] = {}
        self._scalars: Dict[str, np.ndarray] = {}
        # per-slot ctr accumulators [n_slots], grown on demand
        self._slot_click = np.zeros(0, np.float64)
        self._slot_pred = np.zeros(0, np.float64)
        self._slot_n = np.zeros(0, np.float64)

    # ------------------------------------------------------------ helpers
    def _tag_state_locked(self, tag: str):
        tab = self._tables.get(tag)
        if tab is None:
            tab = np.zeros((2, self.table_size), np.float64)
            self._tables[tag] = tab
            self._scalars[tag] = np.zeros(5, np.float64)
        return tab, self._scalars[tag]

    def _grow_slots_locked(self, n: int) -> None:
        if n <= self._slot_n.size:
            return
        for name in ("_slot_click", "_slot_pred", "_slot_n"):
            old = getattr(self, name)
            new = np.zeros(n, np.float64)
            new[:old.size] = old
            setattr(self, name, new)

    # ---------------------------------------------------------------- add
    def add(self, pred, label, tag: str = ALL_TAG, mask=None) -> None:
        """Masked add into one tag's table. pred in [0, 1], label in {0,
        1}; rows with another label or a non-finite pred are dropped and
        counted (quality_rows_nonbinary_label, quality_rows_nonfinite_pred);
        a finite pred outside [0, 1] raises ValueError."""
        pred = np.asarray(pred, np.float64).reshape(-1)
        label = np.asarray(label).reshape(-1).astype(np.int64)
        if mask is not None:
            keep = np.asarray(mask).reshape(-1).astype(bool)
            pred, label = pred[keep], label[keep]
        binary = (label == 0) | (label == 1)
        if not binary.all():
            stat_add("quality_rows_nonbinary_label", int((~binary).sum()))
            pred, label = pred[binary], label[binary]
        finite = np.isfinite(pred)
        if not finite.all():
            stat_add("quality_rows_nonfinite_pred", int((~finite).sum()))
            pred, label = pred[finite], label[finite]
        if pred.size == 0:
            return
        if pred.min() < 0.0 or pred.max() > 1.0:
            raise ValueError("pred must lie in [0, 1]")
        pos = np.minimum((pred * self.table_size).astype(np.int64),
                         self.table_size - 1)
        neg_at = pos[label == 0]
        pos_at = pos[label == 1]
        s_abs = float(np.abs(pred - label).sum())
        s_sqr = float(((pred - label) ** 2).sum())
        s_pred = float(pred.sum())
        s_click = float(label.sum())
        with self._lock:
            tab, sc = self._tag_state_locked(tag)
            np.add.at(tab[0], neg_at, 1.0)
            np.add.at(tab[1], pos_at, 1.0)
            sc += (s_abs, s_sqr, s_pred, s_click, float(pred.size))

    def add_tagged(self, pred, label, tags, prefix: str = "",
                   mask=None) -> None:
        """One add a tag value of an int tag column, into tables named
        ``<prefix><tag>``; with a prefix, tag 0 is skipped."""
        tags = np.asarray(tags).reshape(-1).astype(np.int64)
        pred = np.asarray(pred, np.float64).reshape(-1)
        label = np.asarray(label).reshape(-1).astype(np.int64)
        if mask is not None:
            keep = np.asarray(mask).reshape(-1).astype(bool)
            tags, pred, label = tags[keep], pred[keep], label[keep]
        for t in np.unique(tags):
            if prefix and t == 0:
                continue
            sel = tags == t
            self.add(pred[sel], label[sel], tag="%s%d" % (prefix, int(t)))

    def add_slot_batch(self, pred, label, slots, segments, valid,
                       num_slots: int) -> None:
        """Per-slot CTR from one packed batch: an instance counts once in
        every slot it has a key in (one np.unique over the valid key
        slots' segments, which are record * num_slots + slot)."""
        valid = np.asarray(valid).reshape(-1).astype(bool)
        seg = np.asarray(segments).reshape(-1)[valid]
        if seg.size == 0:
            return
        pairs = np.unique(seg.astype(np.int64))
        rec = pairs // num_slots
        slot = pairs % num_slots
        pred = np.asarray(pred, np.float64).reshape(-1)[rec]
        label = np.asarray(label, np.float64).reshape(-1)[rec]
        with self._lock:
            self._grow_slots_locked(num_slots)
            np.add.at(self._slot_click, slot, label)
            np.add.at(self._slot_pred, slot, pred)
            np.add.at(self._slot_n, slot, 1.0)

    def add_bucket_table(self, table, abserr: float, sqrerr: float,
                         pred_sum: float, click_sum: float, n: float,
                         tag: str = ALL_TAG) -> None:
        """Merge a [2, Td] bucket table accumulated elsewhere; a finer
        table folds down by summing groups of Td / T buckets."""
        table = np.asarray(table, np.float64)
        td = table.shape[1]
        if td != self.table_size:
            if td % self.table_size:
                raise ValueError(
                    "device table size %d does not fold into quality "
                    "table size %d" % (td, self.table_size))
            table = table.reshape(2, self.table_size,
                                  td // self.table_size).sum(axis=2)
        with self._lock:
            tab, sc = self._tag_state_locked(tag)
            tab += table
            sc += (float(abserr), float(sqrerr), float(pred_sum),
                   float(click_sum), float(n))

    def add_batch(self, tensors: Dict[str, np.ndarray]) -> None:
        """The trainer's feed (its _add_metrics tensors): the 'all' stream,
        'cmatch:<id>' tags from the high 32 bits of a cmatch_rank column,
        and a 'task:<name>' stream a pred_<name> / label_<name> pair. A
        batch that is not CTR-shaped is skipped and counted
        (quality_batch_skipped, one warning), never raised."""
        pred = tensors.get("pred")
        label = tensors.get("label")
        if pred is None or label is None:
            return
        mask = tensors.get("mask")
        try:
            self.add(pred, label, tag=ALL_TAG, mask=mask)
            cm = tensors.get("cmatch_rank")
            if cm is not None:
                cmatch = (np.asarray(cm, np.uint64)
                          >> np.uint64(32)).astype(np.int64)
                if (cmatch != 0).any():
                    self.add_tagged(pred, label, cmatch, prefix="cmatch:",
                                    mask=mask)
            for k in tensors:
                if not k.startswith("pred_"):
                    continue
                task = k[len("pred_"):]
                tl = tensors.get("label_" + task)
                if tl is not None:
                    self.add(tensors[k], tl, tag="task:" + task, mask=mask)
        except ValueError as e:
            if stat_add("quality_batch_skipped") == 1:
                obs_log.warning(
                    "quality plane skipping non-CTR-shaped batches",
                    error=repr(e)[:200])

    # ------------------------------------------------------------ compute
    def _compute(self, tab: np.ndarray, sc: np.ndarray) -> dict:
        n = float(sc[self._S_N])
        click = float(sc[self._S_CLICK])
        pred_sum = float(sc[self._S_PRED])
        return {
            "auc": round(table_auc(tab), 6),
            "size": n,
            "actual_ctr": round(click / n, 6) if n else 0.0,
            "predicted_ctr": round(pred_sum / n, 6) if n else 0.0,
            "copc": round(click / pred_sum, 6) if pred_sum > 0 else 0.0,
            "mae": round(float(sc[self._S_ABSERR]) / n, 6) if n else 0.0,
            "rmse": round(math.sqrt(float(sc[self._S_SQRERR]) / n), 6)
            if n else 0.0,
        }

    def compute(self, tag: str = ALL_TAG) -> dict:
        """One tag's bundle; an unseen tag reads as the empty stream."""
        with self._lock:
            tab = self._tables.get(tag)
            if tab is None:
                tab = np.zeros((2, self.table_size), np.float64)
                sc = np.zeros(5, np.float64)
            else:
                tab = tab.copy()
                sc = self._scalars[tag].copy()
        return self._compute(tab, sc)

    def report(self, max_slots: int = 64) -> dict:
        """{"tags": {tag: bundle}, "slots": {slot: ctr bundle}}, the slots
        capped at ``max_slots``, the most instances first."""
        with self._lock:
            snap = {t: (self._tables[t].copy(), self._scalars[t].copy())
                    for t in self._tables}
            slot_click = self._slot_click.copy()
            slot_pred = self._slot_pred.copy()
            slot_n = self._slot_n.copy()
        tags = {t: self._compute(tab, sc)
                for t, (tab, sc) in sorted(snap.items())}
        slots = {}
        order = np.argsort(-slot_n)[:max_slots]
        for s in order.tolist():
            cnt = float(slot_n[s])
            if cnt <= 0:
                continue
            pred_sum = float(slot_pred[s])
            click = float(slot_click[s])
            slots[str(s)] = {
                "n": cnt,
                "actual_ctr": round(click / cnt, 6),
                "predicted_ctr": round(pred_sum / cnt, 6),
                "copc": round(click / pred_sum, 6)
                if pred_sum > 0 else 0.0,
            }
        out = {"tags": tags}
        if slots:
            out["slots"] = slots
        return out

    def publish_gauges(self) -> None:
        """The 'all' stream's auc and copc as the gauges quality_auc and
        quality_copc."""
        m = self.compute(ALL_TAG)
        if m["size"] > 0:
            gauge_set("quality_auc", m["auc"])
            gauge_set("quality_copc", m["copc"])

    # ------------------------------------------------------- state / merge
    def state(self) -> dict:
        """A JSON-safe, sum-mergeable snapshot: per tag the nonzero buckets
        as [idx, neg, pos] rows and the scalars; the slot accumulators."""
        with self._lock:
            tags = {}
            for t, tab in self._tables.items():
                nz = np.nonzero((tab[0] != 0) | (tab[1] != 0))[0]
                tags[t] = {
                    "nz": [[int(i), float(tab[0][i]), float(tab[1][i])]
                           for i in nz.tolist()],
                    "s": [float(x) for x in self._scalars[t]],
                }
            return {"v": STATE_VERSION, "table_size": self.table_size,
                    "tags": tags,
                    "slots": [self._slot_click.tolist(),
                              self._slot_pred.tolist(),
                              self._slot_n.tolist()]}

    def merge_state(self, state: dict) -> None:
        """Add another plane's state() into this one."""
        if int(state.get("table_size", self.table_size)) != self.table_size:
            raise ValueError("cannot merge quality states of different "
                             "table sizes (%s vs %d)"
                             % (state.get("table_size"), self.table_size))
        with self._lock:
            for t, st in (state.get("tags") or {}).items():
                tab, sc = self._tag_state_locked(t)
                for i, neg, pos in st.get("nz", ()):
                    tab[0][int(i)] += float(neg)
                    tab[1][int(i)] += float(pos)
                sc += np.asarray(st.get("s", [0.0] * 5), np.float64)
            slots = state.get("slots")
            if slots:
                click, pred, cnt = (np.asarray(a, np.float64)
                                    for a in slots)
                self._grow_slots_locked(click.size)
                self._slot_click[:click.size] += click
                self._slot_pred[:pred.size] += pred
                self._slot_n[:cnt.size] += cnt

    def reset(self) -> None:
        with self._lock:
            self._tables.clear()
            self._scalars.clear()
            self._slot_click = np.zeros(0, np.float64)
            self._slot_pred = np.zeros(0, np.float64)
            self._slot_n = np.zeros(0, np.float64)


def merged_report(states: Sequence[dict],
                  max_slots: int = 64) -> Optional[dict]:
    """The report of the sum of ``states``; a malformed or mismatched
    state is skipped; None when none merges."""
    merged: Optional[TaggedQuality] = None
    for st in states:
        if not st:
            continue
        try:
            if merged is None:
                merged = TaggedQuality(
                    table_size=int(st.get("table_size", 0)) or 1)
            merged.merge_state(st)
        except (ValueError, TypeError, KeyError):
            continue
    return merged.report(max_slots=max_slots) if merged is not None else None


# ------------------------------------------------------------- module API
# the live trainer's plane, for readers without a reference to the trainer
# (the reference's exporter); the last trainer built wins
_ACTIVE: Optional[TaggedQuality] = None


def active() -> Optional[TaggedQuality]:
    return _ACTIVE


def set_active(q: Optional[TaggedQuality]) -> Optional[TaggedQuality]:
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, q
    return prev


def attach_pass_extras(extra: dict, quality: Optional[TaggedQuality],
                       ship_state: bool = False,
                       monitor: Optional["_drift.SlotDriftMonitor"] = None
                       ) -> dict:
    """The pass_end record's extras: the quality gauges published (before
    the record is assembled, so it carries them), the quality report (and
    with ``ship_state`` the raw state), and the drift ``monitor``'s window
    rolled into ``data_quality``. The reference rolls its one
    process-wide monitor; the port rolls the trainer's own."""
    if quality is not None:
        quality.publish_gauges()
        extra["quality"] = quality.report()
        if ship_state:
            extra["quality_state"] = quality.state()
    dq = _drift.roll_gauges(monitor)
    if dq is not None:
        extra["data_quality"] = dq
    return extra


def make_from_flags(flags) -> Optional[TaggedQuality]:
    """An ObsFlags-configured plane (None when quality_metrics is off),
    made the active one."""
    q = (TaggedQuality(flags.quality_table_size)
         if flags.quality_metrics else None)
    set_active(q)
    return q
