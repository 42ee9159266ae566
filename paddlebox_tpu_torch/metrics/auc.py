"""Streaming metrics: the bucketed AUC, its cmatch-rank kinds, wuauc,
nan_inf and the continuous-label kind.

Counterpart of paddlebox_tpu/metrics/auc.py:29-685: the box
BasicAucCalculator (double-precision neg/pos bucket tables, trapezoid from
the top bucket down, bucket error with kRelativeErrorBound=0.05 and
kMaxSpan=0.01, the sample-scaled positive bucket, the user-weighted WuAUC
over (uid, pred, label) records, the NaN/inf share and the continuous-label
error sums), MetricMsg with its four kinds ('auc', 'wuauc', 'nan_inf',
'continue'), the join phase's CmatchRankMetricMsg (the AUC of the instances
whose (cmatch, rank) is in a group, or whose cmatch is, with
``ignore_rank``) and MultiTaskMetricMsg (each group pair's instances read
their own prediction), over the batch's ``cmatch_rank`` column
((cmatch << 32) | (rank & 0xff), data/packer.py), and MetricRegistry with
the join/update phase filter (``phase``, ``flip_phase``). Host numpy, as in
the JAX package; the trainer feeds it once a batch.

The reference's cross-worker ``allreduce`` argument waits for the sharded
trainer: every compute here is one process's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

from paddlebox_tpu_torch.utils.lockwatch import make_lock

_RELATIVE_ERROR_BOUND = 0.05  # kRelativeErrorBound
_MAX_SPAN = 0.01              # kMaxSpan


def trapezoid_auc(table: np.ndarray):
    """(auc, fp, tp) of a [2, T] neg/pos bucket table; auc = -0.5 for a
    one-class or empty table."""
    neg_rev = table[0][::-1]
    pos_rev = table[1][::-1]
    fp_cum = np.cumsum(neg_rev)
    tp_cum = np.cumsum(pos_rev)
    tp_prev = tp_cum - pos_rev
    area = float(np.sum(neg_rev * (tp_prev + tp_cum) / 2.0))
    fp = float(fp_cum[-1]) if fp_cum.size else 0.0
    tp = float(tp_cum[-1]) if tp_cum.size else 0.0
    if fp < 1e-3 or tp < 1e-3:
        return -0.5, fp, tp
    return area / (fp * tp), fp, tp


class BasicAucCalculator:
    """Bucketed streaming AUC with box semantics. The add_* methods take
    numpy arrays and hold one lock (the reference's _table_mutex);
    compute snapshots under it, computes outside it and writes back under
    it, so a long compute never stalls the adds.

    ``mode_collect_in_device``: the caller accumulates the [2, table_size]
    bucket table on the device and merges it once a pass with
    ``add_bucket_stats``, instead of per-batch ``add_data``."""

    def __init__(self, table_size: int = 1 << 20,
                 mode_collect_in_device: bool = False) -> None:
        self._mode_collect_in_device = bool(mode_collect_in_device)
        self._lock = make_lock("BasicAucCalculator._lock")
        self._table_size = int(table_size)
        self.reset()

    @property
    def mode_collect_in_device(self) -> bool:
        return self._mode_collect_in_device

    @property
    def table_size(self) -> int:
        return self._table_size

    def reset(self) -> None:
        # _table[0] negatives per bucket, _table[1] positives
        self._table = np.zeros((2, self._table_size), dtype=np.float64)
        self._local_abserr = 0.0
        self._local_sqrerr = 0.0
        self._local_pred = 0.0
        self._local_label = 0.0
        self._local_total_num = 0.0
        self._auc = 0.0
        self._mae = 0.0
        self._rmse = 0.0
        self._actual_ctr = 0.0
        self._predicted_ctr = 0.0
        self._actual_value = 0.0
        self._predicted_value = 0.0
        self._bucket_error = 0.0
        self._size = 0.0
        self.reset_records()
        self.reset_nan_inf()

    def reset_records(self) -> None:
        """Drop the wuauc records. uids stay uint64 in chunk lists: as
        float64 two uids above 2**53 could merge."""
        self._wuauc_uids: List[np.ndarray] = []
        self._wuauc_labels: List[np.ndarray] = []
        self._wuauc_preds: List[np.ndarray] = []
        self._user_cnt = 0.0
        self._uauc = 0.0
        self._wuauc = 0.0

    def reset_nan_inf(self) -> None:
        self._nan_cnt = 0.0
        self._inf_cnt = 0.0
        self._nan_total = 0.0
        self._nan_inf_rate = 0.0

    # ------------------------------------------------------------------ add
    def add_data(self, pred, label, mask=None, sample_scale=None) -> None:
        """pred in [0, 1], label 0 or 1; ``mask`` selects rows;
        ``sample_scale`` weights the positive bucket's increment and
        nothing else (metrics.cc:49-63)."""
        pred = np.asarray(pred, dtype=np.float64).reshape(-1)
        label = np.asarray(label).reshape(-1).astype(np.int64)
        if mask is not None:
            keep = np.asarray(mask).reshape(-1).astype(bool)
            pred, label = pred[keep], label[keep]
            if sample_scale is not None:
                sample_scale = np.asarray(sample_scale).reshape(-1)[keep]
        if pred.size == 0:
            return
        if pred.min() < 0.0 or pred.max() > 1.0:
            raise ValueError("pred must lie in [0, 1]")
        if not np.all((label == 0) | (label == 1)):
            raise ValueError("label must be 0 or 1")
        pos = np.minimum((pred * self._table_size).astype(np.int64),
                         self._table_size - 1)
        with self._lock:
            np.add.at(self._table[0], pos[label == 0], 1.0)
            if sample_scale is None:
                np.add.at(self._table[1], pos[label == 1], 1.0)
            else:
                scale = np.asarray(sample_scale, np.float64).reshape(-1)
                np.add.at(self._table[1], pos[label == 1], scale[label == 1])
            self._local_abserr += float(np.abs(pred - label).sum())
            self._local_sqrerr += float(((pred - label) ** 2).sum())
            self._local_pred += float(pred.sum())
            self._local_label += float(label.sum())
            self._local_total_num += float(pred.size)

    def add_float_data(self, pred, label, mask=None) -> None:
        """A continuous label: the error sums only, no buckets."""
        pred = np.asarray(pred, dtype=np.float64).reshape(-1)
        label = np.asarray(label, dtype=np.float64).reshape(-1)
        if mask is not None:
            keep = np.asarray(mask).reshape(-1).astype(bool)
            pred, label = pred[keep], label[keep]
        with self._lock:
            self._local_abserr += float(np.abs(pred - label).sum())
            self._local_sqrerr += float(((pred - label) ** 2).sum())
            self._local_pred += float(pred.sum())
            self._local_label += float(label.sum())
            self._local_total_num += float(pred.size)

    def add_bucket_stats(self, table: np.ndarray, abserr: float,
                         sqrerr: float, pred_sum: float, label_sum: float,
                         n: float) -> None:
        """Merge a bucket table accumulated elsewhere (table[0] negatives,
        table[1] positives, [2, table_size]) and its scalar sums."""
        table = np.asarray(table, dtype=np.float64)
        if table.shape != (2, self._table_size):
            raise ValueError("bucket table shape %s != (2, %d)"
                             % (table.shape, self._table_size))
        with self._lock:
            self._table += table
            self._local_abserr += float(abserr)
            self._local_sqrerr += float(sqrerr)
            self._local_pred += float(pred_sum)
            self._local_label += float(label_sum)
            self._local_total_num += float(n)

    def add_nan_inf_data(self, pred) -> None:
        pred = np.asarray(pred, dtype=np.float64).reshape(-1)
        with self._lock:
            self._nan_cnt += float(np.isnan(pred).sum())
            self._inf_cnt += float(np.isinf(pred).sum())
            self._nan_total += float(pred.size)

    def add_uid_data(self, pred, label, uid, mask=None) -> None:
        """add_data, and the (uid, label, pred) records wuauc reads."""
        pred = np.asarray(pred, dtype=np.float64).reshape(-1)
        label = np.asarray(label).reshape(-1).astype(np.int64)
        uid = np.asarray(uid).reshape(-1).astype(np.uint64)
        if mask is not None:
            keep = np.asarray(mask).reshape(-1).astype(bool)
            pred, label, uid = pred[keep], label[keep], uid[keep]
        self.add_data(pred, label)
        with self._lock:
            self._wuauc_uids.append(uid)
            self._wuauc_labels.append(label)
            self._wuauc_preds.append(pred)

    # -------------------------------------------------------------- compute
    def compute(self) -> None:
        with self._lock:
            table = self._table.copy()
            local = (self._local_abserr, self._local_sqrerr,
                     self._local_pred)
        auc, fp, tp = trapezoid_auc(table)
        bucket_error = self._calculate_bucket_error(table[0], table[1])
        total = fp + tp
        with self._lock:
            self._auc = auc
            if total > 0:
                self._mae = local[0] / total
                self._rmse = math.sqrt(local[1] / total)
                self._predicted_ctr = local[2] / total
                self._actual_ctr = tp / total
            self._size = total
            self._bucket_error = bucket_error

    def _calculate_bucket_error(self, neg_table: np.ndarray,
                                pos_table: np.ndarray) -> float:
        """metrics.cc:345-380 as a walk over the non-empty buckets; empty
        buckets act only through the span-reset cascade on last_ctr, which
        is advanced arithmetically between them."""
        n = self._table_size
        nz = np.nonzero((neg_table != 0) | (pos_table != 0))[0]
        if nz.size == 0:
            return 0.0
        last_ctr = -1.0
        impression_sum = ctr_sum = click_sum = 0.0
        error_sum = error_count = 0.0
        prev = -1
        for i in nz.tolist():
            j = prev + 1
            while j < i:
                cand = max(int((last_ctr + _MAX_SPAN) * n), j)
                while cand < i and cand / n - last_ctr <= _MAX_SPAN:
                    cand += 1
                if cand >= i:
                    break
                last_ctr = cand / n
                impression_sum = ctr_sum = click_sum = 0.0
                j = cand + 1
            click = float(pos_table[i])
            show = float(neg_table[i] + pos_table[i])
            ctr = i / n
            if abs(ctr - last_ctr) > _MAX_SPAN:
                last_ctr = ctr
                impression_sum = ctr_sum = click_sum = 0.0
            impression_sum += show
            ctr_sum += ctr * show
            click_sum += click
            prev = i
            if impression_sum <= 0:
                continue
            adjust_ctr = ctr_sum / impression_sum
            if adjust_ctr <= 0:
                continue
            relative_error = math.sqrt((1 - adjust_ctr)
                                       / (adjust_ctr * impression_sum))
            if relative_error < _RELATIVE_ERROR_BOUND:
                actual_ctr = click_sum / impression_sum
                error_sum += abs(actual_ctr / adjust_ctr - 1) * impression_sum
                error_count += impression_sum
                last_ctr = -1.0
        return error_sum / error_count if error_count > 0 else 0.0

    def compute_wuauc(self) -> None:
        """metrics.cc:472-556: each user's AUC, their mean (uauc) and their
        mean weighted by the user's instances (wuauc). Sorted by uid asc,
        pred desc, label asc; a user's tie groups are equal preds."""
        with self._lock:
            if not self._wuauc_uids:
                return
            uids = np.concatenate(self._wuauc_uids)
            labels = np.concatenate(self._wuauc_labels).astype(np.int64)
            preds = np.concatenate(self._wuauc_preds).astype(np.float64)
            order = np.lexsort((labels, -preds, uids))
            uids, labels, preds = uids[order], labels[order], preds[order]
            self._user_cnt = 0.0
            self._uauc = 0.0
            self._wuauc = 0.0
            self._size = 0.0
            boundaries = np.nonzero(np.diff(uids))[0] + 1
            for lab, prd in zip(np.split(labels, boundaries),
                                np.split(preds, boundaries)):
                tp, fp, auc = self._single_user_auc(lab, prd)
                if auc != -1:
                    ins_num = tp + fp
                    self._user_cnt += 1
                    self._size += ins_num
                    self._uauc += auc
                    self._wuauc += auc * ins_num
            if self._user_cnt > 0:
                self._uauc /= self._user_cnt
            if self._size > 0:
                self._wuauc /= self._size

    @staticmethod
    def _single_user_auc(labels: np.ndarray, preds: np.ndarray):
        """(tp, fp, auc) of one user's records sorted by pred desc, ties
        grouped by equal pred (metrics.cc:520-556); auc -1 for a
        one-class user."""
        change = np.nonzero(np.diff(preds))[0] + 1
        tp = fp = 0.0
        area = 0.0
        for grp_lab in np.split(labels, change):
            newtp = tp + float((grp_lab == 1).sum())
            newfp = fp + float((grp_lab != 1).sum())
            area += (newfp - fp) * (tp + newtp) / 2.0
            tp, fp = newtp, newfp
        if tp > 0 and fp > 0:
            return tp, fp, area / (fp * tp + 1e-9)
        return tp, fp, -1

    def compute_nan_inf(self) -> None:
        """computeNanInfMsg: the share of NaN and inf predictions."""
        with self._lock:
            nan_cnt, inf_cnt, total = (self._nan_cnt, self._inf_cnt,
                                       self._nan_total)
        rate = (nan_cnt + inf_cnt) / total if total else 0.0
        with self._lock:
            self._nan_inf_rate = rate

    def compute_continue_msg(self) -> None:
        """computeContinueMsg: the error sums over the record count, not
        the buckets' mass."""
        with self._lock:
            v = (self._local_abserr, self._local_sqrerr, self._local_pred,
                 self._local_label, self._local_total_num)
        total = v[4]
        with self._lock:
            if total > 0:
                self._mae = v[0] / total
                self._rmse = math.sqrt(v[1] / total)
                self._predicted_value = v[2] / total
                self._actual_value = v[3] / total
            self._size = total

    # ------------------------------------------------------------ accessors
    def auc(self) -> float:
        return self._auc

    def mae(self) -> float:
        return self._mae

    def rmse(self) -> float:
        return self._rmse

    def actual_ctr(self) -> float:
        return self._actual_ctr

    def predicted_ctr(self) -> float:
        return self._predicted_ctr

    def bucket_error(self) -> float:
        return self._bucket_error

    def size(self) -> float:
        return self._size

    def uauc(self) -> float:
        return self._uauc

    def wuauc(self) -> float:
        return self._wuauc

    def user_cnt(self) -> float:
        return self._user_cnt

    def nan_inf_rate(self) -> float:
        return self._nan_inf_rate

    def actual_value(self) -> float:
        return self._actual_value

    def predicted_value(self) -> float:
        return self._predicted_value


METRIC_KINDS = ("auc", "wuauc", "nan_inf", "continue")


class MetricMsg:
    """One named metric bound to (label, pred[, mask, uid, sample scale])
    tensor names and a training phase (-1: every phase). ``kind``: 'auc'
    (the bucketed AUC, weighted by ``sample_scale_var`` when named),
    'wuauc' (per-user AUC over ``uid_var``), 'nan_inf' (the share of
    non-finite predictions) or 'continue' (error sums of a continuous
    label)."""

    def __init__(self, label_var: str, pred_var: str, name: str,
                 metric_phase: int = -1, table_size: int = 1 << 20,
                 mask_var: str = "", uid_var: str = "",
                 sample_scale_var: str = "", kind: str = "auc",
                 mode_collect_in_device: bool = False) -> None:
        if kind not in METRIC_KINDS:
            raise ValueError("metric kind must be one of %s, got %r"
                             % (METRIC_KINDS, kind))
        self.name = name
        self.label_var = label_var
        self.pred_var = pred_var
        self.mask_var = mask_var
        self.uid_var = uid_var
        self.sample_scale_var = sample_scale_var
        self.metric_phase = metric_phase
        self.kind = kind
        self.calculator = BasicAucCalculator(table_size,
                                             mode_collect_in_device)

    def add_from(self, tensors: Dict[str, np.ndarray]) -> None:
        pred = tensors[self.pred_var]
        label = tensors[self.label_var]
        mask = tensors.get(self.mask_var) if self.mask_var else None
        c = self.calculator
        if self.kind == "wuauc" and self.uid_var:
            c.add_uid_data(pred, label, tensors[self.uid_var], mask)
        elif self.kind == "nan_inf":
            c.add_nan_inf_data(pred)
        elif self.kind == "continue":
            c.add_float_data(pred, label, mask)
        elif self.sample_scale_var:
            c.add_data(pred, label, mask, tensors.get(self.sample_scale_var))
        else:
            c.add_data(pred, label, mask)

    def get_msg(self) -> Dict[str, float]:
        c = self.calculator
        if self.kind == "wuauc":
            c.compute_wuauc()
            return {"user_cnt": c.user_cnt(), "size": c.size(),
                    "uauc": c.uauc(), "wuauc": c.wuauc()}
        if self.kind == "nan_inf":
            c.compute_nan_inf()
            return {"nan_inf_rate": c.nan_inf_rate()}
        if self.kind == "continue":
            c.compute_continue_msg()
            return {"mae": c.mae(), "rmse": c.rmse(), "size": c.size(),
                    "actual_value": c.actual_value(),
                    "predicted_value": c.predicted_value()}
        c.compute()
        return {"auc": c.auc(), "bucket_error": c.bucket_error(),
                "mae": c.mae(), "rmse": c.rmse(),
                "actual_ctr": c.actual_ctr(),
                "predicted_ctr": c.predicted_ctr(), "size": c.size()}


def parse_cmatch_rank(x) -> Tuple[np.ndarray, np.ndarray]:
    """(cmatch, rank) as int64 of a cmatch_rank column: the high 32 bits
    and the low 8."""
    x = np.asarray(x, np.uint64)
    return ((x >> np.uint64(32)).astype(np.int64),
            (x & np.uint64(0xFF)).astype(np.int64))


def _parse_group(cmatch_rank_group: str,
                 ignore_rank: bool) -> List[Tuple[int, int]]:
    """'222_1,223_2' -> [(222, 1), (223, 2)], comma or space separated;
    with ``ignore_rank`` a bare cmatch '222' is (222, 0)."""
    pairs = []
    for tok in cmatch_rank_group.replace(",", " ").split():
        if ignore_rank and "_" not in tok:
            pairs.append((int(tok), 0))
            continue
        parts = tok.split("_")
        if len(parts) != 2:
            raise ValueError("illegal cmatch_rank spec: %r" % (tok,))
        pairs.append((int(parts[0]), int(parts[1])))
    return pairs


class CmatchRankMetricMsg(MetricMsg):
    """The AUC of the instances whose (cmatch, rank) is one of the group's
    pairs (whose cmatch is, with ``ignore_rank``), and valid under
    ``mask_var``."""

    def __init__(self, label_var: str, pred_var: str, name: str,
                 cmatch_rank_group: str, cmatch_rank_var: str = "cmatch_rank",
                 ignore_rank: bool = False, metric_phase: int = -1,
                 table_size: int = 1 << 20, mask_var: str = "") -> None:
        super().__init__(label_var, pred_var, name, metric_phase,
                         table_size, mask_var=mask_var)
        self.cmatch_rank_var = cmatch_rank_var
        self.ignore_rank = ignore_rank
        self.pairs = _parse_group(cmatch_rank_group, ignore_rank)

    def match_mask(self, tensors: Dict[str, np.ndarray]) -> np.ndarray:
        """The instances of the group, before the mask."""
        cmatch, rank = parse_cmatch_rank(tensors[self.cmatch_rank_var])
        sel = np.zeros(cmatch.shape, bool)
        for cm, rk in self.pairs:
            if self.ignore_rank:
                sel |= cmatch == cm
            else:
                sel |= (cmatch == cm) & (rank == rk)
        return sel

    def add_from(self, tensors: Dict[str, np.ndarray]) -> None:
        sel = self.match_mask(tensors)
        if self.mask_var:
            sel &= np.asarray(tensors[self.mask_var]) != 0
        if sel.any():
            self.calculator.add_data(np.asarray(tensors[self.pred_var])[sel],
                                     np.asarray(tensors[self.label_var])[sel])


class MultiTaskMetricMsg(MetricMsg):
    """One AUC fed from another prediction for each group pair: an
    instance matching pairs[j] (the first pair it matches) adds
    pred_list[j] at it."""

    def __init__(self, label_var: str,
                 pred_var_list: Union[str, Sequence[str]], name: str,
                 cmatch_rank_group: str, cmatch_rank_var: str = "cmatch_rank",
                 metric_phase: int = -1, table_size: int = 1 << 20,
                 mask_var: str = "") -> None:
        preds = (pred_var_list.split() if isinstance(pred_var_list, str)
                 else list(pred_var_list))
        super().__init__(label_var, preds[0], name, metric_phase,
                         table_size, mask_var=mask_var)
        self.pred_list = preds
        self.cmatch_rank_var = cmatch_rank_var
        self.pairs = _parse_group(cmatch_rank_group, ignore_rank=False)
        if len(self.pairs) != len(self.pred_list):
            raise ValueError("cmatch_rank group size %d != pred list size %d"
                             % (len(self.pairs), len(self.pred_list)))

    def add_from(self, tensors: Dict[str, np.ndarray]) -> None:
        cmatch, rank = parse_cmatch_rank(tensors[self.cmatch_rank_var])
        label = np.asarray(tensors[self.label_var])
        base = (np.asarray(tensors[self.mask_var]) != 0 if self.mask_var
                else np.ones(label.shape, bool))
        taken = np.zeros(label.shape, bool)
        for (cm, rk), pv in zip(self.pairs, self.pred_list):
            sel = (cmatch == cm) & (rank == rk) & base & ~taken
            taken |= sel
            if sel.any():
                self.calculator.add_data(np.asarray(tensors[pv])[sel],
                                         label[sel])


class MetricRegistry:
    """Name -> MetricMsg with the join/update phase filter: a batch feeds
    the metrics whose metric_phase is -1 or the registry's ``phase``, or
    every metric while ``phase`` is -1 (the default)."""

    def __init__(self) -> None:
        self._metrics: Dict[str, MetricMsg] = {}
        self.phase = -1

    def init_metric(self, name: str, label_var: str, pred_var: str,
                    metric_phase: int = -1, table_size: int = 1 << 20,
                    **kwargs) -> MetricMsg:
        """A MetricMsg; ``kwargs`` are its mask_var, uid_var,
        sample_scale_var, kind and mode_collect_in_device."""
        msg = MetricMsg(label_var, pred_var, name, metric_phase, table_size,
                        **kwargs)
        self._metrics[name] = msg
        return msg

    def init_cmatch_rank_metric(self, name: str, label_var: str,
                                pred_var: str, cmatch_rank_group: str,
                                cmatch_rank_var: str = "cmatch_rank",
                                ignore_rank: bool = False,
                                metric_phase: int = -1,
                                table_size: int = 1 << 20,
                                mask_var: str = "") -> MetricMsg:
        msg = CmatchRankMetricMsg(label_var, pred_var, name,
                                  cmatch_rank_group, cmatch_rank_var,
                                  ignore_rank, metric_phase, table_size,
                                  mask_var)
        self._metrics[name] = msg
        return msg

    def init_multi_task_metric(self, name: str, label_var: str,
                               pred_var_list, cmatch_rank_group: str,
                               cmatch_rank_var: str = "cmatch_rank",
                               metric_phase: int = -1,
                               table_size: int = 1 << 20,
                               mask_var: str = "") -> MetricMsg:
        msg = MultiTaskMetricMsg(label_var, pred_var_list, name,
                                 cmatch_rank_group, cmatch_rank_var,
                                 metric_phase, table_size, mask_var)
        self._metrics[name] = msg
        return msg

    def metric_names(self) -> List[str]:
        return list(self._metrics)

    def messages(self) -> List[MetricMsg]:
        return list(self._metrics.values())

    def get(self, name: str) -> MetricMsg:
        return self._metrics[name]

    def add_batch(self, tensors: Dict[str, np.ndarray]) -> None:
        for m in self._metrics.values():
            if m.metric_phase in (-1, self.phase) or self.phase == -1:
                m.add_from(tensors)

    def get_metric_msg(self, name: str) -> Dict[str, float]:
        return self._metrics[name].get_msg()

    def flip_phase(self) -> None:
        """Join <-> update: phase 0 becomes 1 and 1 becomes 0; any other
        phase stays."""
        self.phase = 1 - self.phase if self.phase in (0, 1) else self.phase
