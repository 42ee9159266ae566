"""Streaming bucketed AUC: the plain AUC and the cmatch-rank kinds.

Counterpart of paddlebox_tpu/metrics/auc.py:29-303, 466-685: the box
BasicAucCalculator (double-precision neg/pos bucket tables, trapezoid from
the top bucket down, bucket error with kRelativeErrorBound=0.05 and
kMaxSpan=0.01), MetricMsg for the plain AUC kind, the join phase's
CmatchRankMetricMsg (the AUC of the instances whose (cmatch, rank) is in a
group, or whose cmatch is, with ``ignore_rank``) and MultiTaskMetricMsg
(each group pair's instances read their own prediction), over the batch's
``cmatch_rank`` column ((cmatch << 32) | (rank & 0xff), data/packer.py),
and MetricRegistry. Host numpy, as in the JAX package; the trainer feeds it
once per pass.

A metric's ``metric_phase`` other than -1 (all phases) is refused: the
join/update phase filter comes with the trainer's phases.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

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
    def __init__(self, table_size: int = 1 << 20) -> None:
        self._table_size = int(table_size)
        self.reset()

    def reset(self) -> None:
        self._table = np.zeros((2, self._table_size), dtype=np.float64)
        self._local_abserr = 0.0
        self._local_sqrerr = 0.0
        self._local_pred = 0.0
        self._auc = 0.0
        self._mae = 0.0
        self._rmse = 0.0
        self._actual_ctr = 0.0
        self._predicted_ctr = 0.0
        self._bucket_error = 0.0
        self._size = 0.0

    def add_data(self, pred, label, mask=None) -> None:
        pred = np.asarray(pred, dtype=np.float64).reshape(-1)
        label = np.asarray(label).reshape(-1).astype(np.int64)
        if mask is not None:
            keep = np.asarray(mask).reshape(-1).astype(bool)
            pred, label = pred[keep], label[keep]
        if pred.size == 0:
            return
        if pred.min() < 0.0 or pred.max() > 1.0:
            raise ValueError("pred must lie in [0, 1]")
        if not np.all((label == 0) | (label == 1)):
            raise ValueError("label must be 0 or 1")
        pos = np.minimum((pred * self._table_size).astype(np.int64),
                         self._table_size - 1)
        np.add.at(self._table[0], pos[label == 0], 1.0)
        np.add.at(self._table[1], pos[label == 1], 1.0)
        self._local_abserr += float(np.abs(pred - label).sum())
        self._local_sqrerr += float(((pred - label) ** 2).sum())
        self._local_pred += float(pred.sum())

    def compute(self) -> None:
        auc, fp, tp = trapezoid_auc(self._table)
        total = fp + tp
        self._auc = auc
        if total > 0:
            self._mae = self._local_abserr / total
            self._rmse = math.sqrt(self._local_sqrerr / total)
            self._predicted_ctr = self._local_pred / total
            self._actual_ctr = tp / total
        self._size = total
        self._bucket_error = self._calculate_bucket_error(self._table[0],
                                                          self._table[1])

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


class MetricMsg:
    """One named AUC metric bound to (label, pred[, mask]) tensor names."""

    def __init__(self, label_var: str, pred_var: str, name: str,
                 table_size: int = 1 << 20, mask_var: str = "") -> None:
        self.name = name
        self.label_var = label_var
        self.pred_var = pred_var
        self.mask_var = mask_var
        self.calculator = BasicAucCalculator(table_size)

    def add_from(self, tensors: Dict[str, np.ndarray]) -> None:
        mask = tensors.get(self.mask_var) if self.mask_var else None
        self.calculator.add_data(tensors[self.pred_var],
                                 tensors[self.label_var], mask)

    def get_msg(self) -> Dict[str, float]:
        c = self.calculator
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


def _check_phase(metric_phase: int) -> None:
    if metric_phase != -1:
        raise ValueError("metric_phase %r: the port's metrics run in every "
                         "phase (-1) until the trainer has phases"
                         % (metric_phase,))


class CmatchRankMetricMsg(MetricMsg):
    """The AUC of the instances whose (cmatch, rank) is one of the group's
    pairs (whose cmatch is, with ``ignore_rank``), and valid under
    ``mask_var``."""

    def __init__(self, label_var: str, pred_var: str, name: str,
                 cmatch_rank_group: str, cmatch_rank_var: str = "cmatch_rank",
                 ignore_rank: bool = False, metric_phase: int = -1,
                 table_size: int = 1 << 20, mask_var: str = "") -> None:
        _check_phase(metric_phase)
        super().__init__(label_var, pred_var, name, table_size, mask_var)
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
        _check_phase(metric_phase)
        preds = (pred_var_list.split() if isinstance(pred_var_list, str)
                 else list(pred_var_list))
        super().__init__(label_var, preds[0], name, table_size, mask_var)
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
    """Name -> MetricMsg (the join/update phase filter waits for the
    slices that train in phases)."""

    def __init__(self) -> None:
        self._metrics: Dict[str, MetricMsg] = {}

    def init_metric(self, name: str, label_var: str, pred_var: str,
                    table_size: int = 1 << 20,
                    mask_var: str = "") -> MetricMsg:
        msg = MetricMsg(label_var, pred_var, name, table_size, mask_var)
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

    def add_batch(self, tensors: Dict[str, np.ndarray]) -> None:
        for m in self._metrics.values():
            m.add_from(tensors)

    def get_metric_msg(self, name: str) -> Dict[str, float]:
        return self._metrics[name].get_msg()
