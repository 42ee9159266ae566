"""Per-batch eval plumbing shared by the single-table trainers.

Counterpart of paddlebox_tpu/train/eval_driver.py: the host metric feed of
one batch, and the test-mode inference cadence that always closes its pass,
so a mid-eval error cannot leave the table's pass open (every later
train_pass would fail). BoxTrainer.predict_batches is the reference's
variant without that guard.
"""

from __future__ import annotations

import numpy as np


def feed_simple_metrics(metrics, preds, b) -> None:
    """Stream one batch's [B] predictions into a MetricRegistry
    (Metric::add_data role)."""
    if not metrics.metric_names():
        return
    metrics.add_batch({"pred": np.asarray(preds), "label": b.labels,
                       "mask": b.ins_valid})


def simple_predict_batches(trainer, dataset):
    """Test-mode inference (SetTestMode: no creation, no push) over a
    per-batch trainer (one with ``table`` and ``eval_batch``): (preds,
    labels) of the dataset's valid instances, loading the dataset first
    when it is empty. The pass is closed and test mode left on every
    exit."""
    table = trainer.table
    table.set_test_mode(True)
    opened = False
    try:
        table.begin_feed_pass()
        if len(dataset) == 0:
            dataset.load_into_memory()
        table.add_keys(dataset.all_keys())
        table.end_feed_pass()
        table.begin_pass()
        opened = True
        preds_all, labels_all = [], []
        for b in dataset.split_batches(num_workers=1)[0]:
            preds = trainer.eval_batch(b).cpu().numpy()
            preds_all.append(preds[b.ins_valid])
            labels_all.append(b.labels[b.ins_valid])
    finally:
        if opened:
            table.end_pass()
        table.set_test_mode(False)
    if not preds_all:
        return np.empty(0, np.float32), np.empty(0, np.int32)
    return np.concatenate(preds_all), np.concatenate(labels_all)
