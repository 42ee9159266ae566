"""Streaming metrics (metrics/auc.py), the per-tag quality plane
(metrics/quality.py) and the slot drift monitor (metrics/drift.py); the
reference's package-level names (paddlebox_tpu/metrics/__init__.py)."""

from paddlebox_tpu_torch.metrics.auc import (BasicAucCalculator, MetricMsg,
                                             MetricRegistry)

__all__ = ["BasicAucCalculator", "MetricMsg", "MetricRegistry"]
