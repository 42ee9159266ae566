"""The feed-to-serve watermark plane: freshness lineage and the tier ladder
(paddlebox_tpu/obs/watermark.py:50-145, the same stat and gauge names).

  * data/streaming.py stamps each micro-pass window with its source files'
    mtime span (``born_min_ts``, ``born_ts``);
  * train/streaming_runner.py hands the span to
    ``TouchedRowJournal.publish``, which writes a KIND_WATERMARK record just
    before the seal (utils/journal_format.py ``pack_watermark``);
  * a serving-side tailer (the reference's serving/refresh.py
    JournalDeltaSource reads the port's segments) tracks the newest applied
    ``born_max``, and a pull stamped with it feeds ``observe_freshness``.

The histogram observes milliseconds (``freshness_e2e_ms``: the registry's
power-of-two buckets start at 1, so seconds would fall into the first);
the gauges republish seconds. Everything here is telemetry and never
raises into the path it watches. ``ObsFlags.obs_watermark`` off stops the
publish's watermark record (the runner reads it); the burn bounds are
``freshness_slo_secs`` and ``tier_hit_rate_warn``, passed in or taken from
``ObsFlags()`` (defaults and env overrides).

The health plane that turns the burns into per-rank penalties
(obs/health.py) reads them across ranks and waits for ROADMAP A10.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

from paddlebox_tpu_torch.config.flags import ObsFlags
from paddlebox_tpu_torch.utils.stats import (StatRegistry, gauge_get,
                                             gauge_set, hist_observe,
                                             hist_percentile, stat_get)

#: the end-to-end freshness histogram (milliseconds)
FRESHNESS_HIST = "freshness_e2e_ms"


def enabled(flags: Optional[ObsFlags] = None) -> bool:
    """The plane's switch, ``obs_watermark`` of ``flags`` (ObsFlags())."""
    return bool((flags or ObsFlags()).obs_watermark)


def observe_freshness(watermark_ts: Optional[float],
                      now: Optional[float] = None) -> Optional[float]:
    """One freshness sample, ``now - watermark_ts`` seconds: observed into
    ``freshness_e2e_ms`` and republished as the gauges
    ``freshness_e2e_secs`` / ``_p50`` / ``_p99`` (process-cumulative
    percentiles). None when there is no watermark yet."""
    if not watermark_ts or watermark_ts <= 0.0:
        return None
    if now is None:
        now = time.time()
    fresh = max(0.0, float(now) - float(watermark_ts))
    hist_observe(FRESHNESS_HIST, fresh * 1e3)
    gauge_set("freshness_e2e_secs", fresh)
    counts = StatRegistry.instance().hist_counts(FRESHNESS_HIST)
    gauge_set("freshness_e2e_secs_p50", hist_percentile(counts, 0.50) / 1e3)
    gauge_set("freshness_e2e_secs_p99", hist_percentile(counts, 0.99) / 1e3)
    return fresh


def freshness_burn(counts_delta: Sequence[int],
                   slo_secs: Optional[float] = None) -> Optional[float]:
    """A report window's SLO burn: the p99 of its freshness histogram delta
    over ``slo_secs`` (``freshness_slo_secs``); > 1 is staler than the
    promise. None when the SLO is off or the window saw no sample."""
    slo = float(ObsFlags().freshness_slo_secs if slo_secs is None
                else slo_secs)
    if slo <= 0.0 or not counts_delta or sum(counts_delta) <= 0:
        return None
    return (hist_percentile(list(counts_delta), 0.99) / 1e3) / slo


def tier_hit_burn(hit_rate: float,
                  warn: Optional[float] = None) -> Optional[float]:
    """``warn / hit_rate`` (``tier_hit_rate_warn``): > 1 when the host-RAM
    hit rate fell below the floor. None when the floor is off."""
    w = float(ObsFlags().tier_hit_rate_warn if warn is None else warn)
    if w <= 0.0:
        return None
    return w / max(float(hit_rate), 1e-9)


#: the tiered store's hit ladder, fastest tier first: counter -> label.
#: The device slab holds the pass's whole working set by construction; the
#: host store's resident index, the SSD tier's promote (slice 19's
#: embedding/ssd_tier.py) and its prefetch, then creation
TIER_LADDER_COUNTERS = (
    ("sparse_keys_resident_hit", "host_ram_hit"),
    ("sparse_keys_faulted_in", "ssd_promote"),
    ("sparse_keys_prefetch_faulted", "ssd_prefetch"),
    ("sparse_keys_created", "miss_created"),
)


def tier_ladder() -> Dict[str, float]:
    """The cumulative tier hit ladder of this process: counts, each rung's
    fraction of all ladder traffic, the total, the last ``tier_hit_rate``
    and the p99 of ``ssd_promote_us``."""
    counts = {label: float(stat_get(name))
              for name, label in TIER_LADDER_COUNTERS}
    total = sum(counts.values())
    out: Dict[str, float] = dict(counts)
    for label, c in counts.items():
        out[label + "_frac"] = round(c / total, 4) if total else 0.0
    out["total"] = total
    out["tier_hit_rate"] = float(gauge_get("tier_hit_rate"))
    promote = StatRegistry.instance().hist_counts("ssd_promote_us")
    out["ssd_promote_p99_us"] = (hist_percentile(promote, 0.99)
                                 if promote else 0.0)
    return out


def freshness_snapshot() -> Dict[str, float]:
    """The freshness ladder from this process's registry: the last sample,
    its cumulative p50 and p99 (seconds) and the streaming lag gauges."""
    return {
        "freshness_e2e_secs": float(gauge_get("freshness_e2e_secs")),
        "freshness_e2e_secs_p50": float(gauge_get("freshness_e2e_secs_p50")),
        "freshness_e2e_secs_p99": float(gauge_get("freshness_e2e_secs_p99")),
        "streaming_ingest_lag_secs": float(
            gauge_get("streaming_ingest_lag_secs")),
        "streaming_publish_lag_secs": float(
            gauge_get("streaming_publish_lag_secs")),
        "serving_watermark_age_secs": float(
            gauge_get("serving_watermark_age_secs")),
    }
