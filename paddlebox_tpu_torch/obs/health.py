"""The cluster health plane: a score a rank, derived on rank 0 (a copy of
paddlebox_tpu/obs/health.py, the same record and penalties).

Each merged cluster_report window (obs/aggregate.py) folds into one score
a rank, published as a ``cluster_health`` record through the aggregator's
sink. A rank starts at 1.0 and loses

  * 0.4  stale this window (no report arrived since the last merge)
  * all  (score 0.0) stale ``stale_unhealthy`` windows in a row
  * 0.3  error log lines in the window (stats log_error_lines, and
         rpc_handler_errors)
  * 0.1  warning log lines (log_warning_lines)
  * 0.2  a channel or queue depth gauge (``*_depth``) above ``depth_warn``
  * 0.3  serving SLO burn above 1.0 (serving_slo_burn)
  * 0.6  beat age above ``beat_age_warn`` (beat_age_s: the rank reports
         but its step loop stopped beating)
  * 0.6  data-quality drift: data_drift_score at or past ``drift_warn``
  * 0.3  miscalibration: quality_copc outside ``copc_band``
  * 0.6  steady-state recompiles counted in the window
         (device_recompiles)
  * 0.6  donation misses counted in the window (donation_miss)
  * 0.4  freshness burn above 1.0 (serving_freshness_burn)
  * 0.3  tier-hit burn above 1.0 (tier_hit_burn)

and ``healthy`` is score >= 0.5. The names are the StatRegistry's: the
port's planes write log_*_lines (obs/log.py), rpc_handler_errors
(utils/rpc.py), beat_age_s (obs/report.py), data_drift_score
(metrics/drift.py), quality_copc (metrics/quality.py), device_recompiles
and donation_miss (obs/device.py) and tier_hit_burn (obs/watermark.py);
the serving gauges come with the serving slice. Staleness is telemetry
silence: a rank whose transport backs off reads stale, then unhealthy,
until its next publish lands, so a consumer acts on a sustained streak
(``stale_windows``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

SCHEMA_VERSION = 1


class HealthMonitor:
    """Rank-0 resident. Thread contract: ``update`` is called from the
    aggregation path only (the thread that runs the reporter)."""

    def __init__(self, world: int, stale_unhealthy: int = 2,
                 depth_warn: float = 64.0,
                 beat_age_warn: float = 30.0,
                 drift_warn: float = 0.5,
                 copc_band: tuple = (0.8, 1.25)) -> None:
        self.world = int(world)
        self.stale_unhealthy = int(stale_unhealthy)
        self.depth_warn = float(depth_warn)
        self.beat_age_warn = float(beat_age_warn)
        self.drift_warn = float(drift_warn)
        self.copc_band = (float(copc_band[0]), float(copc_band[1]))
        self._stale_windows: Dict[int, int] = {r: 0 for r in range(world)}
        self.last_health: Optional[dict] = None

    # ------------------------------------------------------------- helpers
    def _per_rank(self, merged: dict, metric: str) -> Dict[int, float]:
        m = (merged.get("metrics") or {}).get(metric)
        if not m:
            return {}
        return {int(r): float(v)
                for r, v in (m.get("per_rank") or {}).items()}

    # -------------------------------------------------------------- update
    def update(self, merged: dict) -> dict:
        """Fold one merged cluster_report window into per-rank health;
        returns the cluster_health record (also kept as last_health)."""
        stale = set(merged.get("stale_ranks") or [])
        err = self._per_rank(merged, "stats.log_error_lines")
        rpc_err = self._per_rank(merged, "stats.rpc_handler_errors")
        warn = self._per_rank(merged, "stats.log_warning_lines")
        beat_age = self._per_rank(merged, "gauges.beat_age_s")
        slo_burn = self._per_rank(merged, "gauges.serving_slo_burn")
        fresh_burn = self._per_rank(merged,
                                    "gauges.serving_freshness_burn")
        tier_burn = self._per_rank(merged, "gauges.tier_hit_burn")
        drift = self._per_rank(merged, "gauges.data_drift_score")
        copc = self._per_rank(merged, "gauges.quality_copc")
        recompiles = self._per_rank(merged, "stats.device_recompiles")
        donation = self._per_rank(merged, "stats.donation_miss")
        depths = {}
        for k, m in (merged.get("metrics") or {}).items():
            if (k.startswith("gauges.") and k.endswith("_depth")):
                for r, v in (m.get("per_rank") or {}).items():
                    depths[int(r)] = max(depths.get(int(r), 0.0), float(v))

        ranks = {}
        unhealthy: List[int] = []
        for r in range(self.world):
            if r in stale:
                self._stale_windows[r] = self._stale_windows.get(r, 0) + 1
            else:
                self._stale_windows[r] = 0
            sw = self._stale_windows[r]
            score = 1.0
            flags: List[str] = []
            if sw >= self.stale_unhealthy:
                score = 0.0
                flags.append("stale_%d_windows" % sw)
            elif sw:
                score -= 0.4
                flags.append("stale")
            n_err = err.get(r, 0.0) + rpc_err.get(r, 0.0)
            if n_err > 0:
                score -= 0.3
                flags.append("error_lines")
            if warn.get(r, 0.0) > 0:
                score -= 0.1
                flags.append("warning_lines")
            if depths.get(r, 0.0) > self.depth_warn:
                score -= 0.2
                flags.append("queue_depth")
            if slo_burn.get(r, 0.0) > 1.0:
                score -= 0.3
                flags.append("slo_burn")
            if fresh_burn.get(r, 0.0) > 1.0:
                # feed-to-serve freshness past its SLO: served
                # vectors are older than the promise — a stalled
                # journal tail, a wedged streaming runner, or a
                # refresh watcher that stopped swapping all land here
                score -= 0.4
                flags.append("freshness_burn")
            if tier_burn.get(r, 0.0) > 1.0:
                score -= 0.3
                flags.append("tier_hit_low")
            if beat_age.get(r, 0.0) > self.beat_age_warn:
                # reporting-but-not-beating: the wedge freshness can't
                # see — weighted past the 0.5 healthy bar on its own
                score -= 0.6
                flags.append("beat_stalled")
            if drift.get(r, 0.0) >= self.drift_warn:
                # slot-level data-quality drift (a dropped upstream
                # feature pipeline): weighted past the healthy bar on
                # its own — the victim rank must read unhealthy even
                # while every systems signal is green
                score -= 0.6
                flags.append("data_drift")
            c = copc.get(r)
            if c is not None and c > 0 and not (
                    self.copc_band[0] <= c <= self.copc_band[1]):
                score -= 0.3
                flags.append("miscalibrated")
            if recompiles.get(r, 0.0) > 0:
                # the device plane's sentinel: steady-state
                # recompiles stall every step for a full XLA compile —
                # past the healthy bar on its own
                score -= 0.6
                flags.append("device_recompiles")
            if donation.get(r, 0.0) > 0:
                # donation miss = the step silently pays a slab-sized
                # copy (the regime-step mechanism) — past the bar alone
                score -= 0.6
                flags.append("donation_miss")
            score = max(0.0, min(1.0, score))
            entry = {"score": round(score, 3),
                     "healthy": score >= 0.5,
                     "stale_windows": sw}
            if flags:
                entry["flags"] = flags
            if r in beat_age:
                entry["beat_age_s"] = round(beat_age[r], 3)
            if n_err:
                entry["err_lines"] = n_err
            if r in slo_burn:
                entry["slo_burn"] = round(slo_burn[r], 4)
            if r in fresh_burn:
                entry["freshness_burn"] = round(fresh_burn[r], 4)
            if r in tier_burn:
                entry["tier_hit_burn"] = round(tier_burn[r], 4)
            ranks[str(r)] = entry
            if not entry["healthy"]:
                unhealthy.append(r)

        rec = {"type": "cluster_health", "v": SCHEMA_VERSION,
               "ts": time.time(), "step": int(merged.get("step", 0)),
               "world": self.world, "ranks": ranks,
               "unhealthy_ranks": unhealthy}
        self.last_health = rec
        return rec
