"""The ops endpoint of one rank: the live read surface of the obs plane
(paddlebox_tpu/obs/exporter.py, the same paths and JSON schemas).

Served by stdlib ``http.server`` on 127.0.0.1 at ``ObsFlags.obs_http_port``
+ rank (0 off):

  /metrics  Prometheus text exposition 0.0.4 of the StatRegistry's
            counters, gauges and histograms (cumulative ``_bucket{le=...}``
            series and p50/p90/p99 gauges), the quality plane's per-tag and
            per-slot series and the drift monitor's last window; every
            family ``pbtpu_<name>``, one TYPE line each
  /report   the last StepReport (the reporter's ``peek``), and on rank 0
            of a multi-rank job the last merged cluster_report
  /health   on rank 0 of a multi-rank job the health plane's last merged
            cluster_health record (reached through the bound reporter's
            aggregator); elsewhere this rank's liveness record. Either
            carries the serving fleet's record as ``serving_fleet`` while
            a process-wide provider is set (``set_fleet_health_provider``)
  /stacks   every thread's stack, plain text
  /flight   the flight recorder's segments and the tail of the newest
  /quality  the quality plane's report and the drift monitor's snapshot
  /device   the device plane's snapshot (obs/device.py)

Every handler answers from copies (the registry's snapshot_all, the
reporter's peek, the planes' own short locks) and takes no training lock,
so a scrape slows scrapes, never a step. A port that cannot be bound warns
and leaves the endpoint off.
"""

from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from paddlebox_tpu_torch.config.flags import ObsFlags
from paddlebox_tpu_torch.utils.lockwatch import make_lock

SCHEMA_VERSION = 1

#: the Prometheus text exposition's content type
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# the serving fleet's /health section (reference exporter.py:55-78): the
# process that runs a serving fleet registers a zero-argument callable
# giving its fleet-wide record; /health folds it in and still answers when
# the provider raises
_fleet_health_lock = make_lock("exporter._fleet_health_lock")
_fleet_health_provider = None  # guarded-by: _fleet_health_lock


def set_fleet_health_provider(provider) -> None:
    """Register the serving fleet's /health section, or clear it with
    None. One provider a process: the last registration wins."""
    global _fleet_health_provider
    with _fleet_health_lock:
        _fleet_health_provider = provider


def _fleet_health_section() -> Optional[dict]:
    """The provider's record; ``{"type": "serving_fleet", "error": ...}``
    where it raises; None without a provider."""
    with _fleet_health_lock:
        provider = _fleet_health_provider
    if provider is None:
        return None
    try:
        return provider()
    except Exception as e:  # the endpoint answers through a fleet's error
        return {"type": "serving_fleet", "error": repr(e)}


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return "pbtpu_" + _NAME_RE.sub("_", str(name))


def render_prometheus(snap: dict, rank: int,
                      quality: Optional[dict] = None,
                      drift: Optional[dict] = None) -> str:
    """A registry snapshot_all and the quality / drift snapshots as
    Prometheus text."""
    from paddlebox_tpu_torch.utils.stats import HIST_BOUNDS, hist_percentile
    lines = ["# pbtpu ops exporter v%d rank=%d ts=%.3f"
             % (SCHEMA_VERSION, rank, time.time())]
    # one TYPE line a family: a second one is a parse error to a scraper
    typed = set()

    def typ(name: str, kind: str) -> None:
        if name not in typed:
            typed.add(name)
            lines.append("# TYPE %s %s" % (name, kind))

    # the families the quality and drift sections render richer: their
    # plain registry gauges are left out, so each family appears once
    owned = set()
    if quality:
        owned |= {"quality_auc", "quality_copc"}
    if drift and drift.get("last"):
        owned |= {"data_drift_score", "data_dropped_slots"}
    for k in sorted(snap.get("counters") or {}):
        n = _prom_name(k)
        typ(n, "counter")
        lines.append("%s %d" % (n, int(snap["counters"][k])))
    for k in sorted(snap.get("gauges") or {}):
        if k in owned:
            continue
        n = _prom_name(k)
        typ(n, "gauge")
        lines.append("%s %.9g" % (n, float(snap["gauges"][k])))
    for k in sorted(snap.get("hists") or {}):
        counts = snap["hists"][k]
        n = _prom_name(k)
        typ(n, "histogram")
        cum = 0
        for i, c in enumerate(counts):
            cum += int(c)
            le = ("+Inf" if i >= len(HIST_BOUNDS)
                  else "%g" % HIST_BOUNDS[i])
            lines.append('%s_bucket{le="%s"} %d' % (n, le, cum))
        lines.append("%s_count %d" % (n, cum))
        for q, tag in ((0.50, "p50"), (0.90, "p90"), (0.99, "p99")):
            typ("%s_%s" % (n, tag), "gauge")
            lines.append("%s_%s %.9g" % (n, tag,
                                         hist_percentile(counts, q)))
    if quality:
        for metric in ("auc", "copc", "actual_ctr", "predicted_ctr",
                       "size"):
            n = "pbtpu_quality_" + metric
            first = True
            for tag in sorted(quality.get("tags") or {}):
                v = quality["tags"][tag].get(metric)
                if v is None:
                    continue
                if first:
                    typ(n, "gauge")
                    first = False
                lines.append('%s{tag="%s"} %.9g'
                             % (n, _NAME_RE.sub("_", tag), float(v)))
        slots = quality.get("slots") or {}
        if slots:
            for metric in ("actual_ctr", "predicted_ctr", "copc", "n"):
                n = "pbtpu_slot_" + metric
                typ(n, "gauge")
                for s in sorted(slots, key=int):
                    lines.append('%s{slot="%s"} %.9g'
                                 % (n, s, float(slots[s][metric])))
    if drift and drift.get("last"):
        last = drift["last"]
        d = last.get("drift") or {}
        for name, v in (("pbtpu_data_drift_score", d.get("score")),
                        ("pbtpu_data_dropped_slots",
                         len(d.get("dropped_slots") or ())),
                        ("pbtpu_data_window_recs", last.get("n_recs")),
                        ("pbtpu_data_label_rate", last.get("label_rate"))):
            if v is None:
                continue
            typ(name, "gauge")
            lines.append("%s %.9g" % (name, float(v)))
    return "\n".join(lines) + "\n"


class ObsExporter:
    """One rank's endpoint. Construction binds the port (OSError when it
    cannot; ``ensure_from_flags`` turns that into a warning); the serving
    threads are daemons."""

    def __init__(self, port: int, rank: int = 0,
                 host: str = "127.0.0.1") -> None:
        self.rank = int(rank)
        self.host = host
        self._reporter = None
        self._lock = make_lock("ObsExporter._lock")
        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: D401
                pass   # no access log on the run's stderr

            def do_GET(self):  # noqa: N802 (http.server's name)
                try:
                    exporter._route(self)
                except (BrokenPipeError, ConnectionResetError):
                    pass
                except Exception as e:  # noqa: BLE001 (degrade, never kill)
                    try:
                        exporter._send(self, 500, "text/plain",
                                       ("exporter error: %r" % e).encode())
                    except OSError:
                        pass

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.port = int(self._httpd.server_port)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="pbtpu-obs-http")
        self._thread.start()

    def bind(self, reporter=None) -> "ObsExporter":
        """Attach the live StepReporter (make_step_reporter does)."""
        with self._lock:
            if reporter is not None:
                self._reporter = reporter
        return self

    # ------------------------------------------------------------ handlers
    @staticmethod
    def _send(handler, code: int, ctype: str, body: bytes) -> None:
        handler.send_response(code)
        handler.send_header("Content-Type", ctype)
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)

    def _send_json(self, handler, obj, code: int = 200) -> None:
        self._send(handler, code, "application/json",
                   json.dumps(obj, default=repr).encode("utf-8"))

    def _route(self, handler) -> None:
        path = handler.path.split("?", 1)[0].rstrip("/") or "/"
        route = {"/metrics": self._metrics, "/report": self._report,
                 "/health": self._health, "/stacks": self._stacks,
                 "/flight": self._flight, "/quality": self._quality,
                 "/device": self._device}.get(path)
        if route is not None:
            return route(handler)
        if path == "/":
            return self._send_json(handler, {
                "rank": self.rank, "v": SCHEMA_VERSION,
                "endpoints": ["/metrics", "/report", "/health", "/stacks",
                              "/flight", "/quality", "/device"]})
        self._send_json(handler, {"error": "unknown path %s" % path},
                        code=404)

    def _reporter_now(self):
        with self._lock:
            return self._reporter

    def _metrics(self, handler) -> None:
        from paddlebox_tpu_torch.metrics import drift, quality
        from paddlebox_tpu_torch.utils.stats import StatRegistry
        q, dm = quality.active(), drift.active()
        text = render_prometheus(
            StatRegistry.instance().snapshot_all(), self.rank,
            quality=q.report() if q is not None else None,
            drift=dm.snapshot() if dm is not None else None)
        self._send(handler, 200, PROM_CONTENT_TYPE, text.encode("utf-8"))

    def _report(self, handler) -> None:
        rep = self._reporter_now()
        out = {"rank": self.rank,
               "report": rep.peek() if rep is not None else None}
        agg = getattr(rep, "aggregator", None)
        if agg is not None and agg.last_cluster_report is not None:
            out["cluster_report"] = agg.last_cluster_report
        self._send_json(handler, out)

    def _health(self, handler) -> None:
        rep = self._reporter_now()
        agg = getattr(rep, "aggregator", None)
        health = getattr(agg, "health", None) if agg is not None else None
        fleet = _fleet_health_section()
        if health is not None and health.last_health is not None:
            record = health.last_health
            if fleet is not None:
                record = dict(record, serving_fleet=fleet)
            return self._send_json(handler, record)
        last = rep.peek() if rep is not None else None
        record = {
            "type": "rank_liveness", "v": SCHEMA_VERSION,
            "rank": self.rank, "ts": time.time(),
            "last_report_step": (last or {}).get("step"),
            "last_report_ts": (last or {}).get("ts"),
            "note": "per-rank view; the merged cluster_health record "
                    "lives on rank 0's endpoint"}
        if fleet is not None:
            record["serving_fleet"] = fleet
        self._send_json(handler, record)

    def _stacks(self, handler) -> None:
        from paddlebox_tpu_torch.obs.flight import _thread_stacks
        lines = []
        for name, stack in sorted(_thread_stacks().items()):
            lines.append("== %s ==" % name)
            lines.extend(stack)
            lines.append("")
        self._send(handler, 200, "text/plain; charset=utf-8",
                   ("\n".join(lines) + "\n").encode("utf-8"))

    def _flight(self, handler, tail_lines: int = 64) -> None:
        from paddlebox_tpu_torch.obs import flight
        fr = flight.active()
        if fr is None:
            return self._send_json(handler, {"active": False})
        segs = fr.segments()
        tail = []
        if segs:
            try:
                with open(segs[-1], "r", encoding="utf-8",
                          errors="replace") as fh:
                    tail = fh.readlines()[-tail_lines:]
            except OSError:
                tail = []
        self._send_json(handler, {
            "active": True, "dir": fr.dir, "rank": fr.rank,
            "segments": segs, "tail": [ln.rstrip("\n") for ln in tail]})

    def _device(self, handler) -> None:
        from paddlebox_tpu_torch.obs import device
        out = device.snapshot()
        out["rank"] = self.rank
        self._send_json(handler, out)

    def _quality(self, handler) -> None:
        from paddlebox_tpu_torch.metrics import drift, quality
        q, dm = quality.active(), drift.active()
        self._send_json(handler, {
            "rank": self.rank,
            "quality": q.report() if q is not None else None,
            "drift": dm.snapshot() if dm is not None else None})

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)


# ------------------------------------------------------------- module API
_ACTIVE: Optional[ObsExporter] = None


def active() -> Optional[ObsExporter]:
    return _ACTIVE


def set_active(e: Optional[ObsExporter]) -> Optional[ObsExporter]:
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, e
    return prev


def close_active() -> None:
    """Close and clear the active endpoint, if any."""
    global _ACTIVE
    if _ACTIVE is not None:
        _ACTIVE.close()
        _ACTIVE = None


def ensure_from_flags(rank: int = 0, flags: Optional[ObsFlags] = None
                      ) -> Optional[ObsExporter]:
    """The endpoint ``flags.obs_http_port`` + rank asks for (0 closes and
    clears the active one); the same port and rank reuse it. A port that
    cannot be bound warns and returns None."""
    global _ACTIVE
    base = int((flags or ObsFlags()).obs_http_port)
    if base <= 0:
        close_active()
        return None
    port = base + int(rank)
    if (_ACTIVE is not None and _ACTIVE.port == port
            and _ACTIVE.rank == int(rank)):
        return _ACTIVE
    close_active()
    try:
        exp = ObsExporter(port, rank=rank)
    except OSError as e:
        from paddlebox_tpu_torch.obs import log as obs_log
        obs_log.warning("obs http exporter disabled: port unusable",
                        port=port, rank=rank, error=repr(e)[:200])
        return None
    _ACTIVE = exp
    return exp
