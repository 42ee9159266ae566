"""The trainer's telemetry plane (the single-process part of
paddlebox_tpu/obs/): the span tracer (``tracer``), StepReports through a
pluggable sink (``report``), rank-prefixed log lines (``log``), the device
plane (``device``: the step entry points' signature sentinel and donation
audit, the transfer ledger, the HBM ledger), the flight recorder
(``flight``), the stall watchdog (``watchdog``), the ops endpoint
(``exporter``: /metrics and the JSON views) and the feed-to-serve
watermark plane (``watermark``). ``make_step_reporter`` is the one call a
trainer makes at construction. The cluster aggregator and the health plane
(the reference's aggregate.py and health.py) are wired only across ranks
and wait for ROADMAP A10."""

from __future__ import annotations

from typing import Dict, Optional

from paddlebox_tpu_torch.config.flags import ObsFlags
from paddlebox_tpu_torch.obs import device  # noqa: F401
from paddlebox_tpu_torch.obs import exporter, flight
from paddlebox_tpu_torch.obs import log  # noqa: F401
from paddlebox_tpu_torch.obs import tracer, watchdog
from paddlebox_tpu_torch.obs import watermark  # noqa: F401
from paddlebox_tpu_torch.obs.device import (account_d2h,  # noqa: F401
                                            account_h2d, instrument_step)
from paddlebox_tpu_torch.obs.flight import FlightRecorder  # noqa: F401
from paddlebox_tpu_torch.obs.report import (JsonlSink, ListSink,  # noqa: F401
                                            MetricsSink, NullSink,
                                            StderrSink, StepReporter,
                                            make_sink)
from paddlebox_tpu_torch.obs.tracer import (SpanTracer,  # noqa: F401
                                            current_trace, get_tracer, span,
                                            step_trace_id, trace_ctx)
from paddlebox_tpu_torch.obs.watchdog import StallWatchdog  # noqa: F401
from paddlebox_tpu_torch.obs.watchdog import beat  # noqa: F401


def make_step_reporter(rank: int = 0, timers: Optional[Dict] = None,
                       flags: Optional[ObsFlags] = None) -> StepReporter:
    """The tiers ``flags`` asks for, in the reference's order
    (paddlebox_tpu/obs/__init__.py:84-100): the tracer (obs_trace,
    obs_trace_capacity) and the device plane's switches, the flight
    recorder (obs_flight_dir), the reporter (obs_report_every, a sink from
    obs_report_path), the watchdog (obs_watchdog_secs) on the reporter's
    last record, then the ops endpoint (obs_http_port) bound to it."""
    flags = flags or ObsFlags()
    tracer.configure(flags.obs_trace, flags.obs_trace_capacity)
    device.configure(flags)
    flight.ensure_from_flags(flags, rank=rank)
    reporter = StepReporter(rank=rank, every=flags.obs_report_every,
                            sink=make_sink(flags.obs_report_path),
                            timers=timers)
    watchdog.ensure_from_flags(flags, tracer=get_tracer(),
                               report_fn=reporter.peek)
    exp = exporter.ensure_from_flags(flags, rank=rank)
    if exp is not None:
        exp.bind(reporter=reporter)
    return reporter


def export_chrome_trace(path: Optional[str] = None, rank: int = 0) -> dict:
    """The span rings as chrome-tracing JSON (Perfetto-loadable)."""
    return get_tracer().export_chrome(path=path, pid=rank)
