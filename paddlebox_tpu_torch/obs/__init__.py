"""The trainer's telemetry plane (the single-process part of
paddlebox_tpu/obs/): the span tracer (``tracer``), StepReports through a
pluggable sink (``report``) and rank-prefixed log lines (``log``).
``make_step_reporter`` is the one call a trainer makes at construction;
the device plane, the flight recorder, the watchdog, the exporter and the
cluster aggregator are ROADMAP A14."""

from __future__ import annotations

from typing import Dict, Optional

from paddlebox_tpu_torch.config.flags import ObsFlags
from paddlebox_tpu_torch.obs import log  # noqa: F401
from paddlebox_tpu_torch.obs import tracer
from paddlebox_tpu_torch.obs.report import (JsonlSink, ListSink,  # noqa: F401
                                            MetricsSink, NullSink,
                                            StderrSink, StepReporter,
                                            make_sink)
from paddlebox_tpu_torch.obs.tracer import (SpanTracer,  # noqa: F401
                                            current_trace, get_tracer, span,
                                            step_trace_id, trace_ctx)


def make_step_reporter(rank: int = 0, timers: Optional[Dict] = None,
                       flags: Optional[ObsFlags] = None) -> StepReporter:
    """Set the tracer from ``flags`` (obs_trace, obs_trace_capacity) and
    build the reporter (obs_report_every, a sink from obs_report_path)
    (paddlebox_tpu/obs/__init__.py:86-101)."""
    flags = flags or ObsFlags()
    tracer.configure(flags.obs_trace, flags.obs_trace_capacity)
    return StepReporter(rank=rank, every=flags.obs_report_every,
                        sink=make_sink(flags.obs_report_path),
                        timers=timers)


def export_chrome_trace(path: Optional[str] = None, rank: int = 0) -> dict:
    """The span rings as chrome-tracing JSON (Perfetto-loadable)."""
    return get_tracer().export_chrome(path=path, pid=rank)
