"""The trainer's telemetry plane (the single-process part of
paddlebox_tpu/obs/): the span tracer (``tracer``), StepReports through a
pluggable sink (``report``), rank-prefixed log lines (``log``), the device
plane (``device``: the step entry points' signature sentinel and donation
audit, the transfer ledger, the HBM ledger), the flight recorder
(``flight``), the stall watchdog (``watchdog``), the ops endpoint
(``exporter``: /metrics and the JSON views) and the feed-to-serve
watermark plane (``watermark``). ``make_step_reporter`` is the one call a
trainer makes at construction. Across ranks the cluster aggregator
(``aggregate``: the ranks' reports merged on rank 0 over the fleet's KV
store) and the health plane (``health``: a score a rank from each merged
window) join them; ``make_cluster_aggregator`` wires both for the sharded
trainer above world 1, and the rank-0 exporter's /health serves the
merged health record."""

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
from paddlebox_tpu_torch.obs.aggregate import (  # noqa: F401
    ClusterAggregator, StoreObsTransport, make_transport,
    merge_cluster_reports)
from paddlebox_tpu_torch.obs.flight import FlightRecorder  # noqa: F401
from paddlebox_tpu_torch.obs.health import HealthMonitor  # noqa: F401
from paddlebox_tpu_torch.obs.report import (JsonlSink, ListSink,  # noqa: F401
                                            MetricsSink, NullSink,
                                            StderrSink, StepReporter,
                                            make_sink)
from paddlebox_tpu_torch.obs.tracer import (SpanTracer,  # noqa: F401
                                            current_trace, get_tracer,
                                            next_trace_id, span,
                                            step_trace_id, trace_ctx)
from paddlebox_tpu_torch.obs.watchdog import StallWatchdog  # noqa: F401
from paddlebox_tpu_torch.obs.watchdog import beat  # noqa: F401


def make_step_reporter(rank: int = 0, timers: Optional[Dict] = None,
                       aggregator=None,
                       flags: Optional[ObsFlags] = None) -> StepReporter:
    """The tiers ``flags`` asks for, in the reference's order
    (paddlebox_tpu/obs/__init__.py:84-100): the tracer (obs_trace,
    obs_trace_capacity) and the device plane's switches, the flight
    recorder (obs_flight_dir), the reporter (obs_report_every, a sink from
    obs_report_path; each record then goes to ``aggregator``), the
    watchdog (obs_watchdog_secs) on the reporter's last record, then the
    ops endpoint (obs_http_port) bound to it."""
    flags = flags or ObsFlags()
    tracer.configure_from_flags(flags)
    device.configure(flags)
    flight.ensure_from_flags(rank, flags=flags)
    reporter = StepReporter(rank=rank, every=flags.obs_report_every,
                            sink=make_sink(flags.obs_report_path),
                            timers=timers, aggregator=aggregator)
    watchdog.ensure_from_flags(get_tracer(), flags=flags,
                               report_fn=reporter.peek)
    exp = exporter.ensure_from_flags(rank, flags=flags)
    if exp is not None:
        exp.bind(reporter=reporter)
    return reporter


def obs_rank_world(mesh=None, fleet=None):
    """(rank, world) in the space the transport addresses rank 0 in: the
    exchange's (MeshComm rank, world), else the fleet's (worker index,
    worker count), else (0, 1)."""
    if mesh is not None:
        return int(mesh.rank), int(mesh.world)
    if fleet is not None and getattr(fleet, "initialized", False):
        return int(fleet.worker_index()), int(fleet.worker_num())
    return 0, 1


def make_cluster_aggregator(fleet=None, rank: int = 0, world: int = 1,
                            flags: Optional[ObsFlags] = None):
    """The aggregator of a multi-rank job (reference obs/__init__.py:
    121-136): the fleet's store transport (aggregate.make_transport), and
    on rank 0 a sink from obs_report_path and a HealthMonitor over
    ``world`` ranks with data_quality_warn as its drift bar. None where
    there is no transport (one rank, no KV store)."""
    transport = make_transport(fleet=fleet)
    if transport is None:
        return None
    flags = flags or ObsFlags()
    sink = make_sink(flags.obs_report_path) if rank == 0 else None
    health = (HealthMonitor(world, drift_warn=float(flags.data_quality_warn))
              if rank == 0 else None)
    return ClusterAggregator(transport, rank, world, sink=sink,
                             health=health)


def export_chrome_trace(path: Optional[str] = None, rank: int = 0) -> dict:
    """The span rings as chrome-tracing JSON (Perfetto-loadable)."""
    return get_tracer().export_chrome(path=path, pid=rank)
