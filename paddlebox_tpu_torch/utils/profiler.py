"""Profiling hooks: a torch.profiler trace and the stage timer reports.

Counterpart of paddlebox_tpu/utils/profiler.py. ``trace(logdir)`` is a
torch.profiler session (CPU and, where there is one, CUDA activity) whose
chrome trace lands in ``logdir`` as ``trace.json`` when it ends; while it
runs every span of the port's tracer (obs/tracer.py) also opens a
``torch.profiler.record_function`` range, as profile_pass.py's session
does. ``annotate(name)`` is one such range. A process's second
torch.profiler session has lost pinned copies on the card (PERF.md §7),
so run a trace that is read as its process's first.

``timer_report`` is one line a stage timer (calls, total ms, mean us),
``stats_report`` the StatRegistry's counters.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator

from paddlebox_tpu_torch.utils.stats import StatRegistry
from paddlebox_tpu_torch.utils.timer import Timer


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[object]:
    """Profile the block; yields the torch.profiler.profile object."""
    import torch

    from paddlebox_tpu_torch.obs import tracer
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    tracer.set_annotation(torch.profiler.record_function)
    try:
        yield prof
    finally:
        tracer.set_annotation(None)
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range in the trace (platform::RecordEvent)."""
    import torch
    with torch.profiler.record_function(name):
        yield


def timer_report(timers: Dict[str, Timer], prefix: str = "") -> str:
    """One line a timer that ran, by name (PrintSyncTimer,
    box_wrapper.h:784-801)."""
    lines = []
    for name in sorted(timers):
        t = timers[name]
        if not t.count:
            continue
        lines.append("%s%-12s calls=%-6d total=%8.1fms avg=%8.1fus"
                     % (prefix, name, t.count, t.elapsed_ms(),
                        t.elapsed_ms() * 1e3 / max(1, t.count)))
    return "\n".join(lines)


def stats_report() -> str:
    """The StatRegistry's counters, one a line (STAT_INT_ADD,
    monitor.h:80,137)."""
    snap = StatRegistry.instance().snapshot()
    return "\n".join("%-32s %d" % (k, v) for k, v in sorted(snap.items()))
