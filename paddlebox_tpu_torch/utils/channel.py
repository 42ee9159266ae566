"""Named queue depths as StepReport gauges: the depth-gauge registry of
paddlebox_tpu/utils/channel.py:18-55, without its Channel.

A queue-like object registered under a name is sampled into the gauge
``chan_<name>_depth`` (the sum of the live objects' ``len``) each time a
report is assembled, never per put or get. A name whose objects are all
collected gets one last 0 and is dropped. The port's dataset has one
reader and plain queues, so nothing registers yet.
"""

from __future__ import annotations

import weakref

from paddlebox_tpu_torch.utils.lockwatch import make_lock
from paddlebox_tpu_torch.utils.stats import gauge_set

_named: dict = {}           # gauge name -> weakref.WeakSet of queues
_named_lock = make_lock("channel._named_lock")


def register_depth_gauge(name: str, obj) -> None:
    """Sample ``len(obj)`` (weakly held) into gauge ``chan_<name>_depth``."""
    with _named_lock:
        _named.setdefault("chan_%s_depth" % name,
                          weakref.WeakSet()).add(obj)


def poll_depth_gauges() -> None:
    """Write every registered name's live depth into the stat registry
    (StepReporter calls this once a report)."""
    with _named_lock:
        snap = [(g, list(ws)) for g, ws in _named.items()]
        for g, live in snap:
            if not live:
                del _named[g]
    for gauge_name, live in snap:
        gauge_set(gauge_name, float(sum(len(c) for c in live)))
