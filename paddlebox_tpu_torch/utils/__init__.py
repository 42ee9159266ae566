"""Host utilities: timers, the stat registry, channels, the framed RPC,
the lock-order watcher, file helpers and the journal's record format.
The reference's package-level names (paddlebox_tpu/utils/__init__.py)."""

from paddlebox_tpu_torch.utils.channel import Channel, ChannelClosed
from paddlebox_tpu_torch.utils.stats import (StatRegistry, stat_add,
                                             stat_get, stat_reset)
from paddlebox_tpu_torch.utils.timer import Timer, TimerScope

__all__ = ["Timer", "TimerScope", "StatRegistry", "stat_add", "stat_get",
           "stat_reset", "Channel", "ChannelClosed"]
