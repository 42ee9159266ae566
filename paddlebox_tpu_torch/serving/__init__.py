"""The serving plane (paddlebox_tpu/serving/): what serves the views the
trainer writes.

  * store   — the columnar view file, its mmap store behind the native
              route index, the base + delta precedence stack, the view
              compile, the hot-key file and a box's ShardSpec
  * cache   — the hot-key row cache (frequency-gated admission, CLOCK
              eviction, one view generation an entry)
  * codec   — the plain-container pull wire
  * refresh — the generation swap, the delta refresh watcher and the
              journal-fed overlay
  * server  — a serving process: batched pulls on the framed transport, a
              bounded pull pool, drain, the StepReport telemetry
  * client  — replica failover with re-probe backoff, and the fleet
              router that partitions pulls across boxes and coalesces them
  * fleet   — spawned replicas of one box, and the B boxes x R replicas
              grid

Nothing here imports torch, and serving runs on no card: a replica is
numpy, the standard library and the native host library, so it spawns in
about a second and never holds a CUDA context.
"""

from paddlebox_tpu_torch.serving.cache import HotKeyCache  # noqa: F401
from paddlebox_tpu_torch.serving.client import (FleetClient,  # noqa: F401
                                                ServingClient)
from paddlebox_tpu_torch.serving.codec import (decode_rows,  # noqa: F401
                                               encode_pull)
from paddlebox_tpu_torch.serving.fleet import (MultiBoxFleet,  # noqa: F401
                                               ServingFleet)
from paddlebox_tpu_torch.serving.refresh import (  # noqa: F401
    DeltaRefreshWatcher, JournalDeltaSource, ViewManager, make_manager)
from paddlebox_tpu_torch.serving.server import ServingServer  # noqa: F401
from paddlebox_tpu_torch.serving.store import (MmapViewStack,  # noqa: F401
                                               MmapXboxStore, ShardSpec,
                                               build_stack,
                                               compile_view_dir,
                                               discover_xbox_sources,
                                               read_hot_keys,
                                               write_hot_keys,
                                               write_xbox_columnar)
