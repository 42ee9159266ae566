"""The switches the port reads: the push write, the pass lifecycle, the
chunk driver's staging, the checkpoint plane, the dtype diet, the
trainer's host planes (telemetry, quality, drift), the streaming runner
and the single-process host switches (HostFlags: the feed's local and
cross-host shuffle and key cap, the dump and archive rotation, the
profiled pass, the AUC runner, the nan guard's default, the lock-order
watch, the host hash table's load factor).

The JAX package keeps these in a process-wide flag registry
(paddlebox_tpu/config/flags.py), each read when the flag is defined. The
port passes them as values to the trainer, the pass table, the dataset
and the checkpoint manager instead, so two trainers in one process can
run different modes side by side.

When the port reads the environment: every field here takes the
reference's override, ``PBTPU_<NAME>`` (the field's name upper-cased),
parsed by the default's type, and reads it each time its dataclass is
made, not when this module is imported. An explicit constructor argument
wins over the environment (``ObsFlags.off()`` passes its fields
explicitly, so it stays off). A value made once and kept (a trainer's
``stage_flags``, the device plane's settings made at the import of
obs/device.py, lockwatch's switch made at its import) keeps the
environment of that moment: a variable set later reaches only objects
made later, and never part of one object. Defaults of function
arguments are None and made in the body for that reason
(train/flagship.py ``build_trainer``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

_ENV_PREFIX = "PBTPU_"


def _parse_env(default: Any, raw: str) -> Any:
    """``raw`` as the type of ``default`` (the reference's flag parsers,
    paddlebox_tpu/config/flags.py:44-56)."""
    if isinstance(default, bool):
        return raw.strip().lower() in ("1", "true", "yes", "on")
    return type(default)(raw)


def _env(name: str, default: Any):
    """A field whose default is ``default``, or PBTPU_<NAME> from the
    environment when it is set."""
    def make() -> Any:
        var = _ENV_PREFIX + name.upper()
        raw = os.environ.get(var)
        if raw is None:
            return default
        try:
            return _parse_env(default, raw)
        except ValueError as e:
            raise ValueError("invalid value %r for flag %r (from env %s): %s"
                             % (raw, name, var, e)) from e
    return dataclasses.field(default_factory=make)

PUSH_WRITES = ("auto", "scatter", "rebuild", "blocked")
DTYPES = ("float32", "bfloat16")
# push_write='auto' on the card picks 'rebuild' where the slab has at most
# this many rows a batch key slot (capacity <= ratio * batch_keys), else
# 'scatter'. 0: never. Taken from chip_smoke.py phase 18's timing of the
# three writes at the flagship batch (capacity/keys 8) and at a chunk of
# 8 batches (capacity/keys 1) on the 2^20-row slab: scatter won at both
# (PERF.md section 6, PR 18). The reference's 16 was measured on a TPU.
AUTO_REBUILD_MAX_RATIO = 0


@dataclasses.dataclass(frozen=True)
class DtypeFlags:
    """The dtype diet (paddlebox_tpu/config/flags.py:229, 257).
    slab_embed_dtype: the device slab's storage, 'float32' or 'bfloat16'
    (embedding/accessor.py: bf16 weights, the other columns as lossless
    (hi, lo) halves; host stores, checkpoints and the push and pull math
    stay f32). matmul_dtype: the dense matmuls' operands, 'bfloat16'
    (rounded to bf16, products summed in f32, an f32 result) or
    'float32'. The trainer reads both at construction."""

    slab_embed_dtype: str = _env("slab_embed_dtype", "float32")
    matmul_dtype: str = _env("matmul_dtype", "float32")

    def __post_init__(self):
        for name in ("slab_embed_dtype", "matmul_dtype"):
            if getattr(self, name) not in DTYPES:
                raise ValueError("%s must be one of %s, got %r"
                                 % (name, DTYPES, getattr(self, name)))


@dataclasses.dataclass(frozen=True)
class PushFlags:
    """push_write (paddlebox_tpu/config/flags.py:190-206): 'scatter'
    writes each updated row at its slab id; 'rebuild' gathers the new
    rows over the whole slab by a [capacity] position map and selects them
    where the map is set (its cost follows the slab's bytes, not the
    touched rows); 'blocked' buckets the sorted uids into
    ``push_block_rows``-row blocks and places them with the blocked-write
    kernel; 'auto' (the default, as in the reference) is
    ``resolve_push_write``'s choice."""

    push_write: str = _env("push_write", "auto")
    push_block_rows: int = _env("push_block_rows", 1024)

    def __post_init__(self):
        if self.push_write not in PUSH_WRITES:
            raise ValueError("push_write must be one of %s, got %r"
                             % (PUSH_WRITES, self.push_write))

    def resolve_push_write(self, capacity: int,
                           batch_keys: Optional[int] = None,
                           device="cpu",
                           stage: Optional["StageFlags"] = None) -> str:
        """The write ('scatter', 'rebuild' or 'blocked') for a slab of
        ``capacity`` rows, ``batch_keys`` key slots a push and the
        trainer's ``device`` (a torch.device or its type), on ``stage``'s
        wire (reference trainer.py:327-401):

          * the ids-only lean wire ships nothing to derive a map from: it
            pushes by 'scatter', and refuses 'rebuild' and 'blocked';
          * 'blocked' needs a positive block size that divides the slab (a
            partial tail block would shift its rows' local offsets);
          * 'auto' is 'scatter' off the card, as the reference's is off
            the TPU; on the card 'rebuild' where capacity <=
            AUTO_REBUILD_MAX_RATIO * batch_keys, else 'scatter'."""
        mode = self.push_write
        if stage is not None and stage.wire == "ids_only":
            if mode not in ("auto", "scatter"):
                raise ValueError(
                    "h2d_lean without h2d_uid_wire stages no push products; "
                    "push_write=%r needs them: use 'auto' or 'scatter'"
                    % (mode,))
            return "scatter"
        if mode == "auto":
            if getattr(device, "type", device) != "cuda":
                return "scatter"
            if capacity and batch_keys and \
                    capacity <= AUTO_REBUILD_MAX_RATIO * batch_keys:
                return "rebuild"
            return "scatter"
        if mode == "blocked":
            block = int(self.push_block_rows)
            if block <= 0 or capacity % block:
                raise ValueError(
                    "push_write=blocked: push_block_rows=%d must be positive "
                    "and divide the pass capacity %d" % (block, capacity))
        return mode


@dataclasses.dataclass(frozen=True)
class PassFlags:
    """incremental_pass: the slab stays resident on the device after
    end_pass; the next begin_pass moves the rows of keys it keeps on the
    device and reads only the new keys from the host store, and end_pass
    writes back only the rows the pass touched. preload_promote: while a
    pass trains, run_preloaded_passes' prefetcher reads the next pass's
    non-resident rows that the host store already holds; it is read only
    there, and only with incremental_pass (a pass trained on its own has
    no next pass loading). Both default on, as in the JAX package.

    host_store_stripes (paddlebox_tpu/config/flags.py:612-622, read by
    native_store.make_host_store when the table makes its store): shard
    the host embedding store's hash index into N stripes
    (embedding/striped_store.py): keys route by splitmix64(key) mod N,
    each stripe owns an independent inner store (+ rng seeded
    seed+stripe) so lookups gather per-stripe in parallel threads and the
    single global index stops being the billion-key bottleneck. 0
    (default) = the flat single-index store, bit-compatible with every
    existing checkpoint/journal; striped stores draw a DIFFERENT init
    stream (per-stripe rngs), so flip it only on fresh runs or
    restored-from-checkpoint runs."""

    incremental_pass: bool = _env("incremental_pass", True)
    preload_promote: bool = _env("preload_promote", True)
    host_store_stripes: int = _env("host_store_stripes", 0)


@dataclasses.dataclass(frozen=True)
class StageFlags:
    """The chunk driver's host staging (paddlebox_tpu/config/flags.py:
    137-177). stack_threads: threads that stage the batches of a chunk
    (route lookup and dedup), in batch order; 1 or less stages on the
    calling thread. chunk_prefetch_depth: chunks staged ahead on a producer
    thread while the device trains; 0 stages each chunk between two
    dispatches. h2d_stack_chunks: chunks whose staged arrays share one
    host-to-device copy a leaf. The trainer reads them at the start of
    every pass.

    The wire a train batch's push products ride (flags.py:142-168):
    h2d_lean off is the full wire (the host's sorted dedup: uids, perm,
    the segment offsets, and under 'rebuild' the [capacity] position
    map). h2d_lean with h2d_uid_wire (its default) is the uid wire: the
    sorted [K] uid vector only, the rest derived on the device; with
    wire_delta_ids as well, the uids ride as an int32 base and int16
    deltas (the delta wire). h2d_lean without h2d_uid_wire is the
    ids-only wire: no product, the step dedups on the device (and pushes
    by 'scatter'). Test passes stage no product on any wire."""

    stack_threads: int = _env("stack_threads", 4)
    chunk_prefetch_depth: int = _env("chunk_prefetch_depth", 1)
    h2d_stack_chunks: int = _env("h2d_stack_chunks", 1)
    h2d_lean: bool = _env("h2d_lean", False)
    h2d_uid_wire: bool = _env("h2d_uid_wire", True)
    wire_delta_ids: bool = _env("wire_delta_ids", False)

    @property
    def wire(self) -> str:
        """'full', 'uid', 'delta' or 'ids_only'."""
        if not self.h2d_lean:
            return "full"
        if not self.h2d_uid_wire:
            return "ids_only"
        return "delta" if self.wire_delta_ids else "uid"

    def __post_init__(self):
        for name in ("stack_threads", "chunk_prefetch_depth",
                     "h2d_stack_chunks"):
            if not isinstance(getattr(self, name), int):
                raise TypeError("%s must be an int, got %r"
                                % (name, getattr(self, name)))
        for name in ("h2d_lean", "h2d_uid_wire", "wire_delta_ids"):
            if not isinstance(getattr(self, name), bool):
                raise TypeError("%s must be a bool, got %r"
                                % (name, getattr(self, name)))
        if self.chunk_prefetch_depth < 0 or self.h2d_stack_chunks < 1:
            raise ValueError("chunk_prefetch_depth must be >= 0 and "
                             "h2d_stack_chunks >= 1, got %d and %d"
                             % (self.chunk_prefetch_depth,
                                self.h2d_stack_chunks))


CKPT_FORMATS = ("columnar", "pickle")


@dataclasses.dataclass(frozen=True)
class CkptFlags:
    """The checkpoint plane's switches (the JAX package's ckpt_* flags,
    paddlebox_tpu/config/flags.py:455-500), passed by value to the stores'
    save, PassTable.save and CheckpointManager.

    ckpt_format: the sparse batch tier as a 'columnar' manifest with
    ``ckpt_parts`` striped part files, written and read by a pool of
    ``ckpt_io_threads`` threads (0: one a part, up to the cores and 16), or
    as one legacy 'pickle'; either loads whatever this says.
    ckpt_xbox_columnar: xbox views as the serving columnar file
    (view.xcol), else the legacy embedding.pkl. ckpt_journal: the
    touched-row journal (train/journal.py) under
    ``<batch_model_dir>/_journal/rank0``, which save_base(mode='touched' or
    'auto') and per-pass recovery ride; its segments rotate at
    ``ckpt_journal_segment_bytes`` and at most ``ckpt_journal_segments``
    stay, past which the oldest is dropped and touched saves fall back to
    full until the next full base."""

    ckpt_format: str = _env("ckpt_format", "columnar")
    ckpt_parts: int = _env("ckpt_parts", 8)
    ckpt_io_threads: int = _env("ckpt_io_threads", 0)
    ckpt_xbox_columnar: bool = _env("ckpt_xbox_columnar", True)
    ckpt_journal: bool = _env("ckpt_journal", True)
    ckpt_journal_segment_bytes: int = _env(
        "ckpt_journal_segment_bytes", 64 << 20)
    ckpt_journal_segments: int = _env("ckpt_journal_segments", 32)

    def __post_init__(self):
        if self.ckpt_format not in CKPT_FORMATS:
            raise ValueError("ckpt_format must be one of %s, got %r"
                             % (CKPT_FORMATS, self.ckpt_format))


@dataclasses.dataclass(frozen=True)
class ObsFlags:
    """The trainer's host planes, all on by default as in the reference;
    BoxTrainer reads them at construction.

    obs_trace: record named spans into the per-thread rings
    (obs/tracer.py; paddlebox_tpu/config/flags.py:324).
    obs_trace_capacity: spans kept a thread before the ring wraps (:330).
    obs_report_every: the StepReport cadence in steps; <= 0 is off, the
    forced pass_end record included (:333).
    obs_report_path: the sink: '' keeps the last record only, 'stderr' one
    JSON line a record there, else a JSONL file appended to (:341).
    quality_metrics: the tagged quality plane (metrics/quality.py: per-tag
    AUC, COPC, actual and predicted CTR, per-slot CTR) (:519).
    quality_table_size: buckets of each tag's AUC table (:531).
    data_quality: the slot-level drift monitor (metrics/drift.py) over
    the ingest blocks and the predictions (:538).
    data_quality_warn: the drift score at which a rolled window logs a
    warning (:550).

    The single-process obs tiers (each with the env override):
    obs_watchdog_secs: the stall watchdog's silence threshold, <= 0 off
    (obs/watchdog.py; :347); obs_watchdog_action: 'dump' or 'raise'
    (:372). obs_flight_dir: the flight recorder's directory, '' off
    (obs/flight.py; :353); obs_flight_segment_bytes and
    obs_flight_segments: its rotation bound (:365, :368). obs_http_port:
    the ops endpoint's port (+ rank), 0 off (obs/exporter.py; :506).
    device_obs: the device plane (obs/device.py: the step entry points'
    signature sentinel and donation audit, the HBM ledger; :575);
    device_recompile_warmup: signatures a step entry point may take before
    a new one counts as device_recompiles (:589); device_donation_min_bytes:
    slabs smaller than this are not audited (:598);
    device_leak_windows and device_leak_min_bytes: the leak detector's
    growth streak and floor (:603, :607). obs_watermark: the journal
    publish's watermark record and the freshness samples
    (obs/watermark.py; :666); freshness_slo_secs (:676) and
    tier_hit_rate_warn (:683): the burn gauges' bounds, <= 0 off."""

    obs_trace: bool = _env("obs_trace", True)
    obs_trace_capacity: int = _env("obs_trace_capacity", 4096)
    obs_report_every: int = _env("obs_report_every", 20)
    obs_report_path: str = _env("obs_report_path", "")
    quality_metrics: bool = _env("quality_metrics", True)
    quality_table_size: int = _env("quality_table_size", 65536)
    data_quality: bool = _env("data_quality", True)
    data_quality_warn: float = _env("data_quality_warn", 0.5)
    obs_watchdog_secs: float = _env("obs_watchdog_secs", 0.0)
    obs_watchdog_action: str = _env("obs_watchdog_action", "dump")
    obs_flight_dir: str = _env("obs_flight_dir", "")
    obs_flight_segment_bytes: int = _env("obs_flight_segment_bytes", 4 << 20)
    obs_flight_segments: int = _env("obs_flight_segments", 4)
    obs_http_port: int = _env("obs_http_port", 0)
    device_obs: bool = _env("device_obs", True)
    device_recompile_warmup: int = _env("device_recompile_warmup", 3)
    device_donation_min_bytes: int = _env("device_donation_min_bytes",
                                          65536)
    device_leak_windows: int = _env("device_leak_windows", 3)
    device_leak_min_bytes: int = _env("device_leak_min_bytes", 1 << 20)
    obs_watermark: bool = _env("obs_watermark", True)
    freshness_slo_secs: float = _env("freshness_slo_secs", 30.0)
    tier_hit_rate_warn: float = _env("tier_hit_rate_warn", 0.05)

    def __post_init__(self):
        if self.obs_watchdog_action not in ("dump", "raise"):
            raise ValueError("obs_watchdog_action must be 'dump' or "
                             "'raise', got %r" % (self.obs_watchdog_action,))

    @classmethod
    def off(cls) -> "ObsFlags":
        """Every plane off: no spans, no reports, no quality, no drift, no
        device plane, no watermark; no watchdog, flight recorder or
        exporter."""
        return cls(obs_trace=False, obs_report_every=0,
                   quality_metrics=False, data_quality=False,
                   obs_watchdog_secs=0.0, obs_flight_dir="",
                   obs_http_port=0, device_obs=False, obs_watermark=False)


@dataclasses.dataclass(frozen=True)
class StreamFlags:
    """The streaming runner's switches (paddlebox_tpu/config/flags.py:
    626-658), each with the env override.

    streaming_micro_pass_instances: instances a micro-pass window fills
    before it is cut (data/streaming.py). streaming_poll_secs: the
    watcher's poll interval. streaming_stable_polls: polls a bare file's
    size must hold before it counts as sealed. streaming_base_every:
    save_base(mode='auto') every K admitted micro-passes (and on the first),
    0 none. streaming_admission_max_drift: the drift preview score at which
    a loaded window is refused before it trains, 0 no gate.
    streaming_idle_timeout_secs: the runner stops after this many seconds
    with no new window, 0 never."""

    streaming_micro_pass_instances: int = _env(
        "streaming_micro_pass_instances", 4096)
    streaming_poll_secs: float = _env("streaming_poll_secs", 0.2)
    streaming_stable_polls: int = _env("streaming_stable_polls", 2)
    streaming_base_every: int = _env("streaming_base_every", 8)
    streaming_admission_max_drift: float = _env(
        "streaming_admission_max_drift", 0.8)
    streaming_idle_timeout_secs: float = _env(
        "streaming_idle_timeout_secs", 0.0)


@dataclasses.dataclass(frozen=True)
class HostFlags:
    """The single-process host switches (paddlebox_tpu/config/flags.py:
    122-135, 188, 566), each with the env override.

    dataset_disable_shuffle: BoxDataset.local_shuffle keeps the load order
    (:122). auc_runner_mode: train/auc_runner.py maybe_run_auc_runner runs
    (:125). check_nan_inf: TrainerConfig.check_nan_inf's default (:127).
    padbox_max_batch_keys: DataFeedConfig.key_capacity's override after
    the feed's own batch_key_capacity, 0 none (:130).
    sparse_table_load_factor: the native host store's hash table grows
    past this load (:133). dump_file_max_bytes: the rotation size of the
    dump writer's and the archive spill's files (:135). profile_per_op:
    BoxTrainer.train_pass runs train_pass_profiled (:188).
    debug_lock_order: the default of lockwatch's process-wide switch,
    read once when utils/lockwatch.py is imported (:566).
    shuffle_block_codec: the cross-host instance shuffle moves whole
    ColumnarBlocks (data/block_shuffle.py); off, the per-record codec,
    which loads the shuffled dataset on the record path (:100).
    shuffle_connect_secs: TcpShuffler's dial timeout; a peer it cannot
    reach raises ShufflePeerUnreachable (:115)."""

    dataset_disable_shuffle: bool = _env("dataset_disable_shuffle", False)
    auc_runner_mode: bool = _env("auc_runner_mode", False)
    check_nan_inf: bool = _env("check_nan_inf", False)
    padbox_max_batch_keys: int = _env("padbox_max_batch_keys", 0)
    sparse_table_load_factor: float = _env("sparse_table_load_factor", 0.75)
    dump_file_max_bytes: int = _env("dump_file_max_bytes", 2 << 30)
    profile_per_op: bool = _env("profile_per_op", False)
    debug_lock_order: bool = _env("debug_lock_order", False)
    shuffle_block_codec: bool = _env("shuffle_block_codec", True)
    shuffle_connect_secs: float = _env("shuffle_connect_secs", 20.0)


HOSTPLANES = ("p2p", "store")


@dataclasses.dataclass(frozen=True)
class ShardFlags:
    """The sharded trainer's switches (paddlebox_tpu/config/flags.py:
    178-186, 252-309), read when ShardedBoxTrainer is made.

    stager_threads: the routing pool's threads; each step's bucketize
    runs on it up to this many steps ahead of the stager thread, which
    exchanges and dedups in step order. stream_depth: staged steps queued
    ahead of the consumer (peak live staged steps is this + 2).
    strict_bucket_overflow: a bucket overflow raises instead of dropping
    the overflowed keys' gradients with a warning (the
    sharded_bucket_overflow stat counts the drops either way).
    sharding_policy: the key -> shard rule (parallel/sharding.py
    resolve_sharding_policy): 'key-mod', 'table-wise' or '2d-grid'.
    sharding_num_tables and sharding_table_shift: a key's table is
    (key >> shift) % num_tables (table-wise and 2d-grid).
    sharding_grid_rows: the 2-D grid's row axis R, dividing P (0: the
    largest divisor of P not above sqrt(P)). sharding_hot_threshold: the
    grid's hot tier freezes the keys whose summed sketch count reaches it
    (0: off); sharding_hot_cap: the most hot keys a shard may hold (more
    raise). hostplane: the per-step host exchange.
    Its two values, 'p2p' and 'store', both name the port's one host
    plane, all-to-all over a gloo group of its own
    (fleet/mesh_comm.py MeshComm), and both build the TcpShuffler for the
    instance shuffle (Fleet.make_shuffler); the value is validated and
    otherwise unread."""

    stager_threads: int = _env("stager_threads", 4)
    stream_depth: int = _env("stream_depth", 2)
    strict_bucket_overflow: bool = _env("strict_bucket_overflow", False)
    sharding_policy: str = _env("sharding_policy", "key-mod")
    sharding_num_tables: int = _env("sharding_num_tables", 64)
    sharding_table_shift: int = _env("sharding_table_shift", 48)
    sharding_grid_rows: int = _env("sharding_grid_rows", 0)
    sharding_hot_threshold: int = _env("sharding_hot_threshold", 0)
    sharding_hot_cap: int = _env("sharding_hot_cap", 1024)
    hostplane: str = _env("hostplane", "p2p")

    def __post_init__(self):
        for name in ("stager_threads", "stream_depth"):
            if not isinstance(getattr(self, name), int):
                raise TypeError("%s must be an int, got %r"
                                % (name, getattr(self, name)))
        if str(self.hostplane).strip().lower() not in HOSTPLANES:
            raise ValueError("hostplane must be 'p2p' or 'store', got %r"
                             % (self.hostplane,))


# every dataclass of switches; their fields are the reference flags the
# port reads (tests/test_torch_flags.py holds them to the registry)
FLAG_CLASSES = (DtypeFlags, PushFlags, PassFlags, StageFlags, CkptFlags,
                ObsFlags, StreamFlags, HostFlags, ShardFlags)
