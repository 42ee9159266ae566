"""Typed configs of the port.

Field names and defaults follow paddlebox_tpu/config/configs.py, and every
dataclass there has the same field set here, so a config written for the
JAX package constructs in the port by keyword. TrainerConfig's
multi-device fields (sync_weight_step, sync_one_ring, a2a_dtype) are
checked here and refused by the trainer that cannot run them, naming
ROADMAP.md A10; MeshConfig's sizes are validated (positive ints) and
laid out by parallel/mesh.py make_mesh; a few are read by nothing here,
as in the reference (each says so).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from paddlebox_tpu_torch.config.flags import HostFlags


@dataclasses.dataclass(frozen=True)
class SparseOptimizerConfig:
    """Hyperparameters of the in-table sparse optimizer (heter_ps
    optimizer_conf.h:20-45 names and defaults). ``optimizer`` is the
    table's rule: adagrad, adam, adam_shared or naive."""

    # embed_w (the 1-d "lr" weight)
    nonclk_coeff: float = 0.1
    clk_coeff: float = 1.0
    min_bound: float = -10.0
    max_bound: float = 10.0
    learning_rate: float = 0.05
    initial_g2sum: float = 3.0
    initial_range: float = 0.0
    beta1_decay_rate: float = 0.9
    beta2_decay_rate: float = 0.999
    ada_epsilon: float = 1e-8
    # embedx (the mf_dim-wide factor vector) and the expand block
    mf_create_thresholds: float = 10.0
    mf_learning_rate: float = 0.05
    mf_initial_g2sum: float = 3.0
    mf_initial_range: float = 1e-4
    mf_beta1_decay_rate: float = 0.9
    mf_beta2_decay_rate: float = 0.999
    mf_min_bound: float = -10.0
    mf_max_bound: float = 10.0
    mf_ada_epsilon: float = 1e-8
    nodeid_slot: int = 9008
    feature_learning_rate: float = 0.05
    optimizer: str = "adagrad"  # adagrad | adam | adam_shared | naive


@dataclasses.dataclass(frozen=True)
class TableConfig:
    """Sparse table shape (embedx width, the expand block's width, pass
    slab rows) and the day lifecycle's thresholds (CtrCommonAccessor's
    decay, delete and save rules, ctr_accessor.cc:63-128).
    ``expand_embed_dim`` > 0 gives every row a second embedding block, the
    NN-cross features of pull_box_extended_sparse (BoxPS GetInsEx(
    embedx_dim, expand_embed_dim)); only adagrad and naive tables take
    one.

    The host/SSD tiering (reference configs.py:73-86): rows beyond
    ``ssd_threshold_mb`` of host store spill to block files in ``ssd_dir``
    at the end of a pass (embedding/ssd_tier.py); with either unset
    nothing spills. ``host_shard_bits`` is accepted and read by nothing,
    as in the reference (the striped store's stripe count is
    PassFlags.host_store_stripes). ``value_dtype`` is accepted and read by
    nothing, as in the reference (the slab's storage is
    DtypeFlags.slab_embed_dtype)."""

    embedx_dim: int = 8
    expand_embed_dim: int = 0
    pass_capacity: int = 1 << 20
    value_dtype: str = "float32"
    show_click_decay_rate: float = 0.98
    delete_threshold: float = 0.8
    delete_after_unseen_days: float = 30.0
    base_threshold: float = 1.5
    delta_threshold: float = 0.25
    delta_keep_days: float = 16.0
    optimizer: SparseOptimizerConfig = dataclasses.field(
        default_factory=SparseOptimizerConfig)
    host_shard_bits: int = 6
    ssd_dir: Optional[str] = None
    ssd_threshold_mb: float = 0

    def ssd_max_resident_rows(self, row_width: int) -> Optional[int]:
        """The host store's row budget of the pass-end limiter
        (CheckNeedLimitMem, box_wrapper.h:627-629) for rows of
        ``row_width`` f32 columns; None (no limit) without ``ssd_dir`` and
        ``ssd_threshold_mb``. Fractional budgets are honoured."""
        if not self.ssd_dir or not self.ssd_threshold_mb:
            return None
        return int(self.ssd_threshold_mb * (1 << 20)) // (row_width * 4)


@dataclasses.dataclass(frozen=True)
class SlotConfig:
    """One feature slot of the MultiSlot text format. A used float slot is
    a dense input of ``dim`` columns (the reference's fields, in its
    order)."""

    name: str
    type: str = "uint64"     # uint64 (sparse feasign) | float (dense)
    dim: int = 1             # dense columns of a float slot
    is_used: bool = True
    max_len: int = 64        # per-instance key cap of the static packing


@dataclasses.dataclass(frozen=True)
class DataFeedConfig:
    """Slots and batch size; the packer's key capacity follows from
    them. ``task_label_slots``: (task, slot name) pairs whose slot's first
    value is that task's label (a multi-task model trains each head on its
    own label); a task not listed, or a record without that value, falls
    back to the click label. ``rank_offset``: the packer builds each
    batch's pv rank-offset matrix (the join phase). ``parse_ins_id``: each
    line leads with the instance id (the InputTable's key). Either puts
    the dataset on the record path, as in the reference.

    ``pipe_command``: a shell command every input file is piped through
    before it is parsed (a ``.gz`` file is piped from ``zcat``); a ``.gz``
    file without one is read through gzip. Either puts the load on the
    record path (data/dataset.py). ``parser`` is accepted and read by
    nothing, as in the reference (an archive input is known by its magic;
    a plugin parser is BoxDataset's ``parser`` argument).
    ``batch_key_capacity``: the packer's static key slots a batch, 0 for
    ``key_capacity``'s other rules."""

    slots: Tuple[SlotConfig, ...] = ()
    batch_size: int = 512
    pipe_command: str = ""
    parser: str = "multislot"
    rank_offset: bool = False
    task_label_slots: Tuple[Tuple[str, str], ...] = ()
    batch_key_capacity: int = 0
    parse_ins_id: bool = False

    def used_sparse_slots(self) -> List[SlotConfig]:
        return [s for s in self.slots if s.is_used and s.type == "uint64"]

    def used_dense_slots(self) -> List[SlotConfig]:
        return [s for s in self.slots if s.is_used and s.type == "float"]

    def key_capacity(self, batch_size: Optional[int] = None) -> int:
        """Static key slots per batch (reference configs.py:125-133): the
        feed's ``batch_key_capacity``, else HostFlags' (the environment's)
        ``padbox_max_batch_keys``, else batch * sum(min(max_len, 16)) with
        ``batch_size`` (the feed's by default)."""
        if self.batch_key_capacity:
            return self.batch_key_capacity
        override = int(HostFlags().padbox_max_batch_keys)
        if override:
            return override
        bs = batch_size or self.batch_size
        per_ins = sum(min(s.max_len, 16) for s in self.used_sparse_slots())
        return max(128, bs * max(per_ins, 1))


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The device mesh's layout (reference configs.py:136-143), one rank a
    GPU: parallel/mesh.py ``make_mesh`` lays the ranks out row-major over
    the axes of size above 1 and those ``axis_names`` names, and gives each
    axis a process group. ``data`` is the data-parallel axis (the
    pipeline's dp rows, each training its own micro-batch group, dense
    gradients averaged over it); ``model`` the model-parallel one (an
    ``mp`` group, as MeshTowerTrainer's); ``pipeline`` the stages of
    parallel/pipeline.py (a stage a rank, activations sent rank to rank).
    Each size is a positive int."""

    data: int = 1
    model: int = 1
    pipeline: int = 1
    axis_names: Tuple[str, ...] = ("data", "model")

    def __post_init__(self):
        for name in ("data", "model", "pipeline"):
            v = getattr(self, name)
            if isinstance(v, bool) or not isinstance(v, int) or v < 1:
                raise ValueError("MeshConfig.%s must be a positive int, got "
                                 "%r" % (name, v))


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """Two-tier, pass-cadenced checkpoints (SaveBase/SaveDelta semantics,
    box_wrapper.cc:1286-1318): where the batch and xbox models go, the
    delta cadence of run_day, and whether the file writes run on a
    thread."""

    batch_model_dir: str = "ckpt/batch"
    xbox_model_dir: str = "ckpt/xbox"
    save_delta_every_passes: int = 1
    save_base_every_days: int = 1
    async_save: bool = True


# TrainerConfig.sync_mode (reference configs.py:168)
SYNC_MODES = ("step", "k_step", "async", "sharding")


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The trainer's settings: the dense optimizer at dense_lr, and the
    chunk driver.

    dense_optimizer: "adam" (the default), "sgd" or "adagrad", optax's
    updates (train/dense_optim.py make_dense_optimizer); anything else
    raises.

    scan_chunk: batches run back to back as one chunk (the JAX package's
    lax.scan megastep); 1 runs each batch as its own step. A pass with at
    least one full chunk goes through the chunk driver; its tail batches
    step one by one. sparse_chunk_sync: one pull and one merged push a
    chunk (pulls read the chunk-start rows), the dense update per batch;
    chunks
    of one batch, and chunks whose batches share no key, give exactly the
    per-batch results. check_nan_inf: a pass raises FloatingPointError at
    the first chunk (or tail step) with a non-finite loss. compute_dtype:
    the dense forward's dtype, 'float32' or 'bfloat16' (the pooled input
    and a bf16 copy of every parameter; the parameters and the
    optimizer's state stay f32 masters, gradients flow back through the cast, the logits
    return to f32 for the loss). check_nan_inf's default is HostFlags'
    (PBTPU_CHECK_NAN_INF), read when the config is made.

    dump_fields, dump_fields_path, dump_thread_num: with fields and a path
    the trainer writes one line a real instance of each batch through
    train/dump.py's DumpWriter on that many threads. profile: each pass
    logs its stage timers at its end. thread_num is accepted and read by
    nothing, as in the reference. sync_weight_step (a positive int),
    sync_one_ring and a2a_dtype ('float32' or 'bfloat16') are the
    multi-device trainer's: BoxTrainer refuses them away from their
    defaults, and parallel/sharded_trainer.py ShardedBoxTrainer refuses
    sync_one_ring and a bf16 a2a (ROADMAP.md A10) and reads
    sync_weight_step only under sync_mode 'k_step', which it refuses."""

    thread_num: int = 1
    sync_mode: str = "step"
    sync_weight_step: int = 1
    sync_one_ring: bool = False
    async_mode: bool = False
    sharding: bool = False
    dump_fields: Tuple[str, ...] = ()
    dump_fields_path: str = ""
    dump_thread_num: int = 1
    dense_lr: float = 1e-3
    dense_optimizer: str = "adam"
    check_nan_inf: bool = dataclasses.field(
        default_factory=lambda: bool(HostFlags().check_nan_inf))
    profile: bool = False
    scan_chunk: int = 8
    compute_dtype: str = "float32"
    a2a_dtype: str = "float32"
    sparse_chunk_sync: bool = False

    def __post_init__(self):
        if self.sync_mode not in SYNC_MODES:
            raise ValueError("sync_mode must be one of %s, got %r"
                             % (SYNC_MODES, self.sync_mode))
        if not isinstance(self.sync_weight_step, int) or \
                self.sync_weight_step < 1:
            raise ValueError("sync_weight_step must be a positive int, got "
                             "%r" % (self.sync_weight_step,))
        if self.a2a_dtype not in ("float32", "bfloat16"):
            raise ValueError("a2a_dtype must be float32 or bfloat16, got %r"
                             % (self.a2a_dtype,))
        if self.dense_optimizer not in ("adam", "sgd", "adagrad"):
            raise ValueError("dense_optimizer must be adam, sgd or adagrad, "
                             "got %r" % (self.dense_optimizer,))
        # resolve_compute_dtype (paddlebox_tpu/train/trainer.py:501-510):
        # f32 or bf16 only, whose f32-sized exponent needs no loss scaling
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError("compute_dtype must be float32 or bfloat16, "
                             "got %r" % (self.compute_dtype,))
