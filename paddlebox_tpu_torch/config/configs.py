"""Typed configs of the training slice.

Field names and defaults follow paddlebox_tpu/config/configs.py, so a config
written for the JAX package carries over by keyword. Only the fields this
slice reads are kept; the rest of the JAX dataclasses wait for the slices
that read them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple


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
    one."""

    embedx_dim: int = 8
    expand_embed_dim: int = 0
    pass_capacity: int = 1 << 20
    show_click_decay_rate: float = 0.98
    delete_threshold: float = 0.8
    delete_after_unseen_days: float = 30.0
    base_threshold: float = 1.5
    delta_threshold: float = 0.25
    delta_keep_days: float = 16.0
    optimizer: SparseOptimizerConfig = dataclasses.field(
        default_factory=SparseOptimizerConfig)


@dataclasses.dataclass(frozen=True)
class SlotConfig:
    """One feature slot of the MultiSlot text format. A used float slot is
    a dense input of ``dim`` columns (the reference's fields, in another
    order: ``dim`` comes last, so the port's positional calls keep their
    meaning)."""

    name: str
    type: str = "uint64"     # uint64 (sparse feasign) | float (dense)
    is_used: bool = True
    max_len: int = 64        # per-instance key cap of the static packing
    dim: int = 1             # dense columns of a float slot


@dataclasses.dataclass(frozen=True)
class DataFeedConfig:
    """Slots and batch size; the packer's key capacity follows from
    them. ``task_label_slots``: (task, slot name) pairs whose slot's first
    value is that task's label (a multi-task model trains each head on its
    own label); a task not listed, or a record without that value, falls
    back to the click label. ``rank_offset``: the packer builds each
    batch's pv rank-offset matrix (the join phase). ``parse_ins_id``: each
    line leads with the instance id (the InputTable's key). Either puts
    the dataset on the record path, as in the reference."""

    slots: Tuple[SlotConfig, ...] = ()
    batch_size: int = 512
    task_label_slots: Tuple[Tuple[str, str], ...] = ()
    rank_offset: bool = False
    parse_ins_id: bool = False

    def used_sparse_slots(self) -> List[SlotConfig]:
        return [s for s in self.slots if s.is_used and s.type == "uint64"]

    def used_dense_slots(self) -> List[SlotConfig]:
        return [s for s in self.slots if s.is_used and s.type == "float"]

    def key_capacity(self) -> int:
        """Static key slots per batch: batch * sum(min(max_len, 16))."""
        per_ins = sum(min(s.max_len, 16) for s in self.used_sparse_slots())
        return max(128, self.batch_size * max(per_ins, 1))


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """Two-tier, pass-cadenced checkpoints (SaveBase/SaveDelta semantics,
    box_wrapper.cc:1286-1318): where the batch and xbox models go, the
    delta cadence of run_day, and whether the file writes run on a
    thread."""

    batch_model_dir: str = "ckpt/batch"
    xbox_model_dir: str = "ckpt/xbox"
    save_delta_every_passes: int = 1
    async_save: bool = True


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The trainer's settings: dense Adam (the only dense optimizer of the
    port) at dense_lr, and the chunk driver.

    scan_chunk: batches run back to back as one chunk (the JAX package's
    lax.scan megastep); 1 runs each batch as its own step. A pass with at
    least one full chunk goes through the chunk driver; its tail batches
    step one by one. sparse_chunk_sync: one pull and one merged push a
    chunk (pulls read the chunk-start rows), dense Adam per batch; chunks
    of one batch, and chunks whose batches share no key, give exactly the
    per-batch results. check_nan_inf: a pass raises FloatingPointError at
    the first chunk (or tail step) with a non-finite loss. compute_dtype:
    the dense forward's dtype, 'float32' or 'bfloat16' (the pooled input
    and a bf16 copy of every parameter; the parameters and Adam's state
    stay f32 masters, gradients flow back through the cast, the logits
    return to f32 for the loss)."""

    dense_lr: float = 1e-3
    check_nan_inf: bool = False
    scan_chunk: int = 8
    sparse_chunk_sync: bool = False
    compute_dtype: str = "float32"

    def __post_init__(self):
        # resolve_compute_dtype (paddlebox_tpu/train/trainer.py:501-510):
        # f32 or bf16 only, whose f32-sized exponent needs no loss scaling
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError("compute_dtype must be float32 or bfloat16, "
                             "got %r" % (self.compute_dtype,))
