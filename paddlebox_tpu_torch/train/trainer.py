"""Pass-cadenced single-device trainer and its chunk driver.

Counterpart of paddlebox_tpu/train/trainer.py (make_scan :93-118,
run_scan_chunks :120-303, make_train_step :543-742 with scan_chunk_fn
:747-855, eval_step :887-893, BoxTrainer :914-1000, the staging pool and
host_batch :1041-1208, train_pass :1220-1402, predict_batches :1527-1549)
for one GPU. A step is

    pull (slab row gather) -> fused seqpool+CVM -> model forward/backward
    (autograd) -> masked BCE -> the dense step -> build_push_grads -> push
    (the fused push_adagrad kernel: merge, the table's in-table rule, row
    write; in blocked mode it returns the rows and the blocked_write
    kernel places them, in rebuild mode gather_rows spreads them over the
    slab by a position map and one select keeps the other rows)

The push's write (PushFlags.push_write: 'auto', the default, 'scatter',
'rebuild' or 'blocked') is resolved once, at construction
(``PushFlags.resolve_push_write``: 'auto' is 'scatter' off the card and
flags.AUTO_REBUILD_MAX_RATIO's rule on it). Its products ride the wire
``StageFlags`` names, read at every pass (reference trainer.py:644-712,
1081-1103, 1132-1185): the full wire (the host's sorted dedup, with the
[capacity] position map under 'rebuild'), the uid wire (the sorted uid
vector; the rest derived on the device), the delta wire (that vector as
an int32 base and int16 deltas) or the ids-only wire (nothing; the step
dedups on the device). ``sparse_push`` picks the push by the products a
batch carries. Every wire and write leaves the same slab bits.

The model zoo (models/__init__.py MODEL_ZOO) rides the same step. A feed
with dense float slots adds the batch's ``dense`` [B, dense_dim] leaf, which
every model call takes beside the pooled input (the model's spec must have
that dense_dim). A multi-task model (MMoE, ESMM: more than one task name,
the main task first) returns logits by task and trains on
``multi_task_loss`` (reference trainer.py:437-464): the sum of each task's
masked mean BCE, or with ``loss_mode = "esmm"`` BCE(click, pCTR) +
BCE(conversion, pCTCVR), which adds a 'ctcvr' prediction. Each task's label
is the batch's ``labels_<task>`` leaf where the feed has one
(``task_label_slots``), the click label otherwise; the push's per-key
clicks come from the main task's label. Its predictions are a dict by task
at every level (step, chunk stack, host), and the metrics see
``pred_<task>`` and ``label_<task>`` with ``pred`` the main task's; eval
and predict_batches return the main task's. A ``use_data_norm`` model
(CtrDnn) normalizes its input by running summaries, buffers that the step
moves after the dense step and before the push with the model's
``update_summary`` on the step's f32 pooled input and dense columns (every
row of the batch counts, padding rows too, as in the reference);
``sparse_chunk_sync`` refuses such a model.

A ``use_expand`` model (CtrDnnExpand, models/nn_cross.py; reference
trainer.py:305-325, 557-605, 635-660) pulls the extended view: the
expand block's columns are sum-pooled (``seqpool_sum``) into its second
input, and their gradients ride the push after the embedx grads. The
model and the table's expand_embed_dim are checked against each other at
construction, and ``sparse_chunk_sync`` is refused with such a model.

The join phase's feeds (reference trainer.py:492-498, 606-614, 921-932,
1192-1195, 1210-1217, 1410-1411): a batch's ``rank_offset`` and
``aux_offset`` ride as leaves after ``dense`` (int32; the pinned ring
carries them like any leaf), a ``use_rank_offset`` model (JoinPvDnn)
gets the batch's matrix (each batch its own rows, also under
``sparse_chunk_sync``), and a ``use_aux_input`` model (CtrDnnAux) gets the
batch's ``aux_offset`` (its forward raises without one). The trainer's
``aux_source`` (an InputTable or ReplicaCache) is frozen into the model's
``aux_rows`` buffer at the start of every train_pass and predict_batches.
The batch's ``cmatch_rank`` reaches the metrics and the quality plane (its
``cmatch:<id>`` streams); it, ``ins_ids`` and ``qvalues`` stay on the host.

On a bf16 slab (DtypeFlags.slab_embed_dtype) the pull gathers DECODED f32
rows and the push decodes and encodes inside its kernel; the dense forward
runs in TrainerConfig.compute_dtype with DtypeFlags.matmul_dtype products
(``model_logits``, models/layers.py).

around the pass lifecycle feed -> begin_pass -> train -> metrics ->
end_pass (incremental by default: PassFlags, embedding/pass_table.py;
train/preload.py overlaps the next pass's feed with this one's steps). The
slab is updated in place (the JAX step donates it).

A pass with at least one full chunk of ``TrainerConfig.scan_chunk``
batches goes through ``run_scan_chunks``, the reference's default driver:
a pool of ``StageFlags.stack_threads`` threads stages each chunk's batches
(route lookup and dedup) in batch order, a producer thread stages
``chunk_prefetch_depth`` chunks ahead, and on the card each group of
``h2d_stack_chunks`` chunks rides pinned buffers and one copy a leaf on a
copy stream (train/staging.py). ``scan_steps`` then queues the chunk's
steps back to back with no host sync, and chunk i's losses (and
predictions, when a metric reads them) come back after chunk i+1 is
queued. The tail batches step one by one, their losses and predictions
copied back once at the end of the pass. With ``sparse_chunk_sync`` a
chunk is one pull, one seqpool over the chunk's C * batch instances, the
dense step per batch, and one merged push (``make_chunk_step``).

The dense step is TrainerConfig.dense_optimizer's: optax's adam (the
default), sgd or adagrad (train/dense_optim.py). Under
``TrainerConfig(sync_mode="async")`` (or ``async_mode``; reference
trainer.py:945-981, 1339-1385) the dense state lives in the host
AsyncDenseTable (train/async_dense.py, adam only): a pass steps one batch
at a time with no chunk driver, each step copies the table's parameters
into the module, runs the step with no dense update (``make_train_step(...,
async_dense=True)``: the sparse push runs on the card) and queues its flat
dense grad, copied to the host, for the table's thread; the pass end waits
for the thread and copies the table's parameters into the module.

Every push takes an int32 seed for the creation hash. The trainer draws it
from its own ``torch.Generator(seed)`` through ``seed_fn``, on the thread
that queues the steps, one a step in step order (one a chunk under
``sparse_chunk_sync``), as the JAX scan splits its key; a caller may
replace ``seed_fn`` (any zero-argument callable returning a nonnegative
int32), which is how the parity tests replay the JAX trainer's seeds.

An eval step (``make_eval_step``, ``predict_batches``) is the pull, the
fused seqpool+CVM and the forward under ``torch.no_grad()``: no backward,
no dense update, no push. The dense state reads and restores as numpy under
the JAX package's names (``params``, ``opt_state``, ``restore_dense``;
convert.py).

The host planes the reference's trainer runs by default (``ObsFlags``, all
on unless the caller turns them off; reference trainer.py:940-984,
1277-1297, 1357-1359, 1388-1428): the tagged quality plane
(``self.quality``, metrics/quality.py) and the drift monitor
(``self.drift``, metrics/drift.py) are fed every batch's predictions, so
predictions come back once a chunk when either a metric or quality reads
them; the dataset's ingest hook feeds the drift monitor the trainer made
active at construction and at every train_pass. A StepReporter
(``self.reporter``, obs/report.py) over the ``step`` and ``pass`` timers
reports every ``obs_report_every`` steps and once at every pass end: the
forced pass_end record carries the loss, the metrics' AUC, the quality
report and the drift window. The chunk driver records the spans
host_stage, scan_dispatch and chunk_drain; a tail step's spans carry its
step trace id.
"""

from __future__ import annotations

import queue
import sys
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import (Callable, Dict, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch
import torch.nn.functional as F

from paddlebox_tpu_torch.config.configs import (DataFeedConfig, TableConfig,
                                                TrainerConfig)
from paddlebox_tpu_torch.config.flags import (DtypeFlags, HostFlags, ObsFlags,
                                              PassFlags, PushFlags, StageFlags)
from paddlebox_tpu_torch.convert import (NESTED_PARAMS, dense_state,
                                         flat_names, flatten_params,
                                         params_from_jax, params_to_numpy,
                                         unflatten_params)
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.data.packer import PackedBatch
from paddlebox_tpu_torch.device import DeviceLike, resolve_device
from paddlebox_tpu_torch.embedding.accessor import ValueLayout
from paddlebox_tpu_torch.embedding.optimizers import (decode_delta_uids,
                                                     push_sparse_dedup,
                                                     push_sparse_hostdedup,
                                                     push_sparse_rebuild,
                                                     push_sparse_uidwire)
from paddlebox_tpu_torch.embedding.pass_table import (PassTable,
                                                      delta_encode_uids,
                                                      segment_offsets,
                                                      uniq_count)
from paddlebox_tpu_torch.metrics import drift, quality
from paddlebox_tpu_torch.metrics.auc import MetricRegistry
from paddlebox_tpu_torch.obs import device as device_obs
from paddlebox_tpu_torch.obs import log as obs_log
from paddlebox_tpu_torch.obs import make_step_reporter
from paddlebox_tpu_torch.obs.tracer import set_trace, span, step_trace_id
from paddlebox_tpu_torch.obs.watchdog import beat
from paddlebox_tpu_torch.ops.seqpool import fused_seqpool_cvm, seqpool_sum
from paddlebox_tpu_torch.ops.sparse import (build_push_grads,
                                            build_push_grads_extended,
                                            gather_slab_rows,
                                            pull_sparse_extended,
                                            pull_view_from_rows)
from paddlebox_tpu_torch.train.async_dense import AsyncDenseTable
from paddlebox_tpu_torch.train.dense_optim import (check_opt_state,
                                                   make_dense_optimizer,
                                                   opt_state_from_numpy,
                                                   opt_state_to_numpy)
from paddlebox_tpu_torch.train.dump import DumpWriter, build_dump_tensors
from paddlebox_tpu_torch.train.staging import (DeviceChunk, HostChunk,
                                               PinnedRing, to_cpu)
from paddlebox_tpu_torch.utils.profiler import timer_report
from paddlebox_tpu_torch.utils.timer import Timer

Batch = Dict[str, object]
# a step's predictions: [B] (single task) or by task (multi-task)
Preds = Union[torch.Tensor, Dict[str, torch.Tensor]]
# a stager still alive this long after the consumer stopped raises
STAGER_GRACE_S = 60.0


def masked_bce(logits: torch.Tensor, labels: torch.Tensor,
               ins_valid: torch.Tensor):
    """(mean sigmoid BCE over valid instances, sigmoid preds) — the
    optax.sigmoid_binary_cross_entropy formula, -z*log_sigmoid(x) -
    (1-z)*log_sigmoid(-x)."""
    z = labels.to(logits.dtype)
    bce = -z * F.logsigmoid(logits) - (1.0 - z) * F.logsigmoid(-logits)
    denom = torch.clamp(ins_valid.sum().to(logits.dtype), min=1.0)
    loss = torch.where(ins_valid, bce, torch.zeros_like(bce)).sum() / denom
    return loss, torch.sigmoid(logits)


def multi_task_loss(logits: Dict[str, torch.Tensor],
                    labels: Dict[str, torch.Tensor], ins_valid: torch.Tensor,
                    loss_mode: str = "sum"):
    """(loss, preds by task) of a multi-task model (_multi_task_loss,
    paddlebox_tpu/train/trainer.py:437-464). 'sum': each task's masked mean
    sigmoid BCE, added in the logits' task order. 'esmm': the entire-space
    loss BCE(click, pCTR) + BCE(conversion, pCTCVR) over the valid
    instances, pCTCVR = pCTR * pCVR clipped to [1e-7, 1 - 1e-7], and the
    predictions gain 'ctcvr'."""
    if loss_mode == "esmm":
        preds = {t: torch.sigmoid(lg) for t, lg in logits.items()}
        pctcvr = torch.clamp(preds["ctr"] * preds["cvr"], 1e-7, 1.0 - 1e-7)
        click = labels["ctr"].to(torch.float32)
        conv = labels["cvr"].to(torch.float32)
        lg = logits["ctr"]
        bce_ctr = (-click * F.logsigmoid(lg)
                   - (1.0 - click) * F.logsigmoid(-lg))
        bce_ctcvr = -(conv * torch.log(pctcvr)
                      + (1.0 - conv) * torch.log1p(-pctcvr))
        per = bce_ctr + bce_ctcvr
        denom = torch.clamp(ins_valid.sum().to(per.dtype), min=1.0)
        loss = torch.where(ins_valid, per, torch.zeros_like(per)).sum() \
            / denom
        return loss, dict(preds, ctcvr=pctcvr)
    if loss_mode != "sum":
        raise ValueError("loss_mode must be 'sum' or 'esmm', got %r"
                         % (loss_mode,))
    total, preds = None, {}
    for t, lg in logits.items():
        loss, preds[t] = masked_bce(lg, labels[t], ins_valid)
        total = loss if total is None else total + loss
    return total, preds


def model_accepts_rank_offset(model) -> bool:
    """Whether the model (or model class) takes the pv rank matrix as its
    forward's ``rank_offset`` (the join phase's models, which set
    ``use_rank_offset``; reference trainer.py:492-498 reads the
    signature)."""
    return bool(getattr(model, "use_rank_offset", False))


def uses_aux_input(model: torch.nn.Module) -> bool:
    """Whether the model gathers side-table rows by ``aux_offset``."""
    return bool(getattr(model, "use_aux_input", False))


def feed_inputs(model: torch.nn.Module, batch: Batch) -> Dict[str, object]:
    """The batch's join-phase inputs the model takes, as the reference's
    forward picks them (trainer.py:599-614): the expand path none, a model
    taking ``rank_offset`` the batch's matrix where it has one, a
    ``use_aux_input`` model the batch's ``aux_offset`` (None where it has
    none, which its forward refuses)."""
    if uses_expand(model):
        return {}
    if "rank_offset" in batch and model_accepts_rank_offset(model):
        return {"rank_offset": batch["rank_offset"]}
    if uses_aux_input(model):
        return {"aux_offset": batch.get("aux_offset")}
    return {}


def model_logits(model: torch.nn.Module, pooled: torch.Tensor,
                 compute_dtype: str = "float32",
                 expand: Optional[torch.Tensor] = None,
                 dense: Optional[torch.Tensor] = None,
                 feed: Optional[Mapping[str, object]] = None):
    """The model's f32 logits ([B], or a dict of [B] by task) of
    ``pooled`` and, when given, the batch's dense columns ``dense``, the
    sum-pooled expand vectors ``expand`` (a ``use_expand`` model) and the
    keyword inputs ``feed`` (``feed_inputs``). Under compute_dtype
    'bfloat16' the forward runs on bf16 copies of the float inputs and of
    every parameter, and the logits return to f32 (apply_mixed_precision
    and mixed_logits_to_f32, paddlebox_tpu/train/trainer.py:512-541,
    598-603): the parameters stay the f32 masters Adam updates, and their
    gradients flow back through the casts. Integer inputs (rank_offset,
    aux_offset) are not cast, nor are buffers (CtrDnn's data_norm
    summaries, CtrDnnAux's aux_rows): they stay f32, as the reference's
    cast_for_compute preserves dn_summary."""
    kwargs = {k: v for k, v in (("expand", expand), ("dense", dense))
              if v is not None}
    kwargs.update(feed or {})
    if compute_dtype == "float32":
        return model(pooled, **kwargs)
    dt = torch.bfloat16
    params = {n: p.to(dt) for n, p in model.named_parameters()}
    out = torch.func.functional_call(
        model, params, (pooled.to(dt),),
        {k: (v.to(dt) if isinstance(v, torch.Tensor)
             and v.is_floating_point() else v)
         for k, v in kwargs.items()})
    if isinstance(out, dict):
        return {t: v.to(torch.float32) for t, v in out.items()}
    return out.to(torch.float32)


def task_names(model: torch.nn.Module) -> Tuple[str, ...]:
    """The model's tasks, the main one first."""
    return tuple(getattr(model, "task_names", ("ctr",)))


def is_multi_task(model: torch.nn.Module) -> bool:
    return len(task_names(model)) > 1


def uses_data_norm(model: torch.nn.Module) -> bool:
    """Whether ``model`` carries data_norm summaries the step moves
    (reference trainer.py:563-567)."""
    return bool(getattr(model, "use_data_norm", False)) and hasattr(
        model, "update_summary")


def task_label(batch: Batch, task: str) -> torch.Tensor:
    """The task's label leaf, the click label where the feed has none."""
    return batch.get("labels_" + task, batch["labels"])


def forward_loss(model: torch.nn.Module, pooled: torch.Tensor, batch: Batch,
                 compute_dtype: str = "float32",
                 expand: Optional[torch.Tensor] = None):
    """(loss, preds) of one batch: the forward on ``pooled`` (and the
    batch's dense leaf), then masked BCE, or multi_task_loss with each
    task's label for a multi-task model (preds by task)."""
    logits = model_logits(model, pooled, compute_dtype, expand,
                          batch.get("dense"), feed_inputs(model, batch))
    if is_multi_task(model):
        labels = {t: task_label(batch, t) for t in task_names(model)}
        return multi_task_loss(logits, labels, batch["ins_valid"],
                               getattr(model, "loss_mode", "sum"))
    return masked_bce(logits, batch["labels"], batch["ins_valid"])


def stack_preds(preds: Sequence[Preds]) -> Preds:
    """The steps' predictions stacked [C, B] (one stack a task)."""
    if isinstance(preds[0], dict):
        return {t: torch.stack([p[t] for p in preds]) for t in preds[0]}
    return torch.stack(preds)


def preds_to_host(preds: Preds):
    """Predictions as numpy (a dict of them for a multi-task model)."""
    if isinstance(preds, dict):
        return {t: v.cpu().numpy() for t, v in preds.items()}
    return preds.cpu().numpy()


def preds_row(preds, j: int):
    """Row ``j`` of stacked predictions (of each task's stack)."""
    if isinstance(preds, dict):
        return {t: v[j] for t, v in preds.items()}
    return preds[j]


def uses_expand(model: torch.nn.Module) -> bool:
    """Whether ``model`` consumes the expand embedding (the use_expand
    contract, models/nn_cross.py)."""
    return bool(getattr(model, "use_expand", False))


def check_expand_config(model: torch.nn.Module, layout: ValueLayout,
                        use_expand: bool) -> None:
    """Both directions of the expand contract fail at build time
    (reference trainer.py:305-325): a model that pulls the expand
    embedding needs a table whose expand_embed_dim is its expand_dim, and
    a table with an expand block needs such a model."""
    if use_expand:
        if not layout.expand_dim:
            raise ValueError(
                "model pulls the expand embedding but the table has "
                "expand_embed_dim == 0 (set TableConfig.expand_embed_dim)")
        mdim = getattr(model, "expand_dim", layout.expand_dim)
        if mdim != layout.expand_dim:
            raise ValueError(
                f"model.expand_dim={mdim} != "
                f"TableConfig.expand_embed_dim={layout.expand_dim}")
    elif layout.expand_dim:
        raise ValueError(
            "table has expand_embed_dim="
            f"{layout.expand_dim} but the model does not consume the "
            "expand embedding (use an use_expand model, e.g. "
            "CtrDnnExpand, or set expand_embed_dim=0)")


def _pull(slab: torch.Tensor, ids: torch.Tensor, layout: ValueLayout,
          use_expand: bool):
    """(pull view [K, 3+D], expand embedding [K, E] or None) of ``ids``:
    the extended pull on the expand path (reference trainer.py:635-643)."""
    if use_expand:
        return pull_sparse_extended(slab, ids, layout)
    return pull_view_from_rows(gather_slab_rows(slab, ids, layout),
                               layout), None


def sparse_push(slab: torch.Tensor, leaves: Mapping[str, object],
                ids: torch.Tensor, n_valid: int, grads: torch.Tensor,
                seed: int, layout: ValueLayout, table: TableConfig,
                write: str, block_rows: int, wire: str) -> None:
    """The step's push, IN PLACE, by the products its batch (or chunk,
    ``leaves``) carries (reference trainer.py:650-712): the full wire's
    perm and offsets (with ``push_pos`` under 'rebuild'), the delta wire's
    uid_base, uid_d16 and uid_cut, or the uid wire's uids, each with the
    host's n_uniq; on the ids-only ``wire`` none, and the step dedups on
    the device. A batch with no product on another wire raises: the
    device dedup never runs in its place silently."""
    conf = table.optimizer
    if "perm" in leaves:
        if "push_pos" in leaves:
            push_sparse_rebuild(slab, leaves["uids"], leaves["push_pos"],
                                leaves["perm"], leaves["offsets"],
                                leaves["n_uniq"], grads, seed, layout, conf)
        else:
            push_sparse_hostdedup(slab, leaves["uids"], leaves["perm"],
                                  leaves["offsets"], leaves["n_uniq"],
                                  grads, seed, layout, conf, write=write,
                                  block_rows=block_rows)
    elif "uid_d16" in leaves or "uids" in leaves:
        uids = (decode_delta_uids(leaves["uid_base"], leaves["uid_d16"],
                                  leaves["uid_cut"], table.pass_capacity)
                if "uid_d16" in leaves else leaves["uids"])
        push_sparse_uidwire(slab, uids, ids, n_valid, leaves["n_uniq"],
                            grads, seed, layout, conf, write=write,
                            block_rows=block_rows)
    elif wire == "ids_only":
        push_sparse_dedup(slab, ids, n_valid, grads, seed, layout, conf)
    else:
        raise KeyError("train batch lacks the push's dedup products "
                       "(the %s wire): host_batch stages them for every "
                       "train batch" % wire)


def make_train_step(model: torch.nn.Module, layout: ValueLayout,
                    table: TableConfig, dense_opt: torch.optim.Optimizer,
                    batch_size: int, num_slots: int,
                    push_write: str = "scatter",
                    block_rows: int = 1024,
                    compute_dtype: str = "float32",
                    wire: Callable[[], str] = lambda: "full",
                    async_dense: bool = False) -> Callable:
    """step(slab, batch, seed) -> (loss, preds), device tensors. Updates
    ``slab`` and the model's parameters IN PLACE. ``batch`` is a
    device_batch dict; its push products pick the push (``sparse_push``,
    ``wire()`` the trainer's current wire). A ``use_expand`` model
    (models/nn_cross.py) gets the extended pull: its expand block
    sum-pooled beside the pull view, its gradient pushed after the embedx
    grads (check_expand_config holds the model and the table to each
    other).

    ``async_dense`` (the reference's step_async, trainer.py:855-881):
    step(slab, batch, seed) -> (loss, preds, flat dense grad [P] on the
    device, in convert.flat_names order); no dense step runs, the sparse
    push does. Under data_norm the summaries move as in the sync step and
    their entries of the grad are that move, new minus old (the async
    table adds them raw). Other buffers' entries are zero.

    ``step.stages`` are its four stages in order, (pull(slab, batch) ->
    st, fwd_bwd(st, batch), dense_opt(st, batch), push(slab, st, batch,
    seed)), which the step runs back to back and BoxTrainer.
    train_pass_profiled runs one at a time."""
    padding_id = table.pass_capacity - 1
    use_expand = uses_expand(model)
    check_expand_config(model, layout, use_expand)
    has_summary = uses_data_norm(model)
    if use_expand and has_summary:
        raise ValueError("expand embedding + data_norm summary is not "
                         "supported in one model")
    main_task = task_names(model)[0]
    names = flat_names(model)
    tensors = dict(dense_state(model))
    summary = [n for n in names if is_summary_name(n)]

    def flat_grad(delta: Mapping[str, torch.Tensor]) -> torch.Tensor:
        parts = []
        for n in names:
            t = tensors[n]
            g = delta.get(n, t.grad)
            parts.append((torch.zeros_like(t) if g is None else g)
                         .reshape(-1))
        return torch.cat(parts)

    # the step's four stages, which train_pass_profiled also runs one by
    # one; ``st`` carries a step's tensors from one stage to the next
    def stage_pull(slab: torch.Tensor, batch: Batch) -> Dict[str, object]:
        ids = batch["ids"]
        # per-key validity is derived: padding key slots (and only those)
        # address the trash row
        valid = ids != padding_id
        emb, exp = _pull(slab, ids, layout, use_expand)
        return {"emb": emb, "exp": exp, "valid": valid}

    def stage_fwd_bwd(st: Dict[str, object], batch: Batch) -> None:
        segments = batch["segments"]
        emb, valid = st["emb"], st["valid"]
        emb.requires_grad_(True)
        pooled = fused_seqpool_cvm(emb, segments, valid, batch_size,
                                   num_slots, batch["n_valid"])
        pooled_exp = None
        if use_expand:
            st["exp"] = exp = st["exp"].clone().requires_grad_(True)
            pooled_exp = seqpool_sum(exp, segments, valid, batch_size,
                                     num_slots, batch["n_valid"])
        loss, preds = forward_loss(model, pooled, batch, compute_dtype,
                                   pooled_exp)
        dense_opt.zero_grad(set_to_none=True)
        loss.backward()
        st.update(pooled=pooled, loss=loss, preds=preds)

    def stage_dense_opt(st: Dict[str, object], batch: Batch) -> None:
        if not async_dense:
            dense_opt.step()
        delta: Dict[str, torch.Tensor] = {}
        if has_summary:
            old = ({n: tensors[n].clone() for n in summary} if async_dense
                   else {})
            model.update_summary(st["pooled"].detach(), batch.get("dense"))
            delta = {n: tensors[n] - was for n, was in old.items()}
        st["delta"] = delta

    def stage_push(slab: torch.Tensor, st: Dict[str, object], batch: Batch,
                   seed: int) -> None:
        segments, valid = batch["segments"], st["valid"]
        # per-key click = its instance's (main task's) label
        clicks = task_label(batch, main_task).index_select(
            0, segments // num_slots)
        if use_expand:
            push_grads = build_push_grads_extended(
                st["emb"].grad, st["exp"].grad, segments % num_slots,
                clicks, valid)
        else:
            push_grads = build_push_grads(st["emb"].grad,
                                          segments % num_slots, clicks,
                                          valid)
        sparse_push(slab, batch, batch["ids"], batch["n_valid"], push_grads,
                    seed, layout, table, push_write, block_rows, wire())

    def step(slab: torch.Tensor, batch: Batch, seed: int):
        st = stage_pull(slab, batch)
        stage_fwd_bwd(st, batch)
        stage_dense_opt(st, batch)
        stage_push(slab, st, batch, seed)
        if async_dense:
            return (st["loss"].detach(), _detach(st["preds"]),
                    flat_grad(st["delta"]))
        return st["loss"].detach(), _detach(st["preds"])

    step.stages = (stage_pull, stage_fwd_bwd, stage_dense_opt, stage_push)
    return step


def is_summary_name(name: str) -> bool:
    """Whether a dense tensor name is one of data_norm's summaries (the
    JAX params' ``dn_summary`` leaves)."""
    return any(name == "dn_summary_" + k for k in NESTED_PARAMS["dn_summary"])


def summary_mask(model: torch.nn.Module) -> Optional[np.ndarray]:
    """The flat bool mask of data_norm's summary entries in
    convert.flatten_params' vector (the reference's _flat_summary_mask,
    trainer.py:478-489), or None where the model has none."""
    tensors = dict(dense_state(model))
    names = flat_names(model)
    if not any(is_summary_name(n) for n in names):
        return None
    return np.concatenate([np.full(tensors[n].numel(), is_summary_name(n))
                           for n in names])


def _detach(preds: Preds) -> Preds:
    if isinstance(preds, dict):
        return {t: v.detach() for t, v in preds.items()}
    return preds.detach()


def make_eval_step(model: torch.nn.Module, layout: ValueLayout,
                   table: TableConfig, batch_size: int,
                   num_slots: int, compute_dtype: str = "float32"
                   ) -> Callable:
    """eval_step(slab, batch) -> the main task's preds [batch_size] on the
    device: the pull, fused seqpool+CVM, the forward and the sigmoid of
    its (main task's) logits, and nothing that writes."""
    padding_id = table.pass_capacity - 1
    use_expand = uses_expand(model)
    check_expand_config(model, layout, use_expand)
    main_task = task_names(model)[0]

    def eval_step(slab: torch.Tensor, batch: Batch) -> torch.Tensor:
        ids = batch["ids"]
        segments, n_valid = batch["segments"], batch["n_valid"]
        valid = ids != padding_id
        with torch.no_grad():
            emb, exp = _pull(slab, ids, layout, use_expand)
            pooled = fused_seqpool_cvm(emb, segments, valid, batch_size,
                                       num_slots, n_valid)
            pooled_exp = (seqpool_sum(exp, segments, valid, batch_size,
                                      num_slots, n_valid)
                          if use_expand else None)
            logits = model_logits(model, pooled, compute_dtype,
                                  pooled_exp, batch.get("dense"),
                                  feed_inputs(model, batch))
            if isinstance(logits, dict):
                logits = logits[main_task]
            return torch.sigmoid(logits)

    return eval_step


def make_scan(step_fn: Callable) -> Callable:
    """scan_steps(slab, stacked, seeds) -> (losses [C], preds [C, batch],
    a dict of them by task for a multi-task model):
    the chunk's C steps queued back to back through ``step_fn``, batch c
    from row c of each [C, ...] leaf of ``stacked`` (a DeviceChunk's
    ``stacked``) with seed ``seeds[c]``, and no host sync between them (the
    counterpart of the JAX lax.scan megastep)."""

    def scan_steps(slab: torch.Tensor, stacked: Dict, seeds: Sequence[int]):
        losses, preds = [], []
        for c, seed in enumerate(seeds):
            loss, p = step_fn(slab, {k: v[c] for k, v in stacked.items()},
                              seed)
            losses.append(loss)
            preds.append(p)
        return torch.stack(losses), stack_preds(preds)

    return scan_steps


def make_chunk_step(model: torch.nn.Module, layout: ValueLayout,
                    table: TableConfig, dense_opt: torch.optim.Optimizer,
                    batch_size: int, num_slots: int,
                    push_write: str = "scatter",
                    block_rows: int = 1024,
                    compute_dtype: str = "float32",
                    wire: Callable[[], str] = lambda: "full") -> Callable:
    """chunk_step(slab, stacked, cpush, seed) -> (losses [C], preds [C,
    batch]): the chunk-synchronous sparse megastep (scan_chunk_fn,
    paddlebox_tpu/train/trainer.py:755-845). ONE pull of the chunk's C*K
    ids at the chunk-start slab, ONE seqpool over its C * batch instances
    (batch c's segments offset by c * batch * num_slots; each batch's real
    key slots, its first n_valid, cut out and joined), the dense model per
    batch in order, each with its own Adam step on its pooled input as a
    detached leaf, then one vector-Jacobian product through the pool from
    the collected pooled-space grads to per-key grads, and ONE merged push
    over the chunk's dedup ``cpush`` (the flat C*K occurrences' products
    by the wire, as ``sparse_push`` reads them, and n_uniq) with one
    seed. Updates ``slab`` and the model IN PLACE. A multi-task model's
    predictions stack by task; the merged push's clicks are the main
    task's labels."""
    if uses_data_norm(model):
        # reference trainer.py:748-752: the summaries move per batch on
        # the batch's pooled input
        raise ValueError(
            "sparse_chunk_sync is unsupported with data_norm summary "
            "params: they need per-batch table/emb state")
    if uses_expand(model):
        # reference trainer.py:747-753 (its TrainerConfig.sparse_chunk_sync
        # note, configs.py:197-208): the expand block needs per-batch
        # table state
        raise ValueError(
            "sparse_chunk_sync is unsupported with expand embeddings: they "
            "need per-batch table/emb state")
    padding_id = table.pass_capacity - 1
    instances = batch_size * num_slots
    main_task = task_names(model)[0]

    def chunk_step(slab: torch.Tensor, stacked: Dict, cpush: Dict,
                   seed: int):
        ids = stacked["ids"]
        C, K = ids.shape
        ids_flat = ids.reshape(C * K)
        valid = ids_flat != padding_id
        seg = (stacked["segments"]
               + (torch.arange(C, dtype=stacked["segments"].dtype,
                               device=ids.device) * instances)[:, None]
               ).reshape(C * K)
        emb = pull_view_from_rows(gather_slab_rows(slab, ids_flat, layout),
                                  layout).requires_grad_(True)
        # batch c's real key slots are its first n_valid[c]: the pool
        # skips the padding tails instead of summing their zeros
        live = [slice(c * K, c * K + n)
                for c, n in enumerate(stacked["n_valid"])]
        emb_live = torch.cat([emb[s] for s in live])
        pooled = fused_seqpool_cvm(
            emb_live, torch.cat([seg[s] for s in live]),
            torch.cat([valid[s] for s in live]), C * batch_size, num_slots,
            emb_live.shape[0])
        pooled_c = pooled.detach().view((C, batch_size) + pooled.shape[1:])
        losses, preds, dpooled = [], [], []
        # the dense model's per-batch leaves
        dense_keys = [k for k in stacked
                      if k in ("labels", "ins_valid", "dense",
                               "rank_offset", "aux_offset")
                      or k.startswith("labels_")]
        for c in range(C):
            x = pooled_c[c].requires_grad_(True)
            loss, p = forward_loss(model, x,
                                   {k: stacked[k][c] for k in dense_keys},
                                   compute_dtype)
            dense_opt.zero_grad(set_to_none=True)
            loss.backward()
            dense_opt.step()
            losses.append(loss.detach())
            preds.append(_detach(p))
            dpooled.append(x.grad)
        (d_emb,) = torch.autograd.grad(
            pooled, emb, torch.stack(dpooled).view_as(pooled))
        clicks = task_label(stacked, main_task).reshape(
            C * batch_size).index_select(0, seg // num_slots)
        push_grads = build_push_grads(d_emb, seg % num_slots, clicks, valid)
        sparse_push(slab, cpush, ids_flat, sum(stacked["n_valid"]),
                    push_grads, seed, layout, table, push_write, block_rows,
                    wire())
        return torch.stack(losses), stack_preds(preds)

    return chunk_step


def run_scan_chunks(scan_call: Callable, items, chunk: int,
                    stack_fn: Callable, carry,
                    on_chunk: Callable,
                    n_items: Optional[int] = None,
                    chunk1_ok: bool = False,
                    prefetch_depth: int = 0,
                    transfer_group: int = 1,
                    group_fn: Optional[Callable] = None,
                    timer: Optional[Timer] = None):
    """Drive ``scan_call`` over the full chunks of ``items``, double
    buffered: chunk i+1 is staged and queued BEFORE chunk i's results come
    back to the host, so staging and the drain of results overlap device
    work (paddlebox_tpu/train/trainer.py:120-303). Staging runs under the
    span host_stage, each scan_call under scan_dispatch (and ``timer``,
    when given), each drain under chunk_drain; each dispatched chunk beats
    the stall watchdog ("scan_chunk").

    items: a list, or a bounded iterator with ``n_items`` given. Exactly
    n_consumed items are pulled either way, so the caller's per-step loop
    continues from items[n_consumed:]. chunk=1 drives nothing unless
    ``chunk1_ok`` (the chunk-synchronous mode runs its one-batch chunks
    through its chunk step).

    scan_call(carry, staged) -> (carry, losses_dev, preds_dev) queues one
    chunk; the carry is opaque here. stack_fn(group) stages one chunk;
    on_chunk(lo, group, losses_np, preds_dev) takes a chunk's results
    (metrics, the nan guard) once its losses are on the host.

    prefetch_depth > 0 stages up to that many chunks ahead on a producer
    thread (``stack_fn`` must be safe to call off the calling thread). Its
    queue is bounded; an error of the producer, any BaseException, is
    raised at the consumer's get. On any exit of the consumer the stop
    event is set and the producer is drained and joined; a producer still
    alive after STAGER_GRACE_S raises (or, while another error unwinds,
    is reported on stderr) rather than being left running.

    With ``group_fn``, stack_fn stages on the host and group_fn(list of
    staged) moves ``transfer_group`` chunks (fewer at the end) to the
    device at once.

    Returns (carry, losses, n_consumed); losses are the chunks' per-step
    losses as host numpy scalars, in order."""
    losses_all: List = []
    if n_items is None:
        n_items = len(items)
    it = iter(items)
    n_full = ((n_items // chunk) * chunk
              if (chunk > 1 or chunk1_ok) else 0)
    pending = None  # (lo, group, losses_dev, preds_dev)
    stop: Optional[threading.Event] = None

    def drain(p) -> None:
        lo, group, losses_dev, preds_dev = p
        losses_np = (losses_dev.cpu().numpy()
                     if isinstance(losses_dev, torch.Tensor)
                     else np.asarray(losses_dev))
        losses_all.extend(losses_np)
        on_chunk(lo, group, losses_np, preds_dev)

    def chunks():
        # the one definition of chunk grouping and staging, shared by the
        # inline and the producer paths
        for lo in range(0, n_full, chunk):
            if stop is not None and stop.is_set():
                return
            group = [next(it) for _ in range(chunk)]
            with span("host_stage"):
                staged = stack_fn(group)
            yield lo, group, staged

    def transfer(src):
        if group_fn is None:
            yield from src
            return
        buf: List = []

        def emit(b):
            for (lo, group, _), dev in zip(b, group_fn([x[2] for x in b])):
                yield lo, group, dev

        for item in src:
            buf.append(item)
            if len(buf) >= transfer_group:
                yield from emit(buf)
                buf = []
        if buf:
            yield from emit(buf)

    producer: Optional[threading.Thread] = None
    if prefetch_depth > 0 and n_full:
        q: "queue.Queue" = queue.Queue(maxsize=prefetch_depth)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce() -> None:
            try:
                for item in transfer(chunks()):
                    if not put(item):
                        return
            except BaseException as e:   # raised at the consumer's get
                put(e)

        producer = threading.Thread(target=produce, daemon=True,
                                    name="chunk-stager")
        producer.start()

        def staged_chunks():
            for _ in range(0, n_full, chunk):
                item = q.get()
                if isinstance(item, BaseException):
                    raise item
                yield item
        source = staged_chunks()
    else:
        source = transfer(chunks())

    try:
        for lo, group, staged in source:
            if timer is not None:
                timer.start()
            with span("scan_dispatch"):
                carry, losses, preds = scan_call(carry, staged)
            if timer is not None:
                timer.pause()
            beat("scan_chunk")
            if pending is not None:
                with span("chunk_drain"):
                    drain(pending)
            pending = (lo, group, losses, preds)
        if pending is not None:
            with span("chunk_drain"):
                drain(pending)
    finally:
        if producer is not None:
            # the consumer left (done or raising): stop the stager so it
            # cannot go on reading the table into the caller's next pass,
            # then unblock and join it; one mid-stack_fn finishes that
            # chunk, sees the flag and exits
            stop.set()
            deadline = time.monotonic() + STAGER_GRACE_S
            while producer.is_alive():
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
                producer.join(timeout=1.0)
                if producer.is_alive() and time.monotonic() > deadline:
                    if sys.exc_info()[1] is not None:
                        # keep the root cause that is unwinding
                        print("chunk-stager did not stop within %.0f s "
                              "while %r unwound" % (STAGER_GRACE_S,
                                                    sys.exc_info()[1]),
                              file=sys.stderr)
                        break
                    raise RuntimeError(
                        "chunk-stager did not stop within %.0f s; not "
                        "returning with a live stager" % STAGER_GRACE_S)
    return carry, losses_all, n_full


class BatchOutputs:
    """A trainer's per-batch outputs: the metrics, the quality and drift
    planes and the dump writer, fed one batch's predictions at a time.
    The trainer holds ``metrics``, ``quality``, ``drift``, ``dump_writer``,
    ``cfg``, ``task_names`` and ``num_slots``."""

    def _preds_consumed(self) -> bool:
        """Whether a metric, the quality plane or the dump writer reads
        predictions."""
        return (bool(self.metrics.metric_names()) or self.quality is not None
                or self.dump_writer is not None)

    def _dump_batch(self, pred, b: PackedBatch) -> None:
        """DumpField of one batch (boxps_worker.cc DumpField): a line per
        real instance with the requested fields; nothing without a dump
        writer."""
        if self.dump_writer is None:
            return
        by_task = pred if isinstance(pred, dict) else {
            self.task_names[0]: pred}
        tensors = build_dump_tensors(self.cfg.dump_fields, b.labels,
                                     by_task, self.task_names[0])
        if tensors:
            self.dump_writer.dump_batch(tensors, ins_ids=b.ins_ids,
                                        mask=b.ins_valid)

    def _add_metrics(self, pred, b: PackedBatch) -> None:
        """One batch's predictions ([B], or by task) into the metrics and,
        when on, the quality plane (the tagged streams, the per-slot CTR)
        and the drift monitor's pred histogram (reference
        trainer.py:1404-1428): ``label_<task>`` for each of the feed's task
        labels, ``pred_<task>`` for each prediction, ``pred`` the main
        task's."""
        if not (self.metrics.metric_names() or self.quality is not None):
            return
        by_task = pred if isinstance(pred, dict) else {
            self.task_names[0]: pred}
        main = by_task[self.task_names[0]]
        tensors = {"label": b.labels, "mask": b.ins_valid, "pred": main}
        if b.cmatch_rank is not None:
            tensors["cmatch_rank"] = b.cmatch_rank
        for t, lab in (b.task_labels or {}).items():
            tensors["label_" + t] = lab
        for t, p in by_task.items():
            tensors["pred_" + t] = p
        self.metrics.add_batch(tensors)
        if self.quality is not None:
            self.quality.add_batch(tensors)
            self.quality.add_slot_batch(main, b.labels, b.slots, b.segments,
                                        b.valid, self.num_slots)
            if self.drift is not None:
                self.drift.observe_preds(main, mask=b.ins_valid)


class BoxTrainer(BatchOutputs):
    """Single-device trainer over one PassTable + model."""

    def __init__(self, model: torch.nn.Module, table_cfg: TableConfig,
                 feed: DataFeedConfig,
                 trainer_cfg: Optional[TrainerConfig] = None,
                 seed: int = 0,
                 flags: Optional[PushFlags] = None,
                 device: DeviceLike = None,
                 pass_flags: Optional[PassFlags] = None,
                 store=None,
                 stage_flags: Optional[StageFlags] = None,
                 dtype_flags: Optional[DtypeFlags] = None,
                 obs_flags: Optional[ObsFlags] = None,
                 aux_source=None,
                 host_flags: Optional[HostFlags] = None) -> None:
        """``store``: the table's host store (PassTable's default, the
        native one, when None). ``stage_flags``: the chunk driver's
        staging, read at the start of every pass (``self.stage_flags`` may
        be replaced between passes). ``dtype_flags``: the slab's storage
        (the table's layout) and the dense matmuls' operand dtype (set on
        the model as its ``matmul_dtype``), read here. ``obs_flags``: the
        host planes (ObsFlags(): all on), read here. ``aux_source``: an
        InputTable or ReplicaCache (embedding/side_tables.py) whose rows a
        ``use_aux_input`` model gathers; frozen into the model's
        ``aux_rows`` at its ``aux_capacity`` at the start of every pass
        (a model that takes no aux rows refuses one). ``host_flags``
        (HostFlags(), read here): under ``profile_per_op`` train_pass runs
        train_pass_profiled.

        With TrainerConfig ``dump_fields`` and ``dump_fields_path`` the
        trainer keeps a DumpWriter (train/dump.py) and dumps each batch's
        fields after its metrics; ``close()`` closes it."""
        if aux_source is not None and not uses_aux_input(model):
            raise ValueError("aux_source given but the model does not "
                             "consume aux rows (use_aux_input)")
        self.aux_source = aux_source
        self.cfg = trainer_cfg or TrainerConfig()
        if self.cfg.scan_chunk < 1:
            raise ValueError("scan_chunk must be >= 1, got %r"
                             % (self.cfg.scan_chunk,))
        if self.cfg.sync_mode in ("k_step", "sharding") or self.cfg.sharding:
            raise ValueError(
                "sync_mode=%r / sharding=%r need the multi-device trainer"
                % (self.cfg.sync_mode, self.cfg.sharding))
        for name, default in (("sync_weight_step", 1),
                              ("sync_one_ring", False),
                              ("a2a_dtype", "float32")):
            if getattr(self.cfg, name) != default:
                raise ValueError(
                    "%s=%r needs the multi-device trainer (ROADMAP.md A10); "
                    "BoxTrainer takes %r only"
                    % (name, getattr(self.cfg, name), default))
        # the host async dense table (reference trainer.py:945-946)
        self.async_mode = (self.cfg.async_mode
                           or self.cfg.sync_mode == "async")
        if self.async_mode and self.cfg.dense_optimizer != "adam":
            raise ValueError("async dense table implements adam only; got "
                             + self.cfg.dense_optimizer)
        if self.async_mode and self.cfg.sparse_chunk_sync:
            raise ValueError("sparse_chunk_sync is unsupported with async "
                             "dense: it needs per-batch dense state")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # f32 stays f32: no TF32 in matmuls or convolutions
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.flags = flags or PushFlags()
        self.host_flags = host_flags or HostFlags()
        self.stage_flags = stage_flags or StageFlags()
        self.dtype_flags = dtype_flags or DtypeFlags()
        self.feed = feed
        self.table = PassTable(table_cfg, seed=seed, device=self.device,
                               flags=pass_flags, store=store,
                               embed_dtype=self.dtype_flags.slab_embed_dtype)
        if hasattr(model, "matmul_dtype"):
            model.matmul_dtype = self.dtype_flags.matmul_dtype
        elif self.dtype_flags.matmul_dtype != "float32":
            raise ValueError("matmul_dtype=%r: the model has no "
                             "matmul_dtype to set"
                             % self.dtype_flags.matmul_dtype)
        if getattr(model, "use_sequence", False):
            raise ValueError("%s attends a behavior sequence: train it on "
                             "parallel/seq_trainer.py SeqCtrTrainer"
                             % type(model).__name__)
        dense_dim = sum(s.dim for s in feed.used_dense_slots())
        spec = getattr(model, "spec", None)
        if spec is not None and spec.dense_dim != dense_dim:
            raise ValueError(
                "the model's spec has dense_dim=%d but the feed's dense "
                "slots give %d columns" % (spec.dense_dim, dense_dim))
        self.model = model.to(self.device)
        self.task_names = task_names(model)
        self.multi_task = is_multi_task(model)
        self.metrics = MetricRegistry()
        self.num_slots = len(feed.used_sparse_slots())
        # resolved once, here: the keys of one push are a batch's key
        # slots, or a chunk's under sparse_chunk_sync
        self.push_write = self.flags.resolve_push_write(
            table_cfg.pass_capacity,
            feed.key_capacity() * (self.cfg.scan_chunk
                                   if self.cfg.sparse_chunk_sync else 1),
            self.device, self.stage_flags)
        # optax's adam, sgd or adagrad (TrainerConfig.dense_optimizer)
        self.dense_opt = make_dense_optimizer(self.cfg,
                                              self.model.parameters())
        cdtype = self.cfg.compute_dtype

        def wire() -> str:
            return self.stage_flags.wire

        self.step_fn = make_train_step(
            self.model, self.table.layout, table_cfg, self.dense_opt,
            feed.batch_size, self.num_slots, push_write=self.push_write,
            block_rows=self.flags.push_block_rows, compute_dtype=cdtype,
            wire=wire, async_dense=self.async_mode)
        self.step_stages = self.step_fn.stages
        # async mode: the dense state lives in the host table; each step
        # pulls the parameters and data_norm's summaries from it (the
        # other buffers, CtrDnnAux's aux_rows, stay the trainer's)
        self.async_table: Optional[AsyncDenseTable] = None
        if self.async_mode:
            params = dict(self.model.named_parameters())
            self._pulled = [n for n in flat_names(self.model)
                            if n in params or is_summary_name(n)]
            self.async_table = AsyncDenseTable(
                flatten_params(self.model), lr=self.cfg.dense_lr,
                summary_mask=summary_mask(self.model))
        self.scan_steps = make_scan(self.step_fn)
        self.chunk_fn = (make_chunk_step(
            self.model, self.table.layout, table_cfg, self.dense_opt,
            feed.batch_size, self.num_slots, push_write=self.push_write,
            block_rows=self.flags.push_block_rows, compute_dtype=cdtype,
            wire=wire)
            if self.cfg.sparse_chunk_sync else None)
        self.eval_fn = make_eval_step(self.model, self.table.layout,
                                      table_cfg, feed.batch_size,
                                      self.num_slots, compute_dtype=cdtype)
        # the staging pool (threads, executor) and the pinned ring, made at
        # first use
        self._stage_pool: Tuple[int, Optional[ThreadPoolExecutor]] = (0,
                                                                      None)
        self._ring: Optional[PinnedRing] = None
        self._shuffle_rng = np.random.RandomState(seed + 1)
        self._seed_gen = torch.Generator().manual_seed(seed)
        self.seed_fn: Callable[[], int] = self._draw_seed
        self._step_count = 0
        self.pass_times: Dict[str, float] = {}
        # the host planes: quality and drift (each None when off, and the
        # active one of its module), the reporter over the stage timers
        self.obs_flags = obs_flags or ObsFlags()
        self.quality = quality.make_from_flags(self.obs_flags)
        self.drift = drift.make_from_flags(self.obs_flags)
        self.timers = {n: Timer() for n in ("step", "pass")}
        self.reporter = make_step_reporter(timers=self.timers,
                                           flags=self.obs_flags)
        # the last profiled pass's stage timers
        self.stage_timers: Dict[str, Timer] = {}
        self.dump_writer: Optional[DumpWriter] = None
        if self.cfg.dump_fields and self.cfg.dump_fields_path:
            self.dump_writer = DumpWriter(self.cfg.dump_fields_path,
                                          self.cfg.dump_thread_num)
        self._instrument_steps()

    def _instrument_steps(self) -> None:
        """The device plane (obs/device.py) on the step entry points, under
        the reference's names, each audited against the table's slab; and
        the HBM ledger's owners. The getters hold the trainer weakly, so
        the ledger never keeps it alive."""
        me = weakref.ref(self)

        def slab_of() -> Optional[torch.Tensor]:
            t = me()
            return t.table.resident_slab if t is not None else None

        def wrap(fn, name):
            return device_obs.instrument_step(fn, name, slab_of=slab_of,
                                              flags=self.obs_flags)

        self.step_fn = wrap(self.step_fn, "train_step_async"
                            if self.async_mode else "train_step")
        self.scan_steps = wrap(self.scan_steps, "scan_steps")
        if self.chunk_fn is not None:
            self.chunk_fn = wrap(self.chunk_fn, "scan_chunk")
        self.eval_fn = wrap(self.eval_fn, "eval_step")
        if self.obs_flags.device_obs:
            device_obs.register_owner("slab", slab_of)
            device_obs.register_owner("dense_params", lambda: (
                list(me().model.parameters()) if me() is not None else None))
            device_obs.register_owner("opt_state", lambda: (
                me().dense_opt.state if me() is not None else None))

    def _draw_seed(self) -> int:
        return int(torch.randint(0, 2**31 - 1, (), generator=self._seed_gen))

    def reseed(self, seed: int) -> None:
        """Restart the trainer's two random streams (the pass shuffle and
        the push seeds) as a trainer built with ``seed`` starts them: a
        trainer resumed from a checkpoint and the one that wrote it then
        draw alike."""
        self._shuffle_rng = np.random.RandomState(seed + 1)
        self._seed_gen = torch.Generator().manual_seed(seed)
        self.seed_fn = self._draw_seed

    def random_state(self) -> Dict[str, object]:
        """The trainer's random streams as numpy and Python values (what
        dense.pkl's ``extra`` may hold): the pass shuffle's RandomState,
        the push seeds' torch.Generator (its state as uint8) and the host
        store's creation RandomState. Taken at a pass boundary and given
        to ``set_random_state``, a resumed trainer draws as this one goes
        on to draw."""
        return {"shuffle_rng_state": self._shuffle_rng.get_state(),
                "seed_gen_state": self._seed_gen.get_state().numpy().copy(),
                "store_rng_state": self.table.store._rng.get_state()}

    def set_random_state(self, state: Mapping[str, object]) -> None:
        """Restore the streams ``random_state`` returned."""
        self._shuffle_rng.set_state(state["shuffle_rng_state"])
        self._seed_gen.set_state(torch.from_numpy(
            np.ascontiguousarray(state["seed_gen_state"], np.uint8)))
        self.table.store._rng.set_state(state["store_rng_state"])

    # ---------------------------------------------------------- dense state
    @property
    def params(self) -> Dict[str, np.ndarray]:
        """The dense parameters (and CtrDnn's data_norm summaries, nested
        under dn_summary) by the JAX package's names, as numpy."""
        return params_to_numpy(self.model)

    @property
    def opt_state(self) -> Dict[str, object]:
        """The dense optimizer's state under optax's names, as numpy
        (train/dense_optim.py opt_state_to_numpy: Adam's mu, nu and count,
        adagrad's sum_of_squares, sgd's nothing)."""
        return opt_state_to_numpy(self.cfg.dense_optimizer, self.model,
                                  self.dense_opt)

    # the single copy of the dense state, under the sharded trainer's names
    # (run_day saves these from either trainer)
    def merged_params(self) -> Dict[str, np.ndarray]:
        return self.params

    def merged_opt_state(self) -> Dict[str, object]:
        return self.opt_state

    def restore_dense(self, params: Mapping[str, np.ndarray],
                      opt_state: Mapping) -> None:
        """Set the dense parameters (and the data_norm summaries) and the
        dense optimizer's state from ``params`` and ``opt_state`` (the forms
        of the two properties), bit for bit. A state written under another
        dense_optimizer raises ValueError before anything is set."""
        check_opt_state(self.cfg.dense_optimizer, opt_state)
        state = params_from_jax(params)
        with torch.no_grad():
            for name, p in dense_state(self.model):
                p.copy_(state[name])
        opt_state_from_numpy(self.cfg.dense_optimizer, self.model,
                             self.dense_opt, opt_state)

    # ---------------------------------------------------------- batch utils
    def host_batch(self, b: PackedBatch, ids: np.ndarray,
                   skip_push_dedup: bool = False) -> Dict[str, object]:
        """Host staging of one batch: ids and the packed arrays, the push's
        products by ``stage_flags.wire`` (``_stage_push``), and the host
        int n_valid (real key slots; the packer puts them before its
        padding tail). Test mode, or ``skip_push_dedup`` (a
        chunk-synchronous chunk dedups once over the whole chunk), leaves
        out the push's products. The batch's dense columns ride as
        ``dense``, then the join phase's ``rank_offset`` and
        ``aux_offset`` where the batch has them; a multi-task model's tasks
        with a label of their own in the feed as ``labels_<task>`` (the
        others train on ``labels``)."""
        n_valid = int(b.valid.sum())
        out: Dict[str, object] = {"ids": ids, "segments": b.segments,
                                  "ins_valid": b.ins_valid,
                                  "labels": b.labels, "n_valid": n_valid}
        if b.dense is not None:
            out["dense"] = b.dense
        if b.rank_offset is not None:
            out["rank_offset"] = b.rank_offset
        if b.aux_offset is not None:
            out["aux_offset"] = b.aux_offset
        if self.multi_task and b.task_labels:
            for t in self.task_names:
                if t in b.task_labels:
                    out["labels_" + t] = b.task_labels[t]
        if not self.table.test_mode and not skip_push_dedup:
            self._stage_push(out, ids, n_valid, self.stage_flags.wire)
        return out

    def _stage_push(self, out: Dict[str, object], ids: np.ndarray,
                    n_valid: int, wire: str) -> None:
        """The push's products of the occurrences ``ids`` (n_valid of them
        real) into ``out``, by ``wire`` (reference trainer.py:1081-1103,
        1132-1185): on the full wire the sorted dedup (uids, perm, the
        segment offsets) and n_uniq, with the [capacity] ``push_pos`` map
        under 'rebuild'; on the uid and delta wires ``_stage_uid_wire``;
        on the ids-only wire nothing. One definition for a batch and a
        chunk."""
        if wire == "ids_only":
            return
        if wire != "full":
            self._stage_uid_wire(out, ids)
            return
        uids, perm, inv, out["n_uniq"] = self.table.dedup_for_push(ids)
        out.update(uids=uids, perm=perm,
                   offsets=segment_offsets(inv, n_valid))
        if self.push_write == "rebuild":
            out["push_pos"] = self.table.pos_for_rebuild(uids)

    def _stage_uid_wire(self, out: Dict[str, object],
                        ids: np.ndarray) -> None:
        """The uid wire's products into ``out``: the sorted [K] uid vector
        (``uids``), or under wire_delta_ids its int32 base and cut (host
        ints, as n_valid) and int16 deltas (``uid_base``, ``uid_cut``,
        ``uid_d16``); and n_uniq, its uids below the slab's capacity (a
        host int that sets the push's grid)."""
        capacity = self.table.capacity
        uids = self.table.uids_for_push(ids)
        out["n_uniq"] = uniq_count(uids, capacity)
        if self.stage_flags.wire == "delta":
            base, d16, cut = delta_encode_uids(uids, capacity)
            out.update(uid_base=int(base), uid_d16=d16, uid_cut=int(cut))
        else:
            out["uids"] = uids

    def device_batch(self, b: PackedBatch, ids: np.ndarray) -> Batch:
        """host_batch, then one copy per array to the device (the per-step
        path's pageable copies, kind "staging" in the transfer ledger)."""
        host = self.host_batch(b, ids)
        device_obs.account_h2d(device_obs.tree_nbytes(host), "staging")
        return {k: (torch.from_numpy(v).to(self.device)
                    if isinstance(v, np.ndarray) else v)
                for k, v in host.items()}

    def _refresh_aux(self) -> None:
        """The aux source's current rows into the model's ``aux_rows``
        (the reference's ToHBM cadence), before a train or test pass runs a
        step."""
        if self.aux_source is not None:
            with torch.no_grad():
                self.model.aux_rows.copy_(self.aux_source.to_device(
                    self.model.aux_capacity, self.device))

    def _host_pool(self) -> Optional[ThreadPoolExecutor]:
        """The staging pool of ``stage_flags.stack_threads`` threads (None:
        stage on the calling thread), remade when the flag changed. Route
        lookups (native, thread-local scratch) and the numpy dedup release
        the interpreter lock, so a chunk's batches stage in parallel."""
        n = self.stage_flags.stack_threads
        cur, pool = self._stage_pool
        if n != cur:
            if pool is not None:
                pool.shutdown(wait=False)
            pool = (ThreadPoolExecutor(n, thread_name_prefix="pbt-stage")
                    if n > 1 else None)
            self._stage_pool = (n, pool)
        return pool

    def _stage_one(self, b: PackedBatch) -> Dict[str, object]:
        return self.host_batch(b, self.table.lookup_ids(b.keys, b.valid),
                               skip_push_dedup=self.cfg.sparse_chunk_sync)

    def _stack_batches_host(self, group: List[PackedBatch]) -> HostChunk:
        """One chunk's host staging, each batch on the pool in batch order;
        in the chunk-synchronous mode also ONE staging of the push's
        products over the chunk's flat C*K occurrences (its padding, the
        trash row, sorts last), by the wire."""
        pool = self._host_pool()
        if pool is not None and len(group) > 1:
            hosts = list(pool.map(self._stage_one, group))
        else:
            hosts = [self._stage_one(b) for b in group]
        if not self.cfg.sparse_chunk_sync:
            return HostChunk(hosts)
        cpush: Dict[str, object] = {}
        # as the reference's chunk, the ids-only wire stages a chunk's full
        # products (its write is 'scatter')
        wire = self.stage_flags.wire
        self._stage_push(cpush, np.concatenate([h["ids"] for h in hosts]),
                         sum(h["n_valid"] for h in hosts),
                         "full" if wire == "ids_only" else wire)
        return HostChunk(hosts, cpush)

    def _group_to_device(self, hosts: List[HostChunk]) -> List[DeviceChunk]:
        """Host-staged chunks on the device: on the card through the pinned
        ring, one copy a leaf for the whole group; on the CPU as tensors,
        with no copy."""
        if self.device.type != "cuda":
            return [to_cpu(h) for h in hosts]
        ring = self._ring
        if ring is None or ring.group < len(hosts):
            ring = self._staging_ring()
        return ring.to_device(hosts)

    def _staging_ring(self) -> PinnedRing:
        """The pinned ring for groups of ``stage_flags.h2d_stack_chunks``
        chunks, with a slot for each group that can be in use at once
        (chunk_prefetch_depth staged ahead, one being consumed, one being
        staged), for steps on the calling thread's current stream."""
        slots = self.stage_flags.chunk_prefetch_depth + 2
        group = self.stage_flags.h2d_stack_chunks
        compute = torch.cuda.current_stream(self.device)
        ring = self._ring
        if ring is None or not ring.matches(group, slots, compute):
            if ring is not None:
                ring.close()
            ring = self._ring = PinnedRing(group, slots, self.device,
                                           compute)
        return ring

    def close(self) -> None:
        """Stop the async dense table's thread, the dump writer and the
        staging pool, drop the pinned ring and close the reporter's sink."""
        if getattr(self, "async_table", None) is not None:
            self.async_table.stop()
            self.async_table = None
        if getattr(self, "dump_writer", None) is not None:
            self.dump_writer.close()
            self.dump_writer = None
        self.reporter.close()
        pool = self._stage_pool[1]
        if pool is not None:
            pool.shutdown(wait=False)
        self._stage_pool = (0, None)
        if self._ring is not None:
            self._ring.close()
            self._ring = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:  # an interpreter that is shutting down
            pass

    # ---------------------------------------------------------- pass cadence
    def train_pass(self, dataset: BoxDataset,
                   preloaded: bool = False) -> Dict[str, float]:
        """One full pass: feed -> build -> train -> metrics -> end.

        ``preloaded``: the dataset is loaded and the table's feed pass is
        done (train.preload.PassPreloader.wait), so the feed is skipped.

        ``self.pass_times`` then holds the host-clock seconds of its phases:
        feed (load + key registration; absent when preloaded), build
        (begin_pass + shuffle + packing), steps (the chunk driver: staging,
        queueing every chunk and draining each chunk's results; then the
        tail's steps) and end (end_pass, the tail's metrics and the
        pass_end report; it waits for the device work still queued)."""
        clock = [time.perf_counter()]
        times: Dict[str, float] = {}

        def lap(name: str) -> None:
            now = time.perf_counter()
            times[name] = now - clock[0]
            clock[0] = now

        if self.stage_flags.wire == "ids_only" and \
                self.push_write != "scatter":
            raise ValueError(
                "the ids-only wire (h2d_lean without h2d_uid_wire) stages no "
                "push products; the trainer's write %r needs them"
                % (self.push_write,))
        if (self.host_flags.profile_per_op and not preloaded
                and not self.multi_task and self.async_table is None):
            return self.train_pass_profiled(dataset)
        t_pass = self.timers["pass"]
        t_pass.start()
        # this pass's blocks (and the next pass's, preloaded meanwhile) feed
        # this trainer's drift monitor
        drift.set_active(self.drift)
        if not preloaded:
            self.table.begin_feed_pass()
            dataset.load_into_memory(add_keys_fn=self.table.add_keys)
            self.table.end_feed_pass()
            lap("feed")
        self._refresh_aux()
        self.table.begin_pass()
        dataset.local_shuffle(self._shuffle_rng.randint(1 << 31))
        batches = dataset.split_batches(num_workers=1)[0]
        lap("build")
        chunk_losses, tail = self._train_chunks(batches)
        losses: List[torch.Tensor] = []
        preds: List[torch.Tensor] = []
        try:
            for b in tail:
                # the step's spans carry its trace id
                set_trace(step_trace_id(0, self._step_count + 1))
                loss, p = self.train_batch(b)
                self.reporter.note_examples(self.feed.batch_size)
                self.reporter.maybe_report(self._step_count)
                if self.cfg.check_nan_inf and not bool(torch.isfinite(loss)):
                    # the guard syncs every tail step: it must see this
                    # step's loss before the next step is queued
                    raise FloatingPointError("nan/inf loss at step %d"
                                             % self._step_count)
                losses.append(loss)
                preds.append(p)
        finally:
            set_trace(None)
        lap("steps")
        self.table.end_pass()
        if self.async_table is not None:
            # the pass end is a sync point: the queued grads applied, the
            # module holds the table's parameters for eval and checkpoints
            self.async_table.wait_drained()
            self.pull_async_dense()
        mean_loss = 0.0
        if batches:
            loss_host = np.asarray(chunk_losses, np.float32)
            if losses:
                loss_host = np.concatenate(
                    [loss_host, torch.stack(losses).cpu().numpy()])
            mean_loss = float(np.mean(loss_host))
            if losses and self._preds_consumed():
                preds_host = preds_to_host(stack_preds(preds))
                for j, b in enumerate(tail):
                    self._add_metrics(preds_row(preds_host, j), b)
                    self._dump_batch(preds_row(preds_host, j), b)
        t_pass.pause()
        # every pass end is a report boundary
        extra = {"event": "pass_end", "loss": round(mean_loss, 6),
                 "auc": {m.name: float(m.calculator.auc())
                         for m in self.metrics.messages()}}
        quality.attach_pass_extras(extra, self.quality, self.drift)
        self.reporter.maybe_report(self._step_count, force=True, extra=extra)
        if self.cfg.profile:
            obs_log.info(timer_report(self.timers, prefix="trainer."))
        lap("end")
        self.pass_times = times
        return {"loss": mean_loss, "batches": len(batches),
                "instances": len(dataset)}

    def _train_chunks(self, batches: List[PackedBatch]
                      ) -> Tuple[List, List[PackedBatch]]:
        """The pass's full chunks through run_scan_chunks: (their losses,
        as host float32 in step order, and the tail batches left). Each
        chunk's metrics are added once its results are drained, in batch
        order. Runs nothing when scan_chunk is 1 (outside the
        chunk-synchronous mode) or the pass is shorter than a chunk."""
        chunk = self.cfg.scan_chunk
        sync = self.cfg.sparse_chunk_sync
        if (not (chunk > 1 or sync) or len(batches) < chunk
                or self.async_table is not None):
            # async mode steps one batch at a time, as the reference's
            # (its scan_steps is None)
            return [], batches
        flags = self.stage_flags
        ring = self._staging_ring() if self.device.type == "cuda" else None
        preds_on = self._preds_consumed()
        slab = self.table.slab

        def scan_call(carry, dc: DeviceChunk):
            if dc.ready is not None:
                torch.cuda.current_stream(self.device).wait_event(dc.ready)
            try:
                if sync:
                    out = self.chunk_fn(slab, dc.stacked, dc.cpush,
                                        self.seed_fn())
                else:
                    out = self.scan_steps(
                        slab, dc.stacked,
                        [self.seed_fn() for _ in range(chunk)])
            finally:
                if dc.release is not None:
                    dc.release()
            return carry, out[0], out[1]

        def on_chunk(lo, group_b, losses_np, preds_dev) -> None:
            self._step_count += len(group_b)
            self.reporter.note_examples(len(group_b) * self.feed.batch_size)
            self.reporter.maybe_report(self._step_count)
            if self.cfg.check_nan_inf and not np.isfinite(losses_np).all():
                raise FloatingPointError("nan/inf loss by step %d"
                                         % self._step_count)
            if preds_on:
                # one copy of the chunk's predictions (a task), sliced on
                # the host
                preds_host = preds_to_host(preds_dev)
                for j, b in enumerate(group_b):
                    self._add_metrics(preds_row(preds_host, j), b)
                    self._dump_batch(preds_row(preds_host, j), b)

        try:
            _, losses, n_done = run_scan_chunks(
                scan_call, batches, chunk, self._stack_batches_host, None,
                on_chunk, chunk1_ok=sync,
                prefetch_depth=flags.chunk_prefetch_depth,
                transfer_group=flags.h2d_stack_chunks,
                group_fn=self._group_to_device, timer=self.timers["step"])
        finally:
            if ring is not None:
                ring.reset()
        return losses, batches[n_done:]

    def train_batch(self, b: PackedBatch):
        """One step on one packed batch inside an open pass: (loss, preds)
        as device tensors (preds by task for a multi-task model)."""
        with span("host_stage"):
            ids = self.table.lookup_ids(b.keys, b.valid)
            batch = self.device_batch(b, ids)
        t_step = self.timers["step"]
        t_step.start()
        if self.async_table is None:
            loss, preds = self.step_fn(self.table.slab, batch,
                                       self.seed_fn())
        else:
            # PullDense / PushDense around the step (boxps_worker.cc:
            # 1278-1296): one copy of the table's parameters to the
            # device, and one of the grad to the host, which waits for
            # the step, as the reference's does
            self.pull_async_dense()
            loss, preds, flat_g = self.step_fn(self.table.slab, batch,
                                               self.seed_fn())
            self.async_table.push(flat_g.cpu().numpy())
        t_step.pause()
        self._step_count += 1
        return loss, preds

    def train_pass_profiled(self, dataset: BoxDataset) -> Dict[str, float]:
        """One pass with each step split into its stages, each timed to a
        synchronize of the device (TrainFilesWithProfiler,
        boxps_worker.cc:1336; reference trainer.py:1465-1524): host_stage
        (lookup_ids and the batch's copies to the device), pull (the
        gather_rows kernel on the card), fwd_bwd, dense_opt and push (the
        fused push_adagrad kernel on the card). The stages are the step's
        own (make_train_step's ``stages``) and draw the same seeds, so the
        pass gives train_pass's at scan_chunk=1 bit for bit; it is slower
        by design. Logs the stage report at its end and keeps the timers
        in ``stage_timers``. Refuses async dense (its step is not these
        stages)."""
        if self.async_table is not None:
            raise ValueError("train_pass_profiled: the async dense table's "
                             "step has no stages")
        pull, fwd_bwd, dense_opt, push = self.step_stages
        timers = {n: Timer() for n in ("host_stage", "pull", "fwd_bwd",
                                       "dense_opt", "push")}
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else lambda device: None)

        def timed(name: str, fn, *args):
            t = timers[name]
            t.start()
            out = fn(*args)
            sync(self.device)
            t.pause()
            return out

        drift.set_active(self.drift)
        self.table.begin_feed_pass()
        dataset.load_into_memory(add_keys_fn=self.table.add_keys)
        self.table.end_feed_pass()
        self._refresh_aux()
        self.table.begin_pass()
        dataset.local_shuffle(self._shuffle_rng.randint(1 << 31))
        losses: List[torch.Tensor] = []
        for b in dataset.split_batches(num_workers=1)[0]:
            batch = timed("host_stage", lambda b=b: self.device_batch(
                b, self.table.lookup_ids(b.keys, b.valid)))
            slab = self.table.slab
            st = timed("pull", pull, slab, batch)
            timed("fwd_bwd", fwd_bwd, st, batch)
            timed("dense_opt", dense_opt, st, batch)
            timed("push", push, slab, st, batch, self.seed_fn())
            self._step_count += 1
            loss = st["loss"].detach()
            if self.cfg.check_nan_inf and not bool(torch.isfinite(loss)):
                raise FloatingPointError("nan/inf loss at step %d"
                                         % self._step_count)
            losses.append(loss)
            if self._preds_consumed():
                p = preds_to_host(_detach(st["preds"]))
                self._add_metrics(p, b)
                self._dump_batch(p, b)
        self.table.end_pass()
        self.stage_timers = timers
        obs_log.info(timer_report(timers, prefix="stage."))
        mean_loss = (float(np.mean(torch.stack(losses).cpu().numpy()))
                     if losses else 0.0)
        return {"loss": mean_loss, "batches": len(losses),
                "instances": len(dataset)}

    def pull_async_dense(self) -> None:
        """Copy the async table's parameters (and data_norm's summaries)
        into the module."""
        unflatten_params(self.model, self.async_table.pull(), self._pulled)

    def load_async_state(self, state: Mapping[str, object]) -> None:
        """Restore the async table from its ``state()`` (a checkpoint's
        ``async_dense_state``) and the module from it."""
        self.async_table.load_state(state)
        self.pull_async_dense()

    # ------------------------------------------------------------------ eval
    def eval_batch(self, b: PackedBatch) -> torch.Tensor:
        """The main task's predictions of one packed batch inside an open
        test-mode pass, on the device."""
        ids = self.table.lookup_ids(b.keys, b.valid)
        return self.eval_fn(self.table.slab, self.device_batch(b, ids))

    def predict_batches(self, dataset: BoxDataset
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Test-mode inference over a loaded dataset (SetTestMode pulls):
        (the main task's preds, click labels) of its valid instances, on
        the host. The pass creates no feature and writes nothing back."""
        self.table.set_test_mode(True)
        self.table.begin_feed_pass()
        self.table.add_keys(dataset.all_keys())
        self.table.end_feed_pass()
        self._refresh_aux()
        self.table.begin_pass()
        batches = dataset.split_batches(num_workers=1)[0]
        preds = [self.eval_batch(b) for b in batches]
        self.table.end_pass()
        self.table.set_test_mode(False)
        if not batches:
            return np.empty(0, np.float32), np.empty(0, np.int32)
        preds_host = torch.stack(preds).cpu().numpy()
        return (np.concatenate([p[b.ins_valid]
                                for p, b in zip(preds_host, batches)]),
                np.concatenate([b.labels[b.ins_valid] for b in batches]))
