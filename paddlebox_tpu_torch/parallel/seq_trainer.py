"""The behavior-sequence CTR trainer, its sequence split over an ``sp``
process group.

Counterpart of paddlebox_tpu/parallel/seq_trainer.py:43-278. One
designated slot's keys (``seq_slot``, in used-sparse-slot order) keep
their order as the history sequence of a BstSeqCtr-contract model; the
slot also rides the pooled path. The model's n_shards ranks of ``group``
(one process a GPU) each hold T / P positions of the sequence; every rank
loads all the files, holds the full PassTable (the pooled leaves and the
slab are replicated) and applies the same push, so the slabs and host
stores stay identical across the group. A step is

    pull the pooled ids (gather_rows) and this rank's [B, T/P] chunk of
    the sequence ids (gather_rows, a second launch) -> fused seqpool+CVM
    -> model.seq_feature_local (ring or Ulysses attention across the
    group, the masked mean's sums all-reduced) -> model.head_apply ->
    masked BCE, divided by P (tp_loss_scale) -> autograd -> the dense
    grads and the pooled rows' cotangent all-reduced over the group (the
    sequence chunk's cotangent stays local and exact) -> dense Adam ->
    build_push_grads for the pooled rows and for the [B, T] sequence rows
    (their cotangents and seq_valid all-gathered over the group, tiled on
    T, outside autograd; slot ``seq_slot``, the instance's click) -> ONE
    fused push_adagrad over the concatenation

The reported loss is the scaled one times P. At one shard (n_shards=1, or
a group of one) no collective is called and no scale is applied: the
step is the single-GPU one.

The sequence rows' show and click columns are zero (reference :160-165):
a history occurrence already counts once through its pooled row, so the
slot's statistics do not double; the sequence rows carry gradient only.
The host stages one dedup over the concatenated push ids, pooled first and
then the B * T sequence ids, and its segment offsets over the real
occurrences: every id that is not the trash row, the pooled valid keys and
the valid sequence positions (padding of both addresses the trash row, the
largest id, so it sorts last).

Dense Adam at TrainerConfig.dense_lr, as the reference's seq trainer
hard-codes optax.adam (:83); a config naming another dense optimizer is
refused rather than ignored. Every push takes an int32 seed from
``seed_fn`` (a torch.Generator seeded with seed + 29 by default, no rank
mixed in: every rank must apply the same push); a caller may replace it,
which is how the parity tests replay the reference's stream
(PRNGKey(seed + 29), one split a step, carried across passes). The pass
cadence is the reference's: feed, begin_pass, the batches in load
order (no shuffle), end_pass; there is no chunk driver and no preload.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from paddlebox_tpu_torch.config.configs import (DataFeedConfig, TableConfig,
                                                TrainerConfig)
from paddlebox_tpu_torch.convert import params_to_numpy
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.data.packer import PackedBatch
from paddlebox_tpu_torch.device import DeviceLike, resolve_device
from paddlebox_tpu_torch.embedding.accessor import ValueLayout
from paddlebox_tpu_torch.embedding.optimizers import push_sparse_hostdedup
from paddlebox_tpu_torch.embedding.pass_table import (PassTable,
                                                      segment_offsets)
from paddlebox_tpu_torch.metrics.auc import MetricRegistry
from paddlebox_tpu_torch.ops.seqpool import fused_seqpool_cvm
from paddlebox_tpu_torch.ops.sparse import (build_push_grads,
                                            gather_slab_rows,
                                            pull_view_from_rows)
from paddlebox_tpu_torch.parallel.tensor_parallel import (LOCAL, all_reduce_,
                                                          group_rank,
                                                          group_size,
                                                          tp_loss_scale)
from paddlebox_tpu_torch.train.dense_optim import make_dense_optimizer
from paddlebox_tpu_torch.train.eval_driver import (feed_simple_metrics,
                                                   simple_predict_batches)
from paddlebox_tpu_torch.train.trainer import masked_bce

Batch = Dict[str, object]


def seq_ids_of(b: PackedBatch, ids: np.ndarray, seq_slot: int,
               batch_size: int, num_slots: int, seq_len: int,
               pad: int) -> Tuple[np.ndarray, np.ndarray]:
    """The history slot's pass-local ids in order -> ([B, T] ids, [B, T]
    valid) (reference seq_trainer.py:204-225). The packer writes keys
    instance-major and slot-ascending, so each (instance, seq_slot) run is
    contiguous and in file order; a history longer than T is cut to its
    first T keys, a shorter one padded with the trash row ``pad``."""
    out = np.full((batch_size, seq_len), pad, dtype=np.asarray(ids).dtype)
    order = np.nonzero((b.slots == seq_slot) & b.valid)[0]
    if order.size:
        ins = b.segments[order] // num_slots
        counts = np.bincount(ins, minlength=batch_size)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(order.size) - starts[ins]
        keep = rank < seq_len
        out[ins[keep], rank[keep]] = ids[order[keep]]
    return out, out != pad


def _pull(slab: torch.Tensor, ids: torch.Tensor,
          layout: ValueLayout) -> torch.Tensor:
    return pull_view_from_rows(gather_slab_rows(slab, ids, layout), layout)


def _gather_seq(t: torch.Tensor, group) -> torch.Tensor:
    """[B, T/P, ...] chunks of the group's ranks -> [B, T, ...] in rank
    order (tiled on the sequence axis), outside autograd."""
    P = group_size(group)
    if P == 1:
        return t
    out = torch.empty((P * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out.view(P, *t.shape).transpose(0, 1).reshape(
        t.shape[0], P * t.shape[1], *t.shape[2:])


def make_seq_step(model: torch.nn.Module, layout: ValueLayout,
                  table: TableConfig, dense_opt: torch.optim.Optimizer,
                  batch_size: int, num_slots: int, seq_slot: int,
                  use_cvm: bool = True, group=LOCAL) -> Callable:
    """step(slab, batch, seed) -> (loss, preds [B]), device tensors, the
    reference's step (:107-172) on one rank of ``group``. Updates ``slab``
    and the model's parameters IN PLACE."""
    conf = table.optimizer
    pad = table.pass_capacity - 1
    B, S = batch_size, num_slots
    P = group_size(group)

    def step(slab: torch.Tensor, batch: Batch, seed: int):
        ids, segments = batch["ids"], batch["segments"]
        seq_ids, seq_valid = batch["seq_ids"], batch["seq_valid"]
        tl = seq_ids.shape[1]
        valid = ids != pad
        emb_pool = _pull(slab, ids, layout).requires_grad_(True)
        emb_seq = _pull(slab, seq_ids.reshape(-1), layout).reshape(
            B, tl, -1).requires_grad_(True)
        pooled = fused_seqpool_cvm(emb_pool, segments, valid, B, S, use_cvm,
                                   sorted_segments=True,
                                   n_valid=batch["n_valid"])
        logits = model.head_apply(
            pooled, model.seq_feature_local(emb_seq, seq_valid, group))
        loss, preds = masked_bce(logits, batch["labels"],
                                 batch["ins_valid"])
        # a replicated loss from summed activations: 1/P before the grad
        loss = tp_loss_scale(loss, group)
        dense_opt.zero_grad(set_to_none=True)
        loss.backward()
        # the replicated leaves' partial grads sum over the group; the
        # sequence chunk's cotangent is local and exact
        for p in model.parameters():
            if p.grad is not None:
                all_reduce_(p.grad, group)
        all_reduce_(emb_pool.grad, group)
        dense_opt.step()
        labels = batch["labels"]
        pg_pool = build_push_grads(emb_pool.grad, segments % S,
                                   labels.index_select(0, segments // S),
                                   valid)
        seq_grad = _gather_seq(emb_seq.grad, group)
        seq_valid_all = _gather_seq(seq_valid.to(torch.uint8),
                                    group).bool()
        T = seq_grad.shape[1]
        pg_seq = build_push_grads(
            seq_grad.reshape(B * T, -1),
            torch.full((B * T,), seq_slot, dtype=torch.int32,
                       device=ids.device),
            labels[:, None].expand(B, T).reshape(-1),
            seq_valid_all.reshape(-1))
        # gradient only: the occurrence's show and click count once,
        # through its pooled row
        pg_seq[:, 1:3] = 0.0
        push_sparse_hostdedup(slab, batch["uids"], batch["perm"],
                              batch["offsets"], batch["n_uniq"],
                              torch.cat([pg_pool, pg_seq]), seed, layout,
                              conf)
        return loss.detach() * P, preds.detach()

    return step


def make_seq_eval_step(model: torch.nn.Module, layout: ValueLayout,
                       table: TableConfig, batch_size: int, num_slots: int,
                       use_cvm: bool = True, group=LOCAL) -> Callable:
    """eval_step(slab, batch) -> preds [B]: the two pulls, the pool, the
    attended sequence (across ``group``) and the head under no_grad;
    nothing writes."""
    pad = table.pass_capacity - 1
    B, S = batch_size, num_slots

    def eval_step(slab: torch.Tensor, batch: Batch) -> torch.Tensor:
        ids, seq_ids = batch["ids"], batch["seq_ids"]
        with torch.no_grad():
            emb_pool = _pull(slab, ids, layout)
            emb_seq = _pull(slab, seq_ids.reshape(-1), layout).reshape(
                B, seq_ids.shape[1], -1)
            pooled = fused_seqpool_cvm(emb_pool, batch["segments"],
                                       ids != pad, B, S, use_cvm,
                                       sorted_segments=True,
                                       n_valid=batch["n_valid"])
            return torch.sigmoid(model.head_apply(
                pooled, model.seq_feature_local(emb_seq, batch["seq_valid"],
                                                group)))

    return eval_step


class SeqCtrTrainer:
    """Single-table trainer for BstSeqCtr-contract models (``seq_len``,
    ``n_shards``, ``seq_feature_local``, ``head_apply``), one rank of the
    ``sp`` group.

    seq_slot: index (in used-sparse-slot order) of the history slot whose
    keys feed the attention sequence; the slot also rides the pooled path,
    its CVM-pooled summary joining the head like any slot's. group: the
    sp process group of model.n_shards ranks (None: the world); a model
    of one shard runs alone (a group of one may be passed)."""

    def __init__(self, model: torch.nn.Module, table_cfg: TableConfig,
                 feed: DataFeedConfig,
                 trainer_cfg: Optional[TrainerConfig] = None,
                 seq_slot: int = 0, group=None, use_cvm: bool = True,
                 seed: int = 0, device: DeviceLike = None) -> None:
        self.cfg = trainer_cfg or TrainerConfig()
        # the reference's trainer reads dense_lr alone (its dense optimizer
        # is adam, seq_trainer.py:83): any other field set is refused
        default = TrainerConfig()
        changed = {f.name: getattr(self.cfg, f.name)
                   for f in dataclasses.fields(self.cfg)
                   if f.name != "dense_lr"
                   and getattr(self.cfg, f.name) != getattr(default, f.name)}
        if changed:
            raise ValueError(
                "SeqCtrTrainer runs dense adam at dense_lr and reads no "
                "other TrainerConfig field; got %s" % (changed,))
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.feed = feed
        self.seq_slot = seq_slot
        self.use_cvm = use_cvm
        self.table = PassTable(table_cfg, seed=seed, device=self.device)
        self.layout = self.table.layout
        if self.layout.expand_dim:
            raise ValueError("SeqCtrTrainer pulls no expand block; the "
                             "table has expand_embed_dim=%d"
                             % self.layout.expand_dim)
        self.num_slots = len(feed.used_sparse_slots())
        if not 0 <= seq_slot < self.num_slots:
            raise ValueError("seq_slot %d out of range [0, %d)"
                             % (seq_slot, self.num_slots))
        self.T = model.seq_len
        if group is None and model.n_shards == 1:
            group = LOCAL
        self.group = group
        self.P = group_size(group)
        if self.P != model.n_shards:
            raise ValueError("the sp group has %d ranks, the model n_shards "
                             "%d" % (self.P, model.n_shards))
        self.sp_rank = group_rank(group)
        self.model = model.to(self.device)
        self.dense_opt = make_dense_optimizer(self.cfg,
                                              self.model.parameters())
        self.metrics = MetricRegistry()
        self._seed_gen = torch.Generator().manual_seed(seed + 29)
        self.seed_fn: Callable[[], int] = self._draw_seed
        self.step_fn = make_seq_step(self.model, self.layout, table_cfg,
                                     self.dense_opt, feed.batch_size,
                                     self.num_slots, seq_slot, use_cvm,
                                     group)
        self.eval_fn = make_seq_eval_step(self.model, self.layout, table_cfg,
                                          feed.batch_size, self.num_slots,
                                          use_cvm, group)
        self.pass_times: Dict[str, float] = {}

    def _draw_seed(self) -> int:
        return int(torch.randint(0, 2**31 - 1, (), generator=self._seed_gen))

    # ---------------------------------------------------------- dense state
    @property
    def params(self) -> Dict[str, np.ndarray]:
        """The dense parameters by the JAX package's names, as numpy."""
        return params_to_numpy(self.model)

    # ------------------------------------------------------------ host side
    def seq_ids_of(self, b: PackedBatch, ids: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """This trainer's [B, T] history ids and mask of a batch
        (``seq_ids_of``)."""
        return seq_ids_of(b, ids, self.seq_slot, self.feed.batch_size,
                          self.num_slots, self.T, self.table.padding_id)

    def host_batch(self, b: PackedBatch) -> Dict[str, object]:
        """Host staging of one batch: the pooled leaves (ids, segments,
        labels, ins_valid, n_valid: the packer's real key slots come
        first), this rank's [B, T/P] chunk of seq_ids and seq_valid, and
        outside test mode the push's dedup over the concatenated push ids
        (pooled, then the full B * T sequence ids): uids, perm, the
        segment offsets of each unique's real occurrences, n_uniq
        (reference :227-252)."""
        ids = self.table.lookup_ids(b.keys, b.valid)
        seq_ids, seq_valid = self.seq_ids_of(b, ids)
        tl = self.T // self.P
        chunk = slice(self.sp_rank * tl, (self.sp_rank + 1) * tl)
        out: Dict[str, object] = {
            "ids": ids, "segments": b.segments, "labels": b.labels,
            "ins_valid": b.ins_valid, "n_valid": int(b.valid.sum()),
            "seq_ids": np.ascontiguousarray(seq_ids[:, chunk]),
            "seq_valid": np.ascontiguousarray(seq_valid[:, chunk])}
        if not self.table.test_mode:
            push_ids = np.concatenate([ids, seq_ids.reshape(-1)])
            uids, perm, inv, out["n_uniq"] = self.table.dedup_for_push(
                push_ids)
            # the real occurrences: every id but the trash row's
            n_push = int((push_ids != self.table.padding_id).sum())
            out.update(uids=uids, perm=perm,
                       offsets=segment_offsets(inv, n_push))
        return out

    def device_batch(self, b: PackedBatch) -> Batch:
        """host_batch, one copy per array to the device."""
        return {k: (torch.from_numpy(v).to(self.device)
                    if isinstance(v, np.ndarray) else v)
                for k, v in self.host_batch(b).items()}

    # ---------------------------------------------------------------- steps
    def train_batch(self, b: PackedBatch):
        """One step inside an open pass: (loss, preds [B]) as device
        tensors."""
        return self.step_fn(self.table.slab, self.device_batch(b),
                            self.seed_fn())

    def eval_batch(self, b: PackedBatch) -> torch.Tensor:
        """Predictions [B] of one batch inside an open test-mode pass."""
        return self.eval_fn(self.table.slab, self.device_batch(b))

    def train_pass(self, dataset: BoxDataset) -> Dict[str, float]:
        """One pass (reference :263-272): feed, begin_pass, a step a batch
        in load order, end_pass; then each batch's predictions into the
        metrics. ``self.pass_times`` holds the host-clock seconds of feed,
        build, steps and end (which waits for the card)."""
        clock = [time.perf_counter()]
        times: Dict[str, float] = {}

        def lap(name: str) -> None:
            now = time.perf_counter()
            times[name] = now - clock[0]
            clock[0] = now

        self.table.begin_feed_pass()
        dataset.load_into_memory(add_keys_fn=self.table.add_keys)
        self.table.end_feed_pass()
        lap("feed")
        self.table.begin_pass()
        batches = dataset.split_batches(num_workers=1)[0]
        lap("build")
        losses: List[torch.Tensor] = []
        preds: List[torch.Tensor] = []
        for b in batches:
            loss, p = self.train_batch(b)
            losses.append(loss)
            preds.append(p)
        lap("steps")
        self.table.end_pass()
        mean_loss = 0.0
        if batches:
            mean_loss = float(np.mean(torch.stack(losses).cpu().numpy()
                                      .astype(np.float64)))
            for p, b in zip(torch.stack(preds).cpu().numpy(), batches):
                feed_simple_metrics(self.metrics, p, b)
        lap("end")
        self.pass_times = times
        return {"loss": mean_loss, "batches": len(batches),
                "instances": len(dataset)}

    def predict_batches(self, dataset: BoxDataset
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Test-mode inference (no creation, no push): (preds, labels) over
        the dataset's valid instances; the pass is closed on every exit."""
        return simple_predict_batches(self, dataset)
