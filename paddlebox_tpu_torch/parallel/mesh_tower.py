"""The trainer of the model-parallel towers (tensor-parallel wide layers,
expert-parallel MMoE) over an ``mp`` process group.

Counterpart of paddlebox_tpu/parallel/mesh_tower.py. The reference runs
the step per device inside shard_map over an ``mp`` mesh axis; here the
axis is a process group of ranks (one process a GPU), built as the seq
trainer's ``sp`` group is. A step is

    pull (gather_rows) -> fused seqpool+CVM -> model.apply_local on this
    rank's slices of the tower (models/wide_tower.py; its psums are
    autograd all-reduces over the group) -> masked BCE, divided by P
    (tp_loss_scale) -> autograd -> tp_fix_grads: every replicated leaf's
    gradient summed over the group; the pulled rows' cotangent summed over
    the group -> dense Adam on this rank's tensors -> build_push_grads ->
    ONE fused push_adagrad (the scatter, blocked or rebuild write)

The contract the reference enforces in code holds here in code: the loss
is scaled by 1/P once, before the gradient, and each replicated leaf and
the embedding cotangent is summed once, after it; a sharded leaf's
gradient (its slice of w1, b1, w2 or of the experts) is exact as autograd
leaves it. The reported loss is the scaled one times P.

The pass slab and the batch are replicated over the group: every rank
loads all the files, holds the full PassTable and applies the identical
push (the summed cotangent, and push seeds from ``seed_fn``, a
torch.Generator seeded with seed + 13 by default with no rank mixed in),
so the slabs and host stores stay bit-identical across the group. Model
parallelism buys tower width (a rank holds O(d_wide / P) of it), not
table capacity. Each rank's Adam (torch.optim.Adam at dense_lr, the
reference's optax.adam) keeps the moments of its own tensors: a sharded
leaf's slice, a replicated leaf whole.

A parity test replaces ``seed_fn`` to replay the reference's stream
(PRNGKey(seed + 13), one split a step, carried across passes). The pass
cadence is the reference's: feed, begin_pass, the batches in load order
(no shuffle), end_pass; there is no chunk driver and no preload.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch.config.configs import (DataFeedConfig, TableConfig,
                                                TrainerConfig)
from paddlebox_tpu_torch.config.flags import PushFlags
from paddlebox_tpu_torch.convert import tower_params_from_jax
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.data.packer import PackedBatch
from paddlebox_tpu_torch.device import DeviceLike, resolve_device
from paddlebox_tpu_torch.embedding.optimizers import (push_sparse_hostdedup,
                                                      push_sparse_rebuild)
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
                                                          tp_fix_grads,
                                                          tp_loss_scale)
from paddlebox_tpu_torch.train.dense_optim import make_dense_optimizer
from paddlebox_tpu_torch.train.eval_driver import (feed_simple_metrics,
                                                   simple_predict_batches)
from paddlebox_tpu_torch.train.trainer import masked_bce

Batch = Dict[str, object]


class MeshTowerTrainer:
    """Single-table CTR training with a model-parallel tower, one rank of
    the ``mp`` group.

    model: a models/wide_tower.py entry (``host_init(seed) ->
    (host_params, sharded)``, ``apply_local(p, pooled, group)``, its
    ``n_shards``). group: the mp process group of model.n_shards ranks
    (None: the world; a model of one shard runs alone, LOCAL).
    push_flags: the slab write (PushFlags.resolve_push_write: 'scatter',
    'blocked' or 'rebuild'; 'auto' as the main path resolves it)."""

    def __init__(self, model, table_cfg: TableConfig, feed: DataFeedConfig,
                 trainer_cfg: Optional[TrainerConfig] = None,
                 group=None, use_cvm: bool = True, seed: int = 0,
                 device: DeviceLike = None,
                 push_flags: Optional[PushFlags] = None) -> None:
        self.cfg = trainer_cfg or TrainerConfig()
        if self.cfg.sparse_chunk_sync:
            raise ValueError("sparse_chunk_sync is a single-host "
                             "BoxTrainer mode (not mesh-tower)")
        # the reference's trainer reads dense_lr alone (its dense optimizer
        # is optax.adam, mesh_tower.py:88): any other field set is refused
        default = TrainerConfig()
        changed = {f.name: getattr(self.cfg, f.name)
                   for f in dataclasses.fields(self.cfg)
                   if f.name != "dense_lr"
                   and getattr(self.cfg, f.name) != getattr(default, f.name)}
        if changed:
            raise ValueError(
                "MeshTowerTrainer runs dense adam at dense_lr and reads no "
                "other TrainerConfig field; got %s" % (changed,))
        if group is None and model.n_shards == 1:
            group = LOCAL
        self.group = group
        self.P = group_size(group)
        if self.P != model.n_shards:
            raise ValueError("the mp group has %d ranks, the model n_shards "
                             "%d" % (self.P, model.n_shards))
        self.mp_rank = group_rank(group)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.model = model
        self.feed = feed
        self.use_cvm = use_cvm
        self.table = PassTable(table_cfg, seed=seed, device=self.device)
        self.layout = self.table.layout
        if self.layout.expand_dim:
            raise ValueError("MeshTowerTrainer pulls no expand block; the "
                             "table has expand_embed_dim=%d"
                             % self.layout.expand_dim)
        self.num_slots = len(feed.used_sparse_slots())
        self.push_flags = push_flags or PushFlags()
        self.push_write = self.push_flags.resolve_push_write(
            table_cfg.pass_capacity, feed.key_capacity(), self.device)
        host_params, self.sharded = model.host_init(seed)
        self.tensors = {k: t.to(self.device).requires_grad_(True)
                        for k, t in tower_params_from_jax(
                            host_params, self.sharded, self.mp_rank).items()}
        self.dense_opt = make_dense_optimizer(self.cfg,
                                              list(self.tensors.values()))
        self.metrics = MetricRegistry()
        self._seed_gen = torch.Generator().manual_seed(seed + 13)
        self.seed_fn: Callable[[], int] = self._draw_seed
        self.pass_times: Dict[str, float] = {}

    def _draw_seed(self) -> int:
        return int(torch.randint(0, 2**31 - 1, (), generator=self._seed_gen))

    @property
    def params(self) -> Dict[str, np.ndarray]:
        """This rank's dense tensors by the reference's names, as numpy (a
        sharded leaf this rank's slice: convert.tower_params_to_jax stacks
        the ranks'); copies, which later steps leave as they are."""
        return {k: t.detach().cpu().numpy().copy()
                for k, t in self.tensors.items()}

    # ------------------------------------------------------------ host side
    def host_batch(self, b: PackedBatch) -> Dict[str, object]:
        """Host staging of one batch (reference :216-235): ids, segments,
        labels, ins_valid, n_valid (the packer's real key slots come
        first), and outside test mode the push's dedup (uids, perm, the
        segment offsets of each unique's real occurrences, n_uniq) and
        under 'rebuild' its [capacity] position map."""
        ids = self.table.lookup_ids(b.keys, b.valid)
        n_valid = int(b.valid.sum())
        out: Dict[str, object] = {
            "ids": ids, "segments": b.segments, "labels": b.labels,
            "ins_valid": b.ins_valid, "n_valid": n_valid}
        if not self.table.test_mode:
            uids, perm, inv, out["n_uniq"] = self.table.dedup_for_push(ids)
            out.update(uids=uids, perm=perm,
                       offsets=segment_offsets(inv, n_valid))
            if self.push_write == "rebuild":
                out["push_pos"] = self.table.pos_for_rebuild(uids)
        return out

    def device_batch(self, b: PackedBatch) -> Batch:
        """host_batch, one copy per array to the device."""
        return {k: (torch.from_numpy(v).to(self.device)
                    if isinstance(v, np.ndarray) else v)
                for k, v in self.host_batch(b).items()}

    # ---------------------------------------------------------------- steps
    def _pooled(self, slab: torch.Tensor, batch: Batch,
                grad: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        ids = batch["ids"]
        emb = pull_view_from_rows(gather_slab_rows(slab, ids, self.layout),
                                  self.layout).requires_grad_(grad)
        pooled = fused_seqpool_cvm(emb, batch["segments"],
                                   ids != self.table.padding_id,
                                   self.feed.batch_size, self.num_slots,
                                   batch["n_valid"], self.use_cvm)
        return emb, pooled

    def step(self, batch: Batch, seed: int):
        """One step on the live slab (reference :130-186): (loss, preds
        [B]) as device tensors. Updates the slab and this rank's tensors
        IN PLACE."""
        slab = self.table.slab
        S = self.num_slots
        emb, pooled = self._pooled(slab, batch, True)
        logits = self.model.apply_local(self.tensors, pooled, self.group)
        loss, preds = masked_bce(logits, batch["labels"], batch["ins_valid"])
        # the contract's first half: the replicated loss scales by 1/P
        # before the gradient
        loss = tp_loss_scale(loss, self.group)
        self.dense_opt.zero_grad(set_to_none=True)
        loss.backward()
        # the second half: each replicated leaf's partial gradient and the
        # embedding cotangent summed over the group once; the sharded
        # leaves' are exact
        fixed = tp_fix_grads({k: t.grad for k, t in self.tensors.items()},
                             self.sharded, self.group)
        for k, t in self.tensors.items():
            t.grad = fixed[k]
        demb = emb.grad
        all_reduce_(demb, self.group)
        self.dense_opt.step()
        segments, ids = batch["segments"], batch["ids"]
        pg = build_push_grads(demb, segments % S,
                              batch["labels"].index_select(0, segments // S),
                              ids != self.table.padding_id)
        conf = self.table.config.optimizer
        # the summed cotangent and a rank-free seed: the same push on
        # every rank, so the replicated slabs never diverge
        if self.push_write == "rebuild":
            push_sparse_rebuild(slab, batch["uids"], batch["push_pos"],
                                batch["perm"], batch["offsets"],
                                batch["n_uniq"], pg, seed, self.layout, conf)
        else:
            push_sparse_hostdedup(slab, batch["uids"], batch["perm"],
                                  batch["offsets"], batch["n_uniq"], pg,
                                  seed, self.layout, conf,
                                  write=self.push_write,
                                  block_rows=self.push_flags.push_block_rows)
        return loss.detach() * self.P, preds.detach()

    def train_batch(self, b: PackedBatch):
        """One step inside an open pass: (loss, preds [B]) as device
        tensors."""
        return self.step(self.device_batch(b), self.seed_fn())

    def eval_batch(self, b: PackedBatch) -> torch.Tensor:
        """Predictions [B] of one batch inside an open test-mode pass: the
        same model-parallel forward under no_grad, no push (reference
        :188-197)."""
        batch = self.device_batch(b)
        with torch.no_grad():
            _, pooled = self._pooled(self.table.slab, batch, False)
            return torch.sigmoid(self.model.apply_local(
                self.tensors, pooled, self.group))

    def train_pass(self, dataset: BoxDataset) -> Dict[str, float]:
        """One pass (reference :247-258): feed, begin_pass, a step a batch
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
        """Test-mode inference (SetTestMode: no creation, no push):
        (preds, labels) over the dataset's valid instances; the pass is
        closed on every exit."""
        return simple_predict_batches(self, dataset)
