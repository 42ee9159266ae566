"""Pass-cadenced single-device trainer.

Counterpart of paddlebox_tpu/train/trainer.py (make_train_step :543-742,
eval_step :887-893, BoxTrainer :914-1000, host_batch :1149-1208, train_pass
:1220-1402, predict_batches :1527-1549) for one GPU: a Python loop of steps,
each

    pull (slab row gather) -> fused seqpool+CVM -> DeepFM forward/backward
    (autograd) -> masked BCE -> dense Adam -> build_push_grads -> push
    (the fused push_adagrad kernel: merge, update, row write; in blocked
    mode it returns the rows and the blocked_write kernel places them)

around the pass lifecycle feed -> begin_pass -> train -> metrics ->
end_pass (incremental by default: PassFlags, embedding/pass_table.py;
train/preload.py overlaps the next pass's feed with this one's steps). The
slab is updated in place (the JAX step donates it). Losses
and predictions stay on the device until the pass ends, then come back in
one copy each: no per-step host sync.

Every step's push takes an int32 seed for the creation hash. The trainer
draws it from its own ``torch.Generator(seed)`` through ``seed_fn``; a caller
may replace ``seed_fn`` (any zero-argument callable returning a nonnegative
int32), which is how the parity tests replay the JAX trainer's per-step
seeds.

An eval step (``make_eval_step``, ``predict_batches``) is the pull, the
fused seqpool+CVM and the forward under ``torch.no_grad()``: no backward,
no dense update, no push. The dense state reads and restores as numpy under
the JAX package's names (``params``, ``opt_state``, ``restore_dense``;
convert.py).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from paddlebox_tpu_torch.config.configs import (DataFeedConfig, TableConfig,
                                                TrainerConfig)
from paddlebox_tpu_torch.config.flags import PassFlags, PushFlags
from paddlebox_tpu_torch.convert import (adam_state_from_numpy,
                                         adam_state_to_numpy,
                                         params_from_jax, params_to_numpy)
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

Batch = Dict[str, object]


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


def make_train_step(model: torch.nn.Module, layout: ValueLayout,
                    table: TableConfig, dense_opt: torch.optim.Optimizer,
                    batch_size: int, num_slots: int,
                    push_write: str = "scatter",
                    block_rows: int = 1024) -> Callable:
    """step(slab, batch, seed) -> (loss, preds), device tensors. Updates
    ``slab`` and the model's parameters IN PLACE. ``batch`` is a
    device_batch dict."""
    conf = table.optimizer
    padding_id = table.pass_capacity - 1

    def step(slab: torch.Tensor, batch: Batch, seed: int):
        ids = batch["ids"]
        segments = batch["segments"]
        # per-key validity is derived: padding key slots (and only those)
        # address the trash row
        valid = ids != padding_id
        rows = gather_slab_rows(slab, ids)
        emb = pull_view_from_rows(rows, layout).requires_grad_(True)
        pooled = fused_seqpool_cvm(emb, segments, valid, batch_size,
                                   num_slots, batch["n_valid"])
        logits = model(pooled)
        loss, preds = masked_bce(logits, batch["labels"], batch["ins_valid"])
        dense_opt.zero_grad(set_to_none=True)
        loss.backward()
        dense_opt.step()
        # per-key click = its instance's label
        clicks = batch["labels"].index_select(0, segments // num_slots)
        push_grads = build_push_grads(emb.grad, segments % num_slots,
                                      clicks, valid)
        push_sparse_hostdedup(slab, batch["uids"], batch["perm"],
                              batch["offsets"], batch["n_uniq"], push_grads,
                              seed, layout, conf, write=push_write,
                              block_rows=block_rows)
        return loss.detach(), preds.detach()

    return step


def make_eval_step(model: torch.nn.Module, layout: ValueLayout,
                   table: TableConfig, batch_size: int,
                   num_slots: int) -> Callable:
    """eval_step(slab, batch) -> preds [batch_size] on the device: the
    pull, fused seqpool+CVM and the forward, and nothing that writes."""
    padding_id = table.pass_capacity - 1

    def eval_step(slab: torch.Tensor, batch: Batch) -> torch.Tensor:
        ids = batch["ids"]
        with torch.no_grad():
            emb = pull_view_from_rows(gather_slab_rows(slab, ids), layout)
            pooled = fused_seqpool_cvm(emb, batch["segments"],
                                       ids != padding_id, batch_size,
                                       num_slots, batch["n_valid"])
            return torch.sigmoid(model(pooled))

    return eval_step


class BoxTrainer:
    """Single-device trainer over one PassTable + model."""

    def __init__(self, model: torch.nn.Module, table_cfg: TableConfig,
                 feed: DataFeedConfig,
                 trainer_cfg: Optional[TrainerConfig] = None,
                 seed: int = 0,
                 flags: Optional[PushFlags] = None,
                 device: DeviceLike = None,
                 pass_flags: Optional[PassFlags] = None,
                 store=None) -> None:
        """``store``: the table's host store (PassTable's default, the
        native one, when None)."""
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # f32 stays f32: no TF32 in matmuls or convolutions
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg = trainer_cfg or TrainerConfig()
        self.flags = flags or PushFlags()
        self.feed = feed
        self.table = PassTable(table_cfg, seed=seed, device=self.device,
                               flags=pass_flags, store=store)
        self.model = model.to(self.device)
        self.metrics = MetricRegistry()
        self.num_slots = len(feed.used_sparse_slots())
        self.push_write = self.flags.resolve_push_write(
            table_cfg.pass_capacity)
        # the same update as optax.adam(lr) (b1 0.9, b2 0.999, eps 1e-8);
        # its state starts at zero, as optax's does
        self.dense_opt = torch.optim.Adam(self.model.parameters(),
                                          lr=self.cfg.dense_lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.step_fn = make_train_step(
            self.model, self.table.layout, table_cfg, self.dense_opt,
            feed.batch_size, self.num_slots, push_write=self.push_write,
            block_rows=self.flags.push_block_rows)
        self.eval_fn = make_eval_step(self.model, self.table.layout,
                                      table_cfg, feed.batch_size,
                                      self.num_slots)
        self._shuffle_rng = np.random.RandomState(seed + 1)
        self._seed_gen = torch.Generator().manual_seed(seed)
        self.seed_fn: Callable[[], int] = self._draw_seed
        self._step_count = 0
        self.pass_times: Dict[str, float] = {}

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

    # ---------------------------------------------------------- dense state
    @property
    def params(self) -> Dict[str, np.ndarray]:
        """The dense parameters by the JAX package's names, as numpy."""
        return params_to_numpy(self.model)

    @property
    def opt_state(self) -> Dict[str, object]:
        """The dense Adam state under optax's names, as numpy
        (convert.adam_state_to_numpy)."""
        return adam_state_to_numpy(self.model, self.dense_opt)

    def restore_dense(self, params: Mapping[str, np.ndarray],
                      opt_state: Mapping) -> None:
        """Set the dense parameters and Adam state from ``params`` and
        ``opt_state`` (the forms of the two properties), bit for bit."""
        state = params_from_jax(params)
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(state[name])
        adam_state_from_numpy(self.model, self.dense_opt, opt_state)

    # ---------------------------------------------------------- batch utils
    def device_batch(self, b: PackedBatch, ids: np.ndarray) -> Batch:
        """Host staging of one batch, then one copy per array to the
        device: ids and the push's sorted dedup products (uids, perm and
        the segment offsets of each unique's real occurrences), plus two
        ints: n_uniq (real uids) and n_valid (real key slots; the packer
        puts them before its padding tail). In test mode the batch never
        pushes, so it carries no dedup products and no n_uniq."""
        n_valid = int(b.valid.sum())
        host = {"ids": ids, "segments": b.segments,
                "ins_valid": b.ins_valid, "labels": b.labels}
        ints = {"n_valid": n_valid}
        if not self.table.test_mode:
            uids, perm, inv, ints["n_uniq"] = self.table.dedup_for_push(ids)
            host.update(uids=uids, perm=perm,
                        offsets=segment_offsets(inv, n_valid))
        out: Batch = {k: torch.from_numpy(v).to(self.device)
                      for k, v in host.items()}
        out.update(ints)
        return out

    def train_batch(self, b: PackedBatch):
        """One step on one packed batch inside an open pass: (loss, preds)
        as device tensors."""
        ids = self.table.lookup_ids(b.keys, b.valid)
        batch = self.device_batch(b, ids)
        loss, preds = self.step_fn(self.table.slab, batch, self.seed_fn())
        self._step_count += 1
        return loss, preds

    # ---------------------------------------------------------- pass cadence
    def train_pass(self, dataset: BoxDataset,
                   preloaded: bool = False) -> Dict[str, float]:
        """One full pass: feed -> build -> train -> metrics -> end.

        ``preloaded``: the dataset is loaded and the table's feed pass is
        done (train.preload.PassPreloader.wait), so the feed is skipped.

        ``self.pass_times`` then holds the host-clock seconds of its phases:
        feed (load + key registration; absent when preloaded), build
        (begin_pass + shuffle + packing), steps (host staging + enqueue of
        every step) and end (end_pass + metrics; it waits for the device
        work still queued)."""
        clock = [time.perf_counter()]
        times: Dict[str, float] = {}

        def lap(name: str) -> None:
            now = time.perf_counter()
            times[name] = now - clock[0]
            clock[0] = now

        if not preloaded:
            self.table.begin_feed_pass()
            dataset.load_into_memory(add_keys_fn=self.table.add_keys)
            self.table.end_feed_pass()
            lap("feed")
        self.table.begin_pass()
        dataset.local_shuffle(self._shuffle_rng.randint(1 << 31))
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
            loss_host = torch.stack(losses).cpu().numpy()
            mean_loss = float(np.mean(loss_host))
            if self.metrics.metric_names():
                preds_host = torch.stack(preds).cpu().numpy()
                for b, p in zip(batches, preds_host):
                    self._add_metrics(p, b)
        lap("end")
        self.pass_times = times
        return {"loss": mean_loss, "batches": len(batches),
                "instances": len(dataset)}

    # ------------------------------------------------------------------ eval
    def eval_batch(self, b: PackedBatch) -> torch.Tensor:
        """Predictions of one packed batch inside an open test-mode pass,
        on the device."""
        ids = self.table.lookup_ids(b.keys, b.valid)
        return self.eval_fn(self.table.slab, self.device_batch(b, ids))

    def predict_batches(self, dataset: BoxDataset
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Test-mode inference over a loaded dataset (SetTestMode pulls):
        (preds, labels) of its valid instances, on the host. The pass
        creates no feature and writes nothing back."""
        self.table.set_test_mode(True)
        self.table.begin_feed_pass()
        self.table.add_keys(dataset.all_keys())
        self.table.end_feed_pass()
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

    def _add_metrics(self, pred: np.ndarray, b: PackedBatch) -> None:
        self.metrics.add_batch({"label": b.labels, "mask": b.ins_valid,
                                "pred": pred})
