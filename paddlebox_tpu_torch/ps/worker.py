"""The CPU-PS training loop: the Downpour worker.

Counterpart of paddlebox_tpu/ps/worker.py (DownpourWorker::TrainFiles,
framework/downpour_worker.cc, the CPU-PS counterpart of the Box loop). A
batch pulls its features' rows from the PS, steps on the card, and pushes
RAW sparse gradients back: the sparse rule runs on the server
(ps/sgd_rule.py in numpy), not in a slab. The dense gradient goes to a PS
dense table (the server's Adam) through the same client. A batch is

    np.unique of its valid keys -> pull_sparse from the PS -> a per-batch
    slab of the pulled rows and one trash row [n_uniq + 1, width], copied
    to the card -> gather_rows of the batch's ids -> fused seqpool+CVM ->
    the model -> masked BCE -> autograd -> build_push_grads -> the raw
    push rows of the valid keys to the Communicator, the flat dense
    gradient (convert.flatten_params' order: the reference's
    ravel_pytree order) to the dense table

The pass shuffles with ``dataset.local_shuffle`` from a RandomState of
seed + 1, as the reference's, and steps one batch at a time in that
order. ``sync_comm=True`` flushes the sparse pushes and refreshes the
dense vector every batch: the deterministic mode (the Communicator's sync
mode, communicator.h). The machinery beside the loop is the reference's:

  * ``Communicator``: sparse pushes queue, merge by key and flush on a
    batch-count threshold from a background thread
    (distributed/ps/service/communicator/communicator.{h,cc});
  * ``PullDenseWorker``: the dense vector refreshed in the background
    (framework/pull_dense_worker.cc).

The model is a torch module of one task; its initial parameters become
the dense table's vector (``create_tables``), and each step loads the
vector the worker holds into it.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch.config.configs import (DataFeedConfig, TableConfig,
                                                TrainerConfig)
from paddlebox_tpu_torch.convert import (dense_state, flat_names,
                                         flatten_params, unflatten_params)
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.device import DeviceLike, resolve_device
from paddlebox_tpu_torch.embedding.accessor import PushLayout, ValueLayout
from paddlebox_tpu_torch.metrics.auc import MetricRegistry
from paddlebox_tpu_torch.ops.seqpool import fused_seqpool_cvm
from paddlebox_tpu_torch.ops.sparse import (build_push_grads,
                                            gather_slab_rows,
                                            pull_view_from_rows)
from paddlebox_tpu_torch.train.eval_driver import feed_simple_metrics
from paddlebox_tpu_torch.train.trainer import (forward_loss, is_multi_task,
                                               model_logits)
from paddlebox_tpu_torch.utils.lockwatch import make_lock


class Communicator:
    def __init__(self, client, table_id: int, push_width: int,
                 send_batch_threshold: int = 4,
                 send_interval: float = 0.05) -> None:
        self.client = client
        self.table_id = table_id
        self.push_width = push_width
        self.threshold = send_batch_threshold
        self.interval = send_interval
        self._pending: List[Tuple[np.ndarray, np.ndarray]] = []  # guarded-by: _lock
        self._lock = make_lock("Communicator._lock")
        self._send_lock = make_lock("Communicator._send_lock")
        self._stop = threading.Event()
        self._kick = threading.Event()
        self._thread = threading.Thread(target=self._send_loop, daemon=True,
                                        name="ps-communicator")
        self._thread.start()

    def push(self, keys: np.ndarray, grads: np.ndarray) -> None:
        with self._lock:
            self._pending.append((keys, grads))
            n = len(self._pending)
        if n >= self.threshold:
            self._kick.set()

    def _drain(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        with self._lock:
            if not self._pending:
                return None
            batch, self._pending = self._pending, []
        keys = np.concatenate([k for k, _ in batch])
        grads = np.concatenate([g for _, g in batch])
        # merge duplicate keys first: one row a key reaches the PS
        uniq, inv = np.unique(keys, return_inverse=True)
        merged = np.zeros((uniq.size, grads.shape[1]), np.float32)
        np.add.at(merged, inv, grads)
        # the slot is a tag, not additive
        merged[inv, PushLayout.SLOT] = grads[:, PushLayout.SLOT]
        return uniq, merged

    def _send(self) -> None:
        # one send at a time: a flush returns only after a send the
        # background thread had begun has reached the server too
        with self._send_lock:
            item = self._drain()
            if item is not None:
                self.client.push_sparse(self.table_id, item[0], item[1])

    def _send_loop(self) -> None:
        while not self._stop.is_set():
            self._kick.wait(self.interval)
            self._kick.clear()
            self._send()

    def flush(self) -> None:
        """Send every queued push; on return the server holds them all."""
        self._send()

    def stop(self) -> None:
        self._stop.set()
        self._kick.set()
        self._thread.join()
        self.flush()


class PullDenseWorker:
    def __init__(self, client, name: str, interval: float = 0.05) -> None:
        self.client = client
        self.name = name
        self.interval = interval
        self._value = client.pull_dense(name)  # guarded-by: _lock
        self._lock = make_lock("PullDenseWorker._lock")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ps-pull-dense")
        self._thread.start()

    @property
    def value(self) -> np.ndarray:
        with self._lock:
            return self._value

    def refresh(self) -> np.ndarray:
        v = self.client.pull_dense(self.name)
        with self._lock:
            self._value = v
        return v

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.refresh()
            except (ConnectionError, OSError, RuntimeError):
                return

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()


class DownpourTrainer:
    """A per-batch PS pull / PS push trainer. The client is a PsLocalClient
    (one process) or a TcpPSClient (a server), as the reference's tests
    use both (ps_local_client.h against the brpc service)."""

    DENSE_TABLE = "downpour_dense"
    SPARSE_TABLE = 0

    def __init__(self, model: torch.nn.Module, table_cfg: TableConfig,
                 feed: DataFeedConfig, client,
                 trainer_cfg: Optional[TrainerConfig] = None,
                 seed: int = 0, create_tables: bool = True,
                 use_cvm: bool = True, sync_comm: bool = False,
                 device: DeviceLike = None) -> None:
        """sync_comm=True flushes the sparse pushes and refreshes the dense
        vector every batch (deterministic, without the asynchronous
        overlap). ``device``: where the steps run, the card unless the
        caller asks for the CPU."""
        if is_multi_task(model):
            raise ValueError("the Downpour step trains one task; %s has %s"
                             % (type(model).__name__,
                                getattr(model, "task_names", None)))
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.model = model.to(self.device)
        self.cfg = trainer_cfg or TrainerConfig()
        self.feed = feed
        self.client = client
        self.table_cfg = table_cfg
        self.use_cvm = use_cvm
        self.layout = ValueLayout(table_cfg.embedx_dim,
                                  table_cfg.optimizer.optimizer)
        self.push_layout = PushLayout(self.layout.embedx_dim)
        self.metrics = MetricRegistry()
        self.num_slots = len(feed.used_sparse_slots())
        flat0 = flatten_params(self.model)
        if create_tables:
            client.create_sparse_table(self.SPARSE_TABLE, table_cfg,
                                       seed=seed)
            client.create_dense_table(self.DENSE_TABLE,
                                      size=int(flat0.size), rule="adam",
                                      lr=self.cfg.dense_lr, init=flat0)
        self.pull_dense_worker = PullDenseWorker(client, self.DENSE_TABLE)
        self.communicator = Communicator(client, self.SPARSE_TABLE,
                                         self.push_layout.width)
        self.sync_comm = sync_comm
        self._shuffle_rng = np.random.RandomState(seed + 1)
        # the flat gradient's leaves in flatten_params' order
        tensors = dict(dense_state(self.model))
        self._flat = [tensors[n] for n in flat_names(self.model)]
        self.pass_times: Dict[str, float] = {}

    # ------------------------------------------------------------------ step
    def _pull(self, slab: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return pull_view_from_rows(gather_slab_rows(slab, ids, self.layout),
                                   self.layout)

    def _pooled(self, emb: torch.Tensor, batch: Dict) -> torch.Tensor:
        return fused_seqpool_cvm(emb, batch["segments"], batch["valid"],
                                 self.feed.batch_size, self.num_slots,
                                 self.use_cvm, sorted_segments=True,
                                 n_valid=batch["n_valid"])

    def _step(self, slab: torch.Tensor, batch: Dict):
        """(flat dense grad, push rows [K, push width], loss, preds [B]),
        device tensors."""
        emb = self._pull(slab, batch["ids"]).requires_grad_(True)
        for t in self._flat:
            t.grad = None
        loss, preds = forward_loss(self.model, self._pooled(emb, batch),
                                   batch)
        loss.backward()
        flat_g = torch.cat([(t.grad if t.grad is not None
                             else torch.zeros_like(t)).reshape(-1)
                            for t in self._flat])
        segments = batch["segments"]
        clicks = batch["labels"].index_select(0, segments // self.num_slots)
        push_rows = build_push_grads(emb.grad, batch["slots"], clicks,
                                     batch["valid"])
        return flat_g, push_rows, loss.detach(), preds.detach()

    # ------------------------------------------------------------- pass loop
    def _prepare_batch(self, b, create: bool = True):
        """FillSparseValue (downpour_worker.cc): the batch's keys -> the
        PS's rows -> (the per-batch slab on the device, the batch's
        leaves on the device with ids into that slab)."""
        uniq, inv = np.unique(b.keys[b.valid], return_inverse=True)
        rows = self.client.pull_sparse(self.SPARSE_TABLE, uniq,
                                       create=create)
        slab = np.vstack([rows,
                          np.zeros((1, self.layout.width), np.float32)])
        ids = np.full(b.keys.shape[0], rows.shape[0], np.int32)
        ids[b.valid] = inv
        dev = self.device
        batch = {"ids": torch.from_numpy(ids).to(dev),
                 "slots": torch.from_numpy(b.slots).to(dev),
                 "segments": torch.from_numpy(b.segments).to(dev),
                 "valid": torch.from_numpy(b.valid).to(dev),
                 "ins_valid": torch.from_numpy(b.ins_valid).to(dev),
                 "labels": torch.from_numpy(b.labels).to(dev),
                 "n_valid": int(b.valid.sum())}
        if b.dense is not None:
            batch["dense"] = torch.from_numpy(b.dense).to(dev)
        return torch.from_numpy(slab).to(dev), batch

    def train_pass(self, dataset: BoxDataset) -> Dict[str, float]:
        if len(dataset) == 0:
            dataset.load_into_memory()
        dataset.local_shuffle(self._shuffle_rng.randint(1 << 31))
        losses: List[torch.Tensor] = []
        for b in dataset.split_batches(num_workers=1)[0]:
            slab, batch = self._prepare_batch(b)
            dense = (self.pull_dense_worker.refresh() if self.sync_comm
                     else self.pull_dense_worker.value)
            unflatten_params(self.model, dense)
            flat_g, push_rows, loss, preds = self._step(slab, batch)
            push_rows = push_rows.cpu().numpy()
            self.communicator.push(b.keys[b.valid], push_rows[b.valid])
            if self.sync_comm:
                self.communicator.flush()
            # the dense push is a host RPC: the gradient comes to the host
            # every batch, as the reference's
            self.client.push_dense(self.DENSE_TABLE, flat_g.cpu().numpy())
            losses.append(loss)
            feed_simple_metrics(self.metrics, preds.cpu().numpy(), b)
        self.communicator.flush()
        self.pull_dense_worker.refresh()
        mean = (float(np.mean(torch.stack(losses).cpu().numpy()))
                if losses else 0.0)
        return {"loss": mean, "batches": len(losses),
                "instances": len(dataset)}

    def predict_pass(self, dataset: BoxDataset):
        """Test-mode inference (SetTestMode pulls, box_wrapper.cc:183): the
        forward alone over create=False pulls (a missing key reads as a
        zero row, nothing is created on the server), no push. Returns
        (preds, labels) over the valid instances."""
        if len(dataset) == 0:
            dataset.load_into_memory()
        preds_all, labels_all = [], []
        unflatten_params(self.model, self.pull_dense_worker.refresh())
        for b in dataset.split_batches(num_workers=1)[0]:
            slab, batch = self._prepare_batch(b, create=False)
            with torch.no_grad():
                logits = model_logits(self.model, self._pooled(
                    self._pull(slab, batch["ids"]), batch),
                    dense=batch.get("dense"))
                preds = torch.sigmoid(logits).cpu().numpy()
            preds_all.append(preds[b.ins_valid])
            labels_all.append(b.labels[b.ins_valid])
        if not preds_all:
            return np.empty(0, np.float32), np.empty(0, np.int32)
        return np.concatenate(preds_all), np.concatenate(labels_all)

    def close(self) -> None:
        self.communicator.stop()
        self.pull_dense_worker.stop()
