"""Heterogeneous training: CPU workers offload the dense step to a service
on the card.

Counterpart of paddlebox_tpu/fleet/heter.py (HeterWrapper /
HeterXpuTrainer / HeterCpuWorker, heter_wrapper.{h,cc}): CPU-bound workers
run the data pipeline and the sparse PS traffic, and ship the dense
forward and backward to an accelerator service over the framed RPC
(utils/rpc.py, the brpc stand-in).

  * ``HeterDenseService`` owns a zoo model (a torch module, with its
    weights) and its torch.optim.Adam on its device (the card unless the
    caller asks for the CPU), and serves ``train_step`` and
    ``eval_step``, one at a time under one lock. A call carries the
    batch's pulled embedding view [K, 3+D] and its meta (segments, valid,
    ins_valid, labels, dense); ``train_step`` answers (the view's
    cotangent as an ndarray, the loss as a float, the predictions as an
    ndarray), ``eval_step`` the predictions. The dense update never leaves
    the service.
  * ``HeterTrainer`` is the CPU worker: a batch's np.unique pull from the
    PS, the view built on the host, the service's step, build_push_grads
    on the host (CPU tensors) and the raw push to the Communicator
    (ps/worker.py), as the Downpour worker's sparse machinery.

The split is at the pulled view, the tensor the reference ships between
heter workers. A frame is unpickled by ``ndarray_loads`` on both ends: it
resolves only the globals of an ndarray round trip, the PS server's
narrower rule, where the reference's service takes any global under
numpy. The reference's frames still cross both ways: its client reaches
this service, and this client the reference's service.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch.config.configs import (DataFeedConfig, TableConfig,
                                                TrainerConfig)
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.device import DeviceLike, resolve_device
from paddlebox_tpu_torch.embedding.accessor import PushLayout, ValueLayout
from paddlebox_tpu_torch.metrics.auc import MetricRegistry
from paddlebox_tpu_torch.ops.seqpool import fused_seqpool_cvm
from paddlebox_tpu_torch.ops.sparse import (build_push_grads,
                                            pull_view_from_rows)
from paddlebox_tpu_torch.ps.worker import Communicator, DownpourTrainer
from paddlebox_tpu_torch.train.dense_optim import make_dense_optimizer
from paddlebox_tpu_torch.train.eval_driver import feed_simple_metrics
from paddlebox_tpu_torch.train.trainer import forward_loss, is_multi_task
from paddlebox_tpu_torch.utils.lockwatch import make_lock
from paddlebox_tpu_torch.utils.rpc import (FramedClient, FramedServer,
                                           ndarray_loads)


class HeterDenseService:
    """The accelerator-side dense executor (the HeterXpuTrainer service
    role). ``model``: a single-task zoo model with its weights; Adam at
    ``dense_lr``; listens on (host, port), port 0 any free port
    (``self.port``). ``seed`` is the reference's weight seed, accepted and
    read by nothing: the port's model arrives with its weights, drawn by
    its own generator."""

    def __init__(self, model: torch.nn.Module, feed: DataFeedConfig,
                 dense_lr: float = 1e-3, use_cvm: bool = True, seed: int = 0,
                 host: str = "127.0.0.1", port: int = 0,
                 device: DeviceLike = None) -> None:
        if is_multi_task(model):
            raise ValueError("the heter service trains one task; %s has %s"
                             % (type(model).__name__,
                                getattr(model, "task_names", None)))
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.model = model.to(self.device)
        self.batch_size = feed.batch_size
        self.num_slots = len(feed.used_sparse_slots())
        self.use_cvm = use_cvm
        self.opt = make_dense_optimizer(TrainerConfig(dense_lr=dense_lr),
                                        self.model.parameters())
        # one optimizer stream: the workers' steps serialize here
        self._lock = make_lock("HeterDenseService._lock")
        self._rpc = FramedServer(self._handle, ndarray_loads, host, port)

    @property
    def port(self) -> int:
        return self._rpc.port

    def _forward(self, req: dict, grad: bool):
        """(view, loss, preds) of a request's view and batch on the
        device."""
        meta = req["batch"]
        dev = self.device
        emb = torch.from_numpy(np.asarray(req["emb"], np.float32)).to(dev)
        emb.requires_grad_(grad)
        batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
                 for k, v in meta.items()}
        # every key slot after the last valid one is padding
        live = np.flatnonzero(np.asarray(meta["valid"]))
        pooled = fused_seqpool_cvm(
            emb, batch["segments"], batch["valid"], self.batch_size,
            self.num_slots, self.use_cvm, sorted_segments=True,
            n_valid=int(live[-1]) + 1 if live.size else 0)
        loss, preds = forward_loss(self.model, pooled, batch)
        return emb, loss, preds

    def train_step(self, req: dict) -> Tuple[np.ndarray, float, np.ndarray]:
        with self._lock:
            emb, loss, preds = self._forward(req, True)
            self.opt.zero_grad(set_to_none=True)
            loss.backward()
            self.opt.step()
            return (emb.grad.cpu().numpy(), float(loss.detach()),
                    preds.detach().cpu().numpy())

    def eval_step(self, req: dict) -> np.ndarray:
        with self._lock, torch.no_grad():
            return self._forward(req, False)[2].cpu().numpy()

    def _handle(self, req: dict) -> Any:
        method = req["method"]
        if method == "__stop__":
            # the listener closes; this frame still gets its answer
            self._rpc.stop()
            return True
        if method == "train_step":
            return self.train_step(req)
        if method == "eval_step":
            return self.eval_step(req)
        raise ValueError("unknown heter method %r" % (method,))

    def stop(self) -> None:
        """Stop serving: the listener and every live connection."""
        self._rpc.stop(hang_up=True)


class HeterDenseClient:
    def __init__(self, host: str, port: int, timeout: float = 300.0) -> None:
        self._rpc = FramedClient(host, port, ndarray_loads, timeout)

    def train_step(self, emb: np.ndarray, batch: Dict[str, np.ndarray]
                   ) -> Tuple[np.ndarray, float, np.ndarray]:
        return self._rpc.call({"method": "train_step", "emb": emb,
                               "batch": batch})

    def eval_step(self, emb: np.ndarray,
                  batch: Dict[str, np.ndarray]) -> np.ndarray:
        return self._rpc.call({"method": "eval_step", "emb": emb,
                               "batch": batch})

    def stop_server(self) -> None:
        try:
            self._rpc.call({"method": "__stop__"})
        except (ConnectionError, OSError):
            pass

    def close(self) -> None:
        self._rpc.close()


class HeterTrainer:
    """The CPU worker (the HeterCpuWorker role): the data pipeline and the
    PS's sparse traffic here, the dense step on the service ``heter`` (a
    HeterDenseClient, or the reference's). ``sync_comm=True`` flushes the
    sparse pushes every batch, so that the next batch's pull reads them:
    the deterministic mode of DownpourTrainer's Communicator, which the
    reference's HeterTrainer does not offer (its pushes reach the server
    when the Communicator's thread sends them)."""

    SPARSE_TABLE = DownpourTrainer.SPARSE_TABLE

    def __init__(self, ps_client, heter, table_cfg: TableConfig,
                 feed: DataFeedConfig, seed: int = 0,
                 create_tables: bool = True,
                 sync_comm: bool = False) -> None:
        self.client = ps_client
        self.heter = heter
        self.feed = feed
        self.layout = ValueLayout(table_cfg.embedx_dim,
                                  table_cfg.optimizer.optimizer)
        self.push_layout = PushLayout(self.layout.embedx_dim)
        self.num_slots = len(feed.used_sparse_slots())
        self.metrics = MetricRegistry()
        if create_tables:
            ps_client.create_sparse_table(self.SPARSE_TABLE, table_cfg,
                                          seed=seed)
        self.communicator = Communicator(ps_client, self.SPARSE_TABLE,
                                         self.push_layout.width)
        self.sync_comm = sync_comm
        self._shuffle_rng = np.random.RandomState(seed + 1)

    # -------------------------------------------------------------- batches
    def _pull_view(self, b, create: bool = True
                   ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """FillSparseValue on the CPU worker: the batch's PS rows -> the
        pull view [K, 3+D] (show, click, embed_w, embedx; zero on padding)
        and the batch's meta. create=False is the test-mode pull: nothing
        is inserted on the server."""
        uniq, inv = np.unique(b.keys[b.valid], return_inverse=True)
        rows = self.client.pull_sparse(self.SPARSE_TABLE, uniq,
                                       create=create)
        view = pull_view_from_rows(torch.from_numpy(rows),
                                   self.layout).numpy()
        emb = np.zeros((b.keys.shape[0], view.shape[1]), np.float32)
        emb[b.valid] = view[inv]
        batch = {"segments": b.segments, "valid": b.valid,
                 "ins_valid": b.ins_valid, "labels": b.labels}
        if b.dense is not None:
            batch["dense"] = b.dense
        return emb, batch

    def train_pass(self, dataset: BoxDataset) -> Dict[str, float]:
        """One pass (reference heter.py:211-234): a local shuffle, then a
        batch at a time the pull, the service's train_step and the raw
        push; the Communicator flushed at the end."""
        if len(dataset) == 0:
            dataset.load_into_memory()
        dataset.local_shuffle(self._shuffle_rng.randint(1 << 31))
        losses = []
        for b in dataset.split_batches(num_workers=1)[0]:
            emb, batch = self._pull_view(b)
            demb, loss, preds = self.heter.train_step(emb, batch)
            clicks = b.labels[b.segments // self.num_slots]
            push_rows = build_push_grads(
                torch.from_numpy(np.array(demb, np.float32)),
                torch.from_numpy(b.slots), torch.from_numpy(clicks),
                torch.from_numpy(b.valid)).numpy()
            self.communicator.push(b.keys[b.valid], push_rows[b.valid])
            if self.sync_comm:
                self.communicator.flush()
            losses.append(float(loss))
            feed_simple_metrics(self.metrics, preds, b)
        self.communicator.flush()
        return {"loss": float(np.mean(losses)) if losses else 0.0,
                "batches": len(losses), "instances": len(dataset)}

    def predict_pass(self, dataset: BoxDataset
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Test-mode inference: create=False pulls (nothing inserted on
        the server) and the service's eval_step; (preds, labels) over the
        valid instances."""
        if len(dataset) == 0:
            dataset.load_into_memory()
        preds_all, labels_all = [], []
        for b in dataset.split_batches(num_workers=1)[0]:
            emb, batch = self._pull_view(b, create=False)
            preds = np.asarray(self.heter.eval_step(emb, batch))
            preds_all.append(preds[b.ins_valid])
            labels_all.append(b.labels[b.ins_valid])
        if not preds_all:
            return np.empty(0, np.float32), np.empty(0, np.int32)
        return np.concatenate(preds_all), np.concatenate(labels_all)

    def close(self) -> None:
        self.communicator.stop()
