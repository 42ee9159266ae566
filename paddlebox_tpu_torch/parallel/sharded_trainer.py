"""The sharded trainer: one process a GPU over a key-mod ShardedPassTable.

Counterpart of paddlebox_tpu/parallel/sharded_trainer.py (the BoxPS
topology: one worker a GPU, a key-mod sharded embedding table pulled and
pushed through an all-to-all, a data-parallel dense allreduce). The
reference runs one shard_map'd step over a P-device mesh; the port runs
one process a rank over torch.distributed (parallel/mesh.py ShardMesh:
NCCL on the card, gloo on the CPU), rank = shard = mesh position, and
every collective is called at every world size, one included.

A pass (``train_pass``, reference :878-1048), on every rank:

  1. feed: this rank's files, then end_feed_pass(allgather=fleet.
     all_gather): the feed keys' union, so every rank routes alike;
  2. build: the owned shard's slab, pass_capacity / P rows, with the
     incremental lifecycle (parallel/sharded_table.py);
  3. split: split_batches(1, equalize=fleet.equalize_batches()): every
     rank steps the same number of times (short ranks wrap around);
  4. stage, a step at a time on the stager thread (``shard_batches``,
     reference :807-876): bucketize on the routing pool (ShardFlags.
     stager_threads steps ahead), then in step order the host exchange of
     the buckets (fleet MeshComm: this rank learns the ids every source
     pulls from its shard), the owned shard's push dedup
     (stage_push_dedup: uids, perm, offsets) and the bucket merge's
     order (each slot's occurrences ascending), and the step's copies to
     the device; ShardFlags.stream_depth steps are queued ahead;
  5. step (reference _pull_and_forward :331-418 and shard_step
     :449-641): the incoming ids' rows by gather_rows on the shard slab,
     the values' all-to-all back (the first device collective), restore,
     fused_seqpool_cvm, the forward and backward; the dense grads and the
     loss in one all_reduce (the second), divided by P, then the same
     dense step on every rank (and a data_norm model's summaries
     all-reduced and divided by P); build_push_grads, the bucket merge
     (merge_push_grads, a sorted segment sum: no atomics, so a step's
     result does not vary from run to run), the push rows' all-to-all
     (the third), and the fused push_adagrad on the owned shard with the
     host-staged dedup and this rank's seed;
  6. pass end: metrics (cluster-wide through get_metric_msg(name,
     allreduce=fleet.metric_allreduce())), the owned shard's touched-row
     write-back on gather_rows, check_need_limit_mem.

With ``scan_chunk > 1`` the steps go through the port's chunk driver
(train/trainer.py run_scan_chunks) as the reference's _scan_steps does,
its steps queued back to back and a chunk's losses read once; chunked
and per-step passes are bit-identical. ``predict_batches`` (reference
:1050-1127) is the pull, pool and forward under no_grad in test mode.

The push seeds: ``seed_fn`` (a zero-argument callable returning a
nonnegative int32), called on the thread that queues the steps, once a
step in step order; by default a torch.Generator seeded from (seed,
rank). The creation hash reads the shard-local row id. The parity tests
replay the reference's per-shard seeds through it.

Dense state: the ranks' models start from rank 0's parameters and buffers
(one broadcast at construction) and stay replicas; ``params`` /
``opt_state`` (``merged_params`` / ``merged_opt_state``) are this rank's
copy under the JAX package's names (convert.py).

Not ported yet, refused with NotImplementedError naming the ROADMAP.md
item, as the reference refuses what it does not do (:101-106, 160-168):
sync_mode k_step and sharding (ZeRO-1), a 2-D mesh and sync_one_ring, an
a2a_dtype other than float32, the expand block, metrics collected on the
device, a store_factory (the CPU PS), and the push writes blocked and
rebuild and the lean wires. The bf16 slab (DtypeFlags.slab_embed_dtype)
is the shard's, as the single-device table's: the pull decodes, the push
decodes and encodes in its kernel, the values' a2a carries f32.
sparse_chunk_sync and async dense raise ValueError as in the reference.
"""

from __future__ import annotations

import collections
import queue
import sys
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from paddlebox_tpu_torch.config.configs import (DataFeedConfig, TableConfig,
                                                TrainerConfig)
from paddlebox_tpu_torch.config.flags import (DtypeFlags, ObsFlags,
                                              PassFlags, PushFlags,
                                              ShardFlags, StageFlags)
from paddlebox_tpu_torch.convert import (dense_state, params_to_numpy)
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.data.packer import PackedBatch
from paddlebox_tpu_torch.device import DeviceLike
from paddlebox_tpu_torch.embedding.optimizers import push_sparse_hostdedup
from paddlebox_tpu_torch.embedding.push_kernels import merge_push_grads
from paddlebox_tpu_torch.fleet.fleet import Fleet
from paddlebox_tpu_torch.fleet.fleet import fleet as default_fleet
from paddlebox_tpu_torch.metrics import drift, quality
from paddlebox_tpu_torch.metrics.auc import MetricRegistry
from paddlebox_tpu_torch.obs import device as device_obs
from paddlebox_tpu_torch.obs import log as obs_log
from paddlebox_tpu_torch.obs import make_step_reporter
from paddlebox_tpu_torch.obs.tracer import set_trace, span, step_trace_id
from paddlebox_tpu_torch.ops.seqpool import fused_seqpool_cvm
from paddlebox_tpu_torch.ops.sparse import (build_push_grads,
                                            gather_slab_rows,
                                            pull_view_from_rows)
from paddlebox_tpu_torch.parallel.mesh import ShardMesh
from paddlebox_tpu_torch.parallel.sharded_table import (
    ShardedPassTable, exchange_incoming_p2p, stage_push_dedup)
from paddlebox_tpu_torch.parallel.sharding import resolve_sharding_policy
from paddlebox_tpu_torch.train.dense_optim import (make_dense_optimizer,
                                                   opt_state_to_numpy)
from paddlebox_tpu_torch.train.dump import DumpWriter
from paddlebox_tpu_torch.train.trainer import (STAGER_GRACE_S, BatchOutputs,
                                               forward_loss,
                                               is_multi_task,
                                               is_summary_name,
                                               preds_row, preds_to_host,
                                               run_scan_chunks, stack_preds,
                                               task_label, task_names,
                                               uses_data_norm, uses_expand)
from paddlebox_tpu_torch.utils.profiler import timer_report
from paddlebox_tpu_torch.utils.timer import Timer

# the ROADMAP.md A10 items that port what the trainer refuses
TODO_DENSE_SYNC = "ROADMAP.md A10: K-step and ZeRO-1"
TODO_2D_MESH = "ROADMAP.md A10: the 2-D mesh and sync_one_ring"
TODO_BF16_EXPAND = ("ROADMAP.md A10: the bf16 a2a and the expand block "
                    "under sharding")
TODO_DEVICE_METRICS = "ROADMAP.md A10: device-collect metrics"
TODO_PS = "ROADMAP.md A10: the CPU PS (ps/*, embedding/ps_store.py)"
TODO_WRITES = ("ROADMAP.md A10: the sharded push writes blocked and "
               "rebuild")

Staged = Dict[str, object]


def rank_seed(seed: int, rank: int) -> int:
    """The default push-seed generator's seed of ``rank``: a mix of
    (seed, rank)."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(
        1, np.uint64)[0] & np.uint64(2**63 - 1))


class ShardedBoxTrainer(BatchOutputs):
    """One rank of the sharded trainer (module docstring). Its batches feed
    this rank's metrics, quality and drift planes and dump writer
    (BatchOutputs); the cross-rank reduction is get_metric_msg's
    ``allreduce``."""

    def __init__(self, model: torch.nn.Module, table_cfg: TableConfig,
                 feed: DataFeedConfig,
                 trainer_cfg: Optional[TrainerConfig] = None,
                 mesh: Optional[ShardMesh] = None,
                 bucket_cap: Optional[int] = None, seed: int = 0,
                 use_cvm: bool = True, fleet: Optional[Fleet] = None,
                 store_factory=None, device: DeviceLike = None,
                 pass_flags: Optional[PassFlags] = None,
                 shard_flags: Optional[ShardFlags] = None,
                 push_flags: Optional[PushFlags] = None,
                 stage_flags: Optional[StageFlags] = None,
                 dtype_flags: Optional[DtypeFlags] = None,
                 obs_flags: Optional[ObsFlags] = None, store=None) -> None:
        """``fleet``: the host-collective facade (default: the module's
        ``fleet``, initialized from the environment's role when it is
        not). ``mesh``: the rank's ShardMesh (default:
        fleet.init_distributed(device), which joins the process group).
        ``device``: the rank's device, the card unless the caller asks for
        the CPU. ``bucket_cap``: KB, default max(16, 2 * key_capacity //
        P). ``store``: the owned shard's host store (default the native
        one)."""
        self.cfg = trainer_cfg or TrainerConfig()
        cfg = self.cfg
        if cfg.scan_chunk < 1:
            raise ValueError("scan_chunk must be >= 1, got %r"
                             % (cfg.scan_chunk,))
        if cfg.sparse_chunk_sync:
            raise ValueError(
                "sparse_chunk_sync is a single-host BoxTrainer mode; the "
                "sharded trainer's pull and push ride the per-step a2a")
        if cfg.async_mode or cfg.sync_mode == "async":
            raise ValueError("async dense mode is single-host: use "
                             "BoxTrainer")
        if cfg.sync_mode in ("k_step", "sharding") or cfg.sharding:
            raise NotImplementedError(
                "sync_mode=%r / sharding=%r: only the per-step dense "
                "allreduce is ported (%s)" % (cfg.sync_mode, cfg.sharding,
                                              TODO_DENSE_SYNC))
        if cfg.sync_one_ring:
            raise NotImplementedError("sync_one_ring (%s)" % TODO_2D_MESH)
        if cfg.a2a_dtype != "float32":
            raise NotImplementedError("a2a_dtype=%r (%s)"
                                      % (cfg.a2a_dtype, TODO_BF16_EXPAND))
        if uses_expand(model) or table_cfg.expand_embed_dim:
            raise NotImplementedError("the expand block (%s)"
                                      % TODO_BF16_EXPAND)
        if store_factory is not None:
            raise NotImplementedError("store_factory (%s)" % TODO_PS)
        self.dtype_flags = dtype_flags or DtypeFlags()
        self.stage_flags = stage_flags or StageFlags()
        if self.stage_flags.wire != "full":
            raise NotImplementedError("the %s wire (%s)"
                                      % (self.stage_flags.wire, TODO_WRITES))
        self.push_flags = push_flags or PushFlags()
        if self.push_flags.push_write not in ("auto", "scatter"):
            raise NotImplementedError("push_write=%r (%s)"
                                      % (self.push_flags.push_write,
                                         TODO_WRITES))
        if getattr(model, "use_sequence", False):
            raise ValueError("%s attends a behavior sequence: train it on "
                             "parallel/seq_trainer.py SeqCtrTrainer"
                             % type(model).__name__)
        if mesh is not None and not isinstance(mesh, ShardMesh):
            raise NotImplementedError(
                "mesh %r: the port's mesh is one ShardMesh a rank, one "
                "process a GPU (%s)" % (type(mesh).__name__, TODO_2D_MESH))
        self.shard_flags = shard_flags or ShardFlags()
        self.fleet = fleet if fleet is not None else default_fleet
        if not self.fleet.initialized:
            self.fleet.init()
        if mesh is not None:
            if self.fleet.mesh is None:
                self.fleet.mesh = mesh
            elif self.fleet.mesh is not mesh:
                raise ValueError("mesh is not the fleet's mesh")
        self.mesh = mesh or self.fleet.init_distributed(device)
        # device collectives called, by kind (the card's check that the
        # path ran through them)
        self.collective_counts = collections.Counter()
        self.P = self.mesh.world
        self.rank = self.mesh.rank
        self.device = self.mesh.device
        if self.device.type == "cuda":
            # f32 stays f32: no TF32 in matmuls or convolutions
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.feed = feed
        self.use_cvm = use_cvm
        self.policy = resolve_sharding_policy(
            self.P, self.shard_flags.sharding_policy)
        # the per-step host exchange; its bring-up checks that every rank
        # runs this policy
        self.host_mesh = self.fleet.make_mesh_comm(
            [self.rank], policy_id=self.policy.describe())
        kcap = feed.key_capacity()
        # bucket slack over the uniform K/P expectation (hash imbalance)
        self.bucket_cap = bucket_cap or max(16, (2 * kcap) // self.P)
        self.table = ShardedPassTable(
            table_cfg, self.P, self.bucket_cap, seed=seed,
            owned_shards=[self.rank], policy=self.policy, device=self.device,
            pass_flags=pass_flags, shard_flags=self.shard_flags, store=store,
            embed_dtype=self.dtype_flags.slab_embed_dtype)
        self.layout = self.table.layout
        if hasattr(model, "matmul_dtype"):
            model.matmul_dtype = self.dtype_flags.matmul_dtype
        elif self.dtype_flags.matmul_dtype != "float32":
            raise ValueError("matmul_dtype=%r: the model has no matmul_dtype "
                             "to set" % self.dtype_flags.matmul_dtype)
        self.model = model.to(self.device)
        self._broadcast_dense()
        self.task_names = task_names(model)
        self.multi_task = is_multi_task(model)
        self.has_summary = uses_data_norm(model)
        tensors = dict(dense_state(self.model))
        self._summaries = [tensors[n] for n in tensors if is_summary_name(n)]
        self.num_slots = len(feed.used_sparse_slots())
        self.metrics = MetricRegistry()
        self.dense_opt = make_dense_optimizer(cfg, self.model.parameters())
        self._shuffle_rng = np.random.RandomState(seed + 1)
        self._seed_gen = torch.Generator().manual_seed(
            rank_seed(seed, self.rank))
        self.seed_fn: Callable[[], int] = self._draw_seed
        self._step_count = 0
        self.pass_times: Dict[str, float] = {}
        self.stream_high_water = 0
        self.obs_flags = obs_flags or ObsFlags()
        self.quality = quality.make_from_flags(self.obs_flags)
        self.drift = drift.make_from_flags(self.obs_flags)
        self.timers = {n: Timer() for n in ("step", "pass", "build")}
        # tagged with the rank; no cluster aggregator (ROADMAP.md A10)
        self.reporter = make_step_reporter(rank=self.rank, timers=self.timers,
                                           flags=self.obs_flags)
        self.dump_writer: Optional[DumpWriter] = None
        if cfg.dump_fields and cfg.dump_fields_path:
            self.dump_writer = DumpWriter(cfg.dump_fields_path,
                                          cfg.dump_thread_num,
                                          rank=self.rank)
        self._pool: Optional[ThreadPoolExecutor] = None
        self._copy_stream = None
        if self.obs_flags.device_obs:
            me = weakref.ref(self)
            device_obs.register_owner("slab", lambda: (
                me().table.resident_slab if me() is not None else None))
            device_obs.register_owner("dense_params", lambda: (
                list(me().model.parameters()) if me() is not None else None))

    # ------------------------------------------------------------ dense state
    def _broadcast_dense(self) -> None:
        """Every rank starts from rank 0's parameters and buffers."""
        with torch.no_grad():
            for _, t in dense_state(self.model):
                dist.broadcast(t.data, src=0, group=self.mesh.group)
                self.collective_counts["broadcast"] += 1

    def _draw_seed(self) -> int:
        return int(torch.randint(0, 2**31 - 1, (), generator=self._seed_gen))

    @property
    def params(self) -> Dict[str, object]:
        """This rank's dense parameters (every rank's are the same) by the
        JAX package's names, as numpy."""
        return params_to_numpy(self.model)

    @property
    def opt_state(self) -> Dict[str, object]:
        return opt_state_to_numpy(self.cfg.dense_optimizer, self.model,
                                  self.dense_opt)

    def merged_params(self) -> Dict[str, object]:
        """The single copy of the dense parameters (the replicas are
        equal; the reference's k_step merge is not ported)."""
        return self.params

    def merged_opt_state(self) -> Dict[str, object]:
        return self.opt_state

    # ------------------------------------------------------------- staging
    def _stager_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max(1, self.shard_flags.stager_threads),
                thread_name_prefix="shard-stager")
        return self._pool

    def _route(self, b: PackedBatch):
        valid = b.valid.copy()
        return valid, self.table.bucketize(b.keys, valid)

    def stage_host(self, b: PackedBatch, routed=None) -> Staged:
        """One step's host staging (reference _step_host_arrays :753-805)
        after its routing (``routed``: _route's (valid, index), made here
        when None): the host exchange of the buckets, the batch's leaves,
        and in a train pass the push's dedup (which marks the touched
        rows) and the bucket merge's order. Collective (the exchange):
        every rank stages its steps in the same order."""
        valid, idx = routed if routed is not None else self._route(b)
        P, KB, r = self.P, self.bucket_cap, self.rank
        inc = exchange_incoming_p2p(idx.buckets[None], [r], P,
                                    self.host_mesh, self.policy)[r]
        host: Staged = {"req": inc.reshape(-1), "restore": idx.restore,
                        "segments": b.segments, "valid": valid,
                        "ins_valid": b.ins_valid, "labels": b.labels,
                        "n_valid": int(b.valid.sum())}
        if b.dense is not None:
            host["dense"] = b.dense
        if b.rank_offset is not None:
            host["rank_offset"] = b.rank_offset
        if self.multi_task and b.task_labels:
            for t in self.task_names:
                if t in b.task_labels:
                    host["labels_" + t] = b.task_labels[t]
        if not self.table.test_mode:
            prod = stage_push_dedup({r: inc}, self.table.shard_cap,
                                    note_touched=self.table.note_touched)
            host.update(uids=prod["push_uids"][0],
                        perm=prod["push_perm"][0],
                        offsets=prod["push_offsets"][0],
                        n_uniq=prod["n_uniq"][0])
            # the bucket merge: each slot's occurrences in ascending order
            live = np.flatnonzero(valid)
            slots = idx.restore[live]
            order = np.argsort(slots, kind="stable")
            host["bperm"] = live[order].astype(np.int32)
            host["boffsets"] = np.searchsorted(
                slots[order], np.arange(P * KB + 1)).astype(np.int32)
        return host

    def _to_device(self, host: Staged) -> Staged:
        """The staged arrays on the rank's device (ints stay host ints):
        on the card one copy a leaf on a copy stream, with an event the
        step waits on."""
        dev = self.device
        if dev.type != "cuda":
            return {k: (torch.from_numpy(np.ascontiguousarray(v))
                        if isinstance(v, np.ndarray) else v)
                    for k, v in host.items()}
        device_obs.account_h2d(device_obs.tree_nbytes(host), "staging")
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(dev)
        out: Staged = {}
        with torch.cuda.stream(self._copy_stream):
            for k, v in host.items():
                out[k] = (torch.from_numpy(np.ascontiguousarray(v)).to(
                    dev, non_blocking=True) if isinstance(v, np.ndarray)
                    else v)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        out["_ready"] = ready
        return out

    def shard_batches(self, batches: List[PackedBatch],
                      depth: Optional[int] = None) -> Iterator[Staged]:
        """STREAM the pass's steps staged on the device (reference
        :807-876): a stager thread routes each batch on the routing pool
        (up to stager_threads steps ahead), exchanges and dedups in step
        order and copies the step to the device; ``depth`` (default
        ShardFlags.stream_depth) staged steps queue ahead. An error of the
        stager is raised at the consumer's next step; closing the
        generator stops and joins the stager."""
        n_steps = len(batches)
        depth = max(1, depth or self.shard_flags.stream_depth)
        pool = self._stager_pool()
        ahead = max(1, self.shard_flags.stager_threads)
        q: "queue.Queue" = queue.Queue(maxsize=depth)
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
                routed: "collections.deque" = collections.deque()
                nxt = 0
                for i in range(n_steps):
                    while nxt < n_steps and nxt < i + ahead:
                        routed.append(pool.submit(self._route, batches[nxt]))
                        nxt += 1
                    if stop.is_set():
                        return
                    with span("host_stage"):
                        st = self._to_device(self.stage_host(
                            batches[i], routed.popleft().result()))
                    if not put(st):
                        return
            except BaseException as e:   # raised at the consumer's get
                put(e)

        producer = threading.Thread(target=produce, daemon=True,
                                    name="shard-batch-stager")
        producer.start()
        self.stream_high_water = 0
        try:
            for _ in range(n_steps):
                item = q.get()
                if isinstance(item, BaseException):
                    raise item
                self.stream_high_water = max(self.stream_high_water,
                                             q.qsize() + 1)
                yield item
        finally:
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
                    # a stager stuck in an exchange whose peers left: its
                    # group's timeout ends it
                    print("shard-batch-stager did not stop within %.0f s"
                          % STAGER_GRACE_S, file=sys.stderr)
                    break

    # ---------------------------------------------------------------- step
    def _wait_ready(self, st: Staged) -> None:
        ready = st.get("_ready")
        if ready is not None:
            torch.cuda.current_stream(self.device).wait_event(ready)
            for v in st.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(torch.cuda.current_stream(self.device))

    def _a2a(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous(), group=self.mesh.group)
        self.collective_counts[kind] += 1
        return out

    def _pull(self, st: Staged) -> torch.Tensor:
        """The pull (reference pull_emb :356-380): the incoming ids' rows of
        the shard slab (gather_rows), their pull view, the values' a2a
        back to the ranks that asked, restored to the batch's key
        positions: [K, 3+D]."""
        slab = self.table.slab
        vals = pull_view_from_rows(
            gather_slab_rows(slab, st["req"], self.layout), self.layout)
        resp = self._a2a(vals, "a2a_pull")
        return resp.index_select(0, st["restore"])

    def _forward(self, emb: torch.Tensor, st: Staged):
        pooled = fused_seqpool_cvm(emb, st["segments"], st["valid"],
                                   self.feed.batch_size, self.num_slots,
                                   st["n_valid"], self.use_cvm)
        loss, preds = forward_loss(self.model, pooled, st,
                                   self.cfg.compute_dtype)
        return pooled, loss, preds

    def _dense_sync(self, loss: torch.Tensor) -> torch.Tensor:
        """The dense grads and the loss summed over the ranks in one
        all_reduce and divided by P (pmean, reference :511, :559); the
        grads written back for the dense step. Returns the mean loss."""
        params = list(self.model.parameters())
        parts = [(p.grad if p.grad is not None
                  else torch.zeros_like(p)).reshape(-1) for p in params]
        flat = torch.cat(parts + [loss.detach().reshape(1)])
        dist.all_reduce(flat, group=self.mesh.group)
        self.collective_counts["all_reduce"] += 1
        flat = flat / self.P
        off = 0
        for p in params:
            n = p.numel()
            g = flat[off:off + n].view_as(p)
            if p.grad is None:
                p.grad = g.clone()
            else:
                p.grad.copy_(g)
            off += n
        return flat[-1]

    def _sync_summaries(self) -> None:
        """A data_norm model's summaries averaged over the ranks (the
        reference pmeans each rank's running sums, :564-576)."""
        flat = torch.cat([t.reshape(-1) for t in self._summaries])
        dist.all_reduce(flat, group=self.mesh.group)
        self.collective_counts["all_reduce_summary"] += 1
        flat = flat / self.P
        off = 0
        for t in self._summaries:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n

    def train_step(self, st: Staged, seed: int):
        """One step on a staged batch: (mean loss over the ranks, this
        rank's predictions), device tensors. Updates the shard slab and
        the model IN PLACE."""
        self._wait_ready(st)
        emb = self._pull(st).requires_grad_(True)
        pooled, loss, preds = self._forward(emb, st)
        self.dense_opt.zero_grad(set_to_none=True)
        loss.backward()
        mean_loss = self._dense_sync(loss)
        self.dense_opt.step()
        if self.has_summary:
            with torch.no_grad():
                self.model.update_summary(pooled.detach(), st.get("dense"))
                self._sync_summaries()
        # the push: per-key grads, merged into bucket slots, to the owners
        S = self.num_slots
        segments, valid = st["segments"], st["valid"]
        clicks = task_label(st, self.task_names[0]).index_select(
            0, segments // S)
        pg = build_push_grads(emb.grad, segments % S, clicks, valid)
        bucket_g = merge_push_grads(pg, st["bperm"], st["boffsets"])
        recv = self._a2a(bucket_g, "a2a_push")
        push_sparse_hostdedup(self.table.slab, st["uids"], st["perm"],
                              st["offsets"], st["n_uniq"], recv, seed,
                              self.layout, self.table.config.optimizer,
                              write="scatter",
                              block_rows=self.push_flags.push_block_rows)
        if isinstance(preds, dict):
            preds = {t: v.detach() for t, v in preds.items()}
        else:
            preds = preds.detach()
        return mean_loss.detach(), preds

    def eval_step(self, st: Staged) -> torch.Tensor:
        """The main task's predictions of a staged test batch: the pull,
        the pool and the forward under no_grad (the SetTestMode path,
        reference _build_eval_step :1050-1071)."""
        self._wait_ready(st)
        with torch.no_grad():
            emb = self._pull(st)
            _, _, preds = self._forward(emb, st)
        if isinstance(preds, dict):
            preds = preds[self.task_names[0]]
        return preds

    # ---------------------------------------------------------- pass cadence
    def _check_collect_mode(self) -> None:
        for m in self.metrics.messages():
            c = getattr(m, "calculator", None)
            if c is not None and getattr(c, "mode_collect_in_device", False):
                raise NotImplementedError(
                    "metric %r collects on the device (%s)"
                    % (m.name, TODO_DEVICE_METRICS))

    def train_pass(self, dataset: BoxDataset,
                   preloaded: bool = False) -> Dict[str, float]:
        """One pass on this rank (module docstring): {"loss": the pass's
        mean of the ranks' mean step losses, "batches": steps,
        "instances": this rank's}. ``pass_times`` holds the host seconds
        of its phases (feed, build, steps, end)."""
        clock = [time.perf_counter()]
        times: Dict[str, float] = {}

        def lap(name: str) -> None:
            now = time.perf_counter()
            times[name] = now - clock[0]
            clock[0] = now

        self._check_collect_mode()
        t_pass = self.timers["pass"]
        t_pass.start()
        drift.set_active(self.drift)
        if not preloaded:
            self.table.begin_feed_pass()
            dataset.load_into_memory(add_keys_fn=self.table.add_keys)
            self.table.end_feed_pass(allgather=self.fleet.all_gather)
            lap("feed")
        self.timers["build"].start()
        self.table.build_owned_slabs()
        self.timers["build"].pause()
        dataset.local_shuffle(self._shuffle_rng.randint(1 << 31))
        batches = dataset.split_batches(
            1, equalize=self.fleet.equalize_batches())[0]
        lap("build")
        n_steps = len(batches)
        ex_per_step = self.feed.batch_size
        preds_on = self._preds_consumed()
        losses: List[float] = []
        tail_losses: List[torch.Tensor] = []
        tail_preds: List = []
        stream = self.shard_batches(batches)
        chunk = self.cfg.scan_chunk
        try:
            start = 0
            if chunk > 1 and n_steps >= chunk:
                def scan_call(carry, group):
                    ls, ps = [], []
                    for st in group:
                        loss, p = self.train_step(st, self.seed_fn())
                        ls.append(loss)
                        ps.append(p)
                    return carry, torch.stack(ls), stack_preds(ps)

                def on_chunk(lo, group, losses_np, preds_dev) -> None:
                    self._step_count += len(group)
                    self.reporter.note_examples(len(group) * ex_per_step)
                    self.reporter.maybe_report(self._step_count)
                    if self.cfg.check_nan_inf and not np.isfinite(
                            losses_np).all():
                        raise FloatingPointError("nan/inf loss by step %d"
                                                 % self._step_count)
                    if preds_on:
                        host = preds_to_host(preds_dev)
                        for j in range(len(group)):
                            b = batches[lo + j]
                            self._add_metrics(preds_row(host, j), b)
                            self._dump_batch(preds_row(host, j), b)

                _, chunk_losses, start = run_scan_chunks(
                    scan_call, stream, chunk, lambda group: group, None,
                    on_chunk, n_items=n_steps, timer=self.timers["step"])
                losses.extend(float(x) for x in chunk_losses)
            try:
                for i, st in enumerate(stream, start=start):
                    set_trace(step_trace_id(self.rank, self._step_count + 1))
                    self.timers["step"].start()
                    with span("shard_step"):
                        loss, p = self.train_step(st, self.seed_fn())
                    self.timers["step"].pause()
                    self._step_count += 1
                    self.reporter.note_examples(ex_per_step)
                    self.reporter.maybe_report(self._step_count)
                    if self.cfg.check_nan_inf and not bool(
                            torch.isfinite(loss)):
                        raise FloatingPointError("nan/inf loss at step %d"
                                                 % self._step_count)
                    tail_losses.append(loss)
                    tail_preds.append(p)
            finally:
                set_trace(None)
        finally:
            stream.close()
        if tail_losses:
            losses.extend(float(x) for x in
                          torch.stack(tail_losses).cpu().numpy())
            if preds_on:
                host = preds_to_host(stack_preds(tail_preds))
                for j, b in enumerate(batches[n_steps - len(tail_preds):]):
                    self._add_metrics(preds_row(host, j), b)
                    self._dump_batch(preds_row(host, j), b)
        lap("steps")
        self.table.end_pass()
        t_pass.pause()
        mean_loss = float(np.mean(np.asarray(losses, np.float32))) \
            if losses else 0.0
        extra = {"event": "pass_end", "loss": round(mean_loss, 6),
                 "auc": {m.name: float(m.calculator.auc())
                         for m in self.metrics.messages()}}
        quality.attach_pass_extras(extra, self.quality, self.drift)
        self.reporter.maybe_report(self._step_count, force=True, extra=extra)
        if self.cfg.profile:
            obs_log.info(timer_report(self.timers,
                                      prefix="sharded.r%d." % self.rank))
        lap("end")
        self.pass_times = times
        return {"loss": mean_loss, "batches": n_steps,
                "instances": len(dataset)}

    def predict_batches(self, dataset: BoxDataset
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Test-mode inference over a dataset (SetTestMode, reference
        :1073-1127): no feature creation, no write-back. Returns (the main
        task's preds, click labels) of this rank's valid instances; the
        wrapped batches that equalize the ranks' step counts run (the
        collectives stay in lockstep) and are left out."""
        if len(dataset) == 0:
            dataset.load_into_memory()
        self.table.set_test_mode(True)
        preds_all, labels_all = [], []
        try:
            self.table.begin_feed_pass()
            self.table.add_keys(dataset.all_keys())
            self.table.end_feed_pass(allgather=self.fleet.all_gather)
            self.table.build_owned_slabs()
            batches = dataset.split_batches(
                1, equalize=self.fleet.equalize_batches())[0]
            bs = self.feed.batch_size
            real = -(-len(dataset) // bs)
            out = []
            stream = self.shard_batches(batches)
            try:
                for st in stream:
                    out.append(self.eval_step(st))
            finally:
                stream.close()
            self.table.end_pass()
        finally:
            self.table.set_test_mode(False)
        if out:
            host = torch.stack(out).cpu().numpy()
            for i, b in enumerate(batches[:real]):
                preds_all.append(host[i][b.ins_valid])
                labels_all.append(b.labels[b.ins_valid])
        if not preds_all:
            return np.empty(0, np.float32), np.empty(0, np.int32)
        return np.concatenate(preds_all), np.concatenate(labels_all)

    # ---------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Stop the dump writer, the routing pool and the reporter, then
        destroy the process group (Fleet.stop)."""
        if self.dump_writer is not None:
            self.dump_writer.close()
            self.dump_writer = None
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        if getattr(self, "reporter", None) is not None:
            self.reporter.close()
            self.reporter = None
        if self.fleet.mesh is not None:
            self.fleet.stop()
