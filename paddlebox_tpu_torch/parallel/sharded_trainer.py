"""The sharded trainer: one process a GPU over a ShardedPassTable.

Counterpart of paddlebox_tpu/parallel/sharded_trainer.py (the BoxPS
topology: one worker a GPU, a sharded embedding table pulled and pushed
through an all-to-all, a data-parallel dense allreduce). The table's
sharding policy comes from ShardFlags (parallel/sharding.py
resolve_sharding_policy): key-mod, table-wise, or the 2-D grid with its
replicated hot tier, whose frozen hot ids the uid exchange keeps off the
wire (``hot_counts``: the ids dropped and added back). The
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

The modes (reference :84-330, 356-380, 492-669, 697-722, 980-1015):

  * the push's write (PushFlags.push_write, resolved once by
    PushFlags.resolve_push_write: the shard's rows against the P * KB ids
    it receives) and its wire (StageFlags, read at every
    pass, as BoxTrainer reads them): on the full wire the host exchange
    carries the ids and the host stages the sorted dedup, with the
    rebuild write's position map; on the uid, delta and ids-only wires
    the ids ride a device a2a of the buckets (the reference's first a2a)
    and the host exchange carries each rank's deduplicated uid vectors
    (exchange_push_uids_p2p): the uid wire stages the sorted uids, the
    delta wire them as an int32 base and int16 deltas, the ids-only wire
    nothing (the step dedups on the device). The push is
    push_sparse_hostdedup (scatter or blocked), push_sparse_rebuild,
    push_sparse_uidwire or push_sparse_dedup by what the step carries;
  * the dense sync (TrainerConfig.sync_mode): 'step' as above; 'k_step'
    (sync_weight_step K) local dense steps, then every K steps and at
    each pass end one all_reduce-mean of the floating parameters,
    buffers and optimizer state (Adam's step count passes through), the
    data_norm summaries diverging until then; 'sharding' (or
    ``cfg.sharding``, ZeRO-1, adam only) the flat grads in the JAX
    params' ravel order reduce-scattered, this rank's slice updated by
    the reference's own Adam (moments 0.9/0.1 and 0.999/0.001, bias
    corrected, eps 1e-8 outside the root), the slices all-gathered;
  * a 2-D mesh (parallel/mesh.py device_mesh_2d): the grads
    reduce-scattered over the node's chips, all-reduced over the nodes
    and all-gathered over the chips (ZeRO-1's moments partition over the
    chip axis); ``sync_one_ring`` forces the flat all_reduce over the
    world instead. Key routing stays P flat shards;
  * ``a2a_dtype='bfloat16'``: the pull's values cross the a2a as bf16 and
    are upcast after the restore; the push's first three columns (slot,
    show, click: exact integers) cross on their own f32 a2a, the gradient
    columns as bf16;
  * the expand block (a ``use_expand`` model, CtrDnnExpand): the
    extended pull's base and expand columns share one a2a and split after
    the restore, the expand rows sum-pooled (seqpool_sum), their
    gradients pushed after the embedx grads through the fused push's
    expand form;
  * device-collect metrics (every metric a plain all-phase AUC over
    label, pred and mask with mode_collect_in_device): each step buckets
    its predictions into an int32 [2, T] table on the device and adds
    Kahan-compensated f32 sums of abserr, sqrerr, pred, label and count
    (NaN predictions left out of every sum); the pass reads the two
    tensors once and merges them into every calculator and the quality
    plane. The cross-rank reduction stays get_metric_msg's allreduce.

The push seeds: ``seed_fn`` (a zero-argument callable returning a
nonnegative int32), called on the thread that queues the steps, once a
step in step order; by default a torch.Generator seeded from (seed,
rank). The creation hash reads the shard-local row id. The parity tests
replay the reference's per-shard seeds through it.

Dense state: the ranks' models start from rank 0's parameters and buffers
(one broadcast at construction) and stay replicas (k_step: between its
syncs they diverge); ``params`` / ``opt_state`` (``merged_params`` /
``merged_opt_state``) are this rank's copy under the JAX package's names
(convert.py); under ZeRO-1 ``opt_state`` is this rank's moment slice.

The telemetry plane: a rank-tagged StepReporter; above world 1 a
ClusterAggregator (``aggregator``, obs/aggregate.py) publishes every
rank's reports to rank 0 over the fleet's KV store, where the merged
cluster record and the health plane's record (obs/health.py) go to the
sink; at world 1 ``aggregator`` is None, as in the reference.

A ``store_factory`` puts another store behind the owned shard:
embedding/ps_store.py ps_store_factory(client, table_id,
process_primary=(rank == 0)) fronts the CPU PS (train/factory.py's
PSGPUTrainer), whose rows the shard fetches at begin_pass and writes back
at end_pass, with no preload prefetch (the store has no lookup_present).
The SSD budget (TableConfig.ssd_dir, ssd_threshold_mb) divides over the
ranks on a host (ShardMesh.chips). sparse_chunk_sync and async dense
raise ValueError as in the reference.
The bf16 slab (DtypeFlags.slab_embed_dtype) is the shard's, as the
single-device table's: the pull decodes, the push decodes and encodes in
its kernel.
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
from paddlebox_tpu_torch.convert import (dense_state, flat_names,
                                         params_to_numpy)
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.data.packer import PackedBatch
from paddlebox_tpu_torch.device import DeviceLike
from paddlebox_tpu_torch.embedding.pass_table import delta_encode_uids
from paddlebox_tpu_torch.embedding.push_kernels import merge_push_grads
from paddlebox_tpu_torch.fleet.fleet import Fleet
from paddlebox_tpu_torch.fleet.fleet import fleet as default_fleet
from paddlebox_tpu_torch.metrics import drift, quality
from paddlebox_tpu_torch.metrics.auc import MetricMsg, MetricRegistry
from paddlebox_tpu_torch.obs import device as device_obs
from paddlebox_tpu_torch.obs import log as obs_log
from paddlebox_tpu_torch.obs import (make_cluster_aggregator,
                                     make_step_reporter, obs_rank_world)
from paddlebox_tpu_torch.obs.tracer import set_trace, span, step_trace_id
from paddlebox_tpu_torch.ops.seqpool import fused_seqpool_cvm, seqpool_sum
from paddlebox_tpu_torch.ops.sparse import (build_push_grads,
                                            build_push_grads_extended)
from paddlebox_tpu_torch.parallel.mesh import ShardMesh
from paddlebox_tpu_torch.parallel.sharded_table import (
    ShardedPassTable, exchange_incoming_p2p, exchange_push_uids_p2p,
    stage_push_dedup)
from paddlebox_tpu_torch.parallel.sharding import resolve_sharding_policy
from paddlebox_tpu_torch.train.dense_optim import (make_dense_optimizer,
                                                   opt_state_to_numpy)
from paddlebox_tpu_torch.train.dump import DumpWriter
from paddlebox_tpu_torch.train.trainer import (STAGER_GRACE_S, BatchOutputs,
                                               _pull, check_expand_config,
                                               forward_loss,
                                               is_multi_task,
                                               is_summary_name,
                                               preds_row, preds_to_host,
                                               run_scan_chunks, sparse_push,
                                               stack_preds,
                                               task_label, task_names,
                                               uses_data_norm, uses_expand)
from paddlebox_tpu_torch.utils.profiler import timer_report
from paddlebox_tpu_torch.utils.timer import Timer

# ZeRO-1's Adam (reference sharded_trainer.py:525-531)
ZERO_B1, ZERO_B2, ZERO_EPS = 0.9, 0.999, 1e-8

Staged = Dict[str, object]


def rank_seed(seed: int, rank: int) -> int:
    """The default push-seed generator's seed of ``rank``: a mix of
    (seed, rank)."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(
        1, np.uint64)[0] & np.uint64(2**63 - 1))


def stage_routed(idx, valid: np.ndarray, rank: int, P: int, KB: int,
                 table: ShardedPassTable, host_mesh, policy, wire: str,
                 push_write: str, hot_counts: Dict[str, int]) -> Staged:
    """The host exchange's and the push's products of one routed key set
    (``idx``: the ShardedBatchIndex of its keys, ``valid`` its valid flags
    after the routing) on rank ``rank`` of P, by the ``wire``
    (StageFlags.wire; reference _step_host_arrays :753-805). On the full
    wire the host exchange of the buckets gives the ids this shard serves
    (``req``) and, in a train pass, their sorted dedup (which marks the
    touched rows; the rebuild write's map too, where ``push_write`` is
    'rebuild'); on the lean wires the buckets go to the device (its a2a
    carries the ids) and, in a train pass, the uid exchange gives the
    sorted uids (the uid wire stages them, the delta wire them coded, the
    ids-only wire nothing) and the count of real ids the a2a brings
    (``push_n_valid``). A train pass also stages the bucket merge's order:
    ``bperm``, the live key positions by bucket slot, each slot's
    occurrences ascending, and ``boffsets`` [P * KB + 1]. Collective (the
    exchanges): every rank stages its steps in the same order. The sharded
    trainer stages a batch through it, the sharded pipeline a stage
    rank's micro slice."""
    cap = table.shard_cap
    train = not table.test_mode
    host: Staged = {}
    if wire == "full":
        inc = exchange_incoming_p2p(idx.buckets[None], [rank], P, host_mesh,
                                    policy)[rank]
        host["req"] = inc.reshape(-1)
        if train:
            prod = stage_push_dedup(
                {rank: inc}, cap, note_touched=table.note_touched,
                rebuild=push_write == "rebuild")
            host.update(uids=prod["push_uids"][0],
                        perm=prod["push_perm"][0],
                        offsets=prod["push_offsets"][0],
                        n_uniq=prod["n_uniq"][0])
            if "push_pos" in prod:
                host["push_pos"] = prod["push_pos"][0]
    else:
        host["buckets"] = idx.buckets.reshape(-1)
        if train:
            uids_by, n_real = exchange_push_uids_p2p(
                idx.buckets[None], [rank], P, cap, host_mesh, policy,
                hot_counts=hot_counts)
            prod = stage_push_dedup(
                None, cap, note_touched=table.note_touched, uid_only=True,
                uids_by_dest=uids_by)
            uids = prod["push_uids"][0]
            host.update(n_uniq=prod["n_uniq"][0], push_n_valid=n_real[rank])
            if wire == "uid":
                host["uids"] = uids
            elif wire == "delta":
                base, d16, cut = delta_encode_uids(uids, cap)
                host.update(uid_base=int(base), uid_d16=d16,
                            uid_cut=int(cut))
    if train:
        # the bucket merge: each slot's occurrences in ascending order
        live = np.flatnonzero(valid)
        slots = idx.restore[live]
        order = np.argsort(slots, kind="stable")
        host["bperm"] = live[order].astype(np.int32)
        host["boffsets"] = np.searchsorted(
            slots[order], np.arange(P * KB + 1)).astype(np.int32)
    return host


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
        not). ``mesh``: the rank's ShardMesh, 1-D or 2-D (parallel/mesh.py
        device_mesh_2d) over the fleet's process group (default:
        fleet.init_distributed(device=device), which joins the process group).
        ``device``: the rank's device, the card unless the caller asks for
        the CPU. ``bucket_cap``: KB, default max(16, 2 * key_capacity //
        P). ``store``: the owned shard's host store, or ``store_factory``
        (layout, table, seed) -> store makes it (default the native
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
        # the dense sync (reference :161-176)
        self.sharding_mode = bool(cfg.sharding or cfg.sync_mode == "sharding")
        self.k_step = (max(1, cfg.sync_weight_step)
                       if cfg.sync_mode == "k_step" else 1)
        if self.sharding_mode and self.k_step > 1:
            raise ValueError("sharding and k_step dense sync are exclusive")
        if self.sharding_mode and cfg.dense_optimizer != "adam":
            raise ValueError("ZeRO-1 sharding implements adam only; got "
                             "dense_optimizer=" + cfg.dense_optimizer)
        self.dtype_flags = dtype_flags or DtypeFlags()
        self.stage_flags = stage_flags or StageFlags()
        self.push_flags = push_flags or PushFlags()
        if getattr(model, "use_sequence", False):
            raise ValueError("%s attends a behavior sequence: train it on "
                             "parallel/seq_trainer.py SeqCtrTrainer"
                             % type(model).__name__)
        if mesh is not None and not isinstance(mesh, ShardMesh):
            raise TypeError("mesh %r: the port's mesh is a ShardMesh a rank "
                            "(parallel/mesh.py init_distributed, "
                            "device_mesh_2d)" % type(mesh).__name__)
        self.shard_flags = shard_flags or ShardFlags()
        self.fleet = fleet if fleet is not None else default_fleet
        # close() stops the fleet only where this trainer initialized it
        self._owns_fleet = not self.fleet.initialized
        if self._owns_fleet:
            self.fleet.init()
        if mesh is not None:
            if self.fleet.mesh is None:
                self.fleet.mesh = mesh
            elif self.fleet.mesh.group is not mesh.group:
                raise ValueError("mesh is not over the fleet's process group")
        self.mesh = mesh or self.fleet.init_distributed(device=device)
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
        self.policy = resolve_sharding_policy(self.P,
                                              flags=self.shard_flags)
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
            embed_dtype=self.dtype_flags.slab_embed_dtype,
            store_factory=store_factory, host_ranks=self.mesh.chips)
        self.layout = self.table.layout
        self.use_expand = uses_expand(model)
        check_expand_config(model, self.layout, self.use_expand)
        if self.use_expand and uses_data_norm(model):
            raise ValueError("expand embedding + data_norm summary is not "
                             "supported in one model")
        self.a2a_bf16 = cfg.a2a_dtype == "bfloat16"
        # bytes each a2a kind sent, by kind
        self.a2a_bytes = collections.Counter()
        # the shard's slab against the P * KB ids it receives a step
        # (reference trainer.py:404-416)
        self.push_write = self.push_flags.resolve_push_write(
            self.table.shard_cap, self.P * self.bucket_cap, self.device,
            self.stage_flags)
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
        # the JAX params' leaves in ravel_pytree order (ZeRO-1's flat
        # vector, whose slices must cover the JAX shards' elements)
        self._flat = [tensors[n] for n in flat_names(self.model)]
        self._n_dense = sum(t.numel() for t in self._flat)
        self._zero_shards = self.mesh.chips if self.mesh.hier else self.P
        self._n_shard = -(-self._n_dense // self._zero_shards)
        if self.sharding_mode:
            # this rank's Adam moments and the step count t
            self._zero_mu = torch.zeros(self._n_shard, device=self.device)
            self._zero_nu = torch.zeros(self._n_shard, device=self.device)
            self._zero_t = 0
        self._steps_since_sync = 0
        # device-collect metrics: the table size, the pass's tensors and
        # the metric reads to the host (d2h_reads counts every one)
        self._collect_T: Optional[int] = None
        self._mtab = self._mstats = None
        self.d2h_reads = 0
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
        # the telemetry plane (reference :222-234): the rank-tagged
        # reporter; above world 1 the ranks publish their reports to rank
        # 0 over the fleet's KV store, and rank 0 emits the merged cluster
        # record and the health record (obs/aggregate.py, obs/health.py)
        obs_rank, obs_world = (obs_rank_world(self.host_mesh, self.fleet)
                               if self.multiprocess else (0, 1))
        self.aggregator = (make_cluster_aggregator(
            fleet=self.fleet, rank=obs_rank, world=obs_world,
            flags=self.obs_flags) if self.multiprocess else None)
        self.reporter = make_step_reporter(rank=obs_rank, timers=self.timers,
                                           flags=self.obs_flags,
                                           aggregator=self.aggregator)
        # the hot tier's wire counts (exchange_push_uids_p2p): ids kept off
        # the wire and ids added back by the owner
        self.hot_counts: Dict[str, int] = {}
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
    def multiprocess(self) -> bool:
        """Whether the job spans processes: in the port every world above
        one does (one process a GPU)."""
        return self.P > 1

    @property
    def params(self) -> Dict[str, object]:
        """This rank's dense parameters by the JAX package's names, as
        numpy (every rank's are the same, but between k_step's syncs)."""
        return params_to_numpy(self.model)

    @property
    def opt_state(self):
        """This rank's dense optimizer state under optax's names; under
        ZeRO-1 the reference's per-device view of its partitioned state:
        (mu [1, n_shard], nu [1, n_shard], t), this rank's moment slice."""
        if self.sharding_mode:
            return (self._zero_mu.cpu().numpy()[None],
                    self._zero_nu.cpu().numpy()[None],
                    np.int32(self._zero_t))
        return opt_state_to_numpy(self.cfg.dense_optimizer, self.model,
                                  self.dense_opt)

    def merged_params(self) -> Dict[str, object]:
        """The single copy of the dense parameters: every pass ends on a
        sync point, so between passes the replicas are equal in every
        mode."""
        return self.params

    def merged_opt_state(self):
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
        when None): the batch's leaves, then ``stage_routed``'s products
        (the exchange's, the push's by the wire, the bucket merge's
        order). Collective (the exchanges): every rank stages its steps in
        the same order."""
        valid, idx = routed if routed is not None else self._route(b)
        host: Staged = {"restore": idx.restore, "segments": b.segments,
                        "valid": valid, "ins_valid": b.ins_valid,
                        "labels": b.labels, "n_valid": int(b.valid.sum())}
        if b.dense is not None:
            host["dense"] = b.dense
        if b.rank_offset is not None:
            host["rank_offset"] = b.rank_offset
        if self.multi_task and b.task_labels:
            for t in self.task_names:
                if t in b.task_labels:
                    host["labels_" + t] = b.task_labels[t]
        host.update(stage_routed(idx, valid, self.rank, self.P,
                                 self.bucket_cap, self.table, self.host_mesh,
                                 self.policy, self.stage_flags.wire,
                                 self.push_write, self.hot_counts))
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
        self.a2a_bytes[kind] += t.nbytes
        return out

    def _req(self, st: Staged) -> torch.Tensor:
        """The ids this shard serves this step, [P * KB] in source order:
        the host exchange's on the full wire, else the device a2a of the
        buckets (reference :364)."""
        if "req" in st:
            return st["req"]
        return self._a2a(st["buckets"], "a2a_ids")

    def _pull(self, st: Staged):
        """The pull (reference pull_emb :356-380): the incoming ids' rows of
        the shard slab (gather_rows; the extended pull with the expand
        block, base and expand columns side by side), the values' a2a back
        to the ranks that asked (as bf16 under a2a_dtype 'bfloat16'),
        restored to the batch's key positions and upcast: ([K, 3+D], the
        expand rows [K, E] or None, the served ids)."""
        req = self._req(st)
        base, exp = _pull(self.table.slab, req, self.layout, self.use_expand)
        vals = base if exp is None else torch.cat([base, exp], dim=1)
        if self.a2a_bf16:
            vals = vals.to(torch.bfloat16)
        emb = self._a2a(vals, "a2a_pull").index_select(0, st["restore"])
        if self.a2a_bf16:
            emb = emb.to(torch.float32)
        if not self.use_expand:
            return emb, None, req
        w = 3 + self.layout.embedx_dim
        return emb[:, :w].clone(), emb[:, w:].clone(), req

    def _forward(self, emb: torch.Tensor, exp: Optional[torch.Tensor],
                 st: Staged):
        pooled = fused_seqpool_cvm(emb, st["segments"], st["valid"],
                                   self.feed.batch_size, self.num_slots,
                                   self.use_cvm, sorted_segments=True,
                                   n_valid=st["n_valid"])
        pooled_exp = None
        if exp is not None:
            pooled_exp = seqpool_sum(exp, st["segments"], st["valid"],
                                     self.feed.batch_size, self.num_slots,
                                     st["n_valid"])
        loss, preds = forward_loss(self.model, pooled, st,
                                   self.cfg.compute_dtype, pooled_exp)
        return pooled, loss, preds

    # -------------------------------------------------------- dense sync
    def _all_reduce_mean(self, flat: torch.Tensor, kind: str
                         ) -> torch.Tensor:
        dist.all_reduce(flat, group=self.mesh.group)
        self.collective_counts[kind] += 1
        return flat / self.P

    def _grads(self) -> List[torch.Tensor]:
        return [(p.grad if p.grad is not None
                 else torch.zeros_like(p)).reshape(-1)
                for p in self.model.parameters()]

    def _set_grads(self, flat: torch.Tensor) -> None:
        off = 0
        for p in self.model.parameters():
            n = p.numel()
            g = flat[off:off + n].view_as(p)
            if p.grad is None:
                p.grad = g.clone()
            else:
                p.grad.copy_(g)
            off += n

    def _dense_sync(self, loss: torch.Tensor) -> torch.Tensor:
        """The dense grads and the loss summed over the ranks in one
        all_reduce and divided by P (pmean, reference :511, :559); the
        grads written back for the dense step. Returns the mean loss."""
        flat = self._all_reduce_mean(
            torch.cat(self._grads() + [loss.detach().reshape(1)]),
            "all_reduce")
        self._set_grads(flat[:-1])
        return flat[-1]

    def _reduce_scatter_mean(self, flat: torch.Tensor) -> torch.Tensor:
        """The sum of ``flat`` over the ranks, this rank's slice of it
        divided by P (reference reduce_scatter_mean :492-508): padded to
        a multiple of the shard count (the chips on a 2-D mesh, else P),
        reduce-scattered over the flat mesh or over the node's chips,
        then on a 2-D mesh all-reduced over the nodes. [n_shard]."""
        mesh = self.mesh
        pad = self._zero_shards * self._n_shard - flat.numel()
        x = torch.nn.functional.pad(flat, (0, pad))
        out = torch.empty(self._n_shard, dtype=flat.dtype,
                          device=flat.device)
        dist.reduce_scatter_tensor(
            out, x, group=mesh.chip_group if mesh.hier else mesh.group)
        self.collective_counts["reduce_scatter"] += 1
        if mesh.hier:
            dist.all_reduce(out, group=mesh.node_group)
            self.collective_counts["all_reduce_node"] += 1
        return out / self.P

    def _all_gather(self, shard: torch.Tensor) -> torch.Tensor:
        """The slices of every rank (of the node's chips on a 2-D mesh)
        concatenated in position order."""
        mesh = self.mesh
        n = mesh.chips if mesh.hier else self.P
        out = torch.empty(n * shard.numel(), dtype=shard.dtype,
                          device=shard.device)
        dist.all_gather_into_tensor(
            out, shard.contiguous(),
            group=mesh.chip_group if mesh.hier else mesh.group)
        self.collective_counts["all_gather"] += 1
        return out

    def _loss_mean(self, loss: torch.Tensor) -> torch.Tensor:
        return self._all_reduce_mean(loss.detach().reshape(1),
                                     "all_reduce_loss")[0]

    @torch.no_grad()
    def _zero_step(self) -> None:
        """ZeRO-1 (reference :512-535): the flat grads (zeros at the
        buffers) in ravel order reduce-scattered; this rank's slice of the
        flat parameters updated by the reference's Adam; the slices
        all-gathered into every rank's parameters and buffers."""
        grads = [(t.grad if t.grad is not None else torch.zeros_like(t))
                 .reshape(-1) for t in self._flat]
        g = self._reduce_scatter_mean(torch.cat(grads))
        n, ns = self._n_dense, self._n_shard
        i = self.mesh.chip if self.mesh.hier else self.rank
        flat_p = torch.cat([t.detach().reshape(-1) for t in self._flat])
        p = torch.nn.functional.pad(flat_p, (0, self._zero_shards * ns - n))
        p = p[i * ns:(i + 1) * ns]
        self._zero_t += 1
        tf = torch.tensor(float(self._zero_t), dtype=torch.float32,
                          device=p.device)
        one = torch.ones((), dtype=torch.float32, device=p.device)
        mu = ZERO_B1 * self._zero_mu + (1.0 - ZERO_B1) * g
        nu = ZERO_B2 * self._zero_nu + (1.0 - ZERO_B2) * (g * g)
        mhat = mu / (one - torch.pow(one * ZERO_B1, tf))
        vhat = nu / (one - torch.pow(one * ZERO_B2, tf))
        p = p - (self.cfg.dense_lr * mhat) / (torch.sqrt(vhat) + ZERO_EPS)
        self._zero_mu, self._zero_nu = mu, nu
        new = self._all_gather(p)[:n]
        off = 0
        for t in self._flat:
            k = t.numel()
            t.copy_(new[off:off + k].view_as(t))
            off += k

    def _dense_step(self, loss: torch.Tensor) -> torch.Tensor:
        """The dense sync and step by mode (reference :510-562); returns
        the loss's mean over the ranks."""
        mesh = self.mesh
        if self.sharding_mode:
            self._zero_step()
            return self._loss_mean(loss)
        if self.k_step > 1:
            self.dense_opt.step()
            return self._loss_mean(loss)
        if mesh.hier and not self.cfg.sync_one_ring:
            # the 2-level mean: scatter over chips, sum over nodes, gather
            flat = torch.cat(self._grads())
            g = self._reduce_scatter_mean(flat)
            self._set_grads(self._all_gather(g)[:flat.numel()])
            self.dense_opt.step()
            return self._loss_mean(loss)
        mean_loss = self._dense_sync(loss)
        self.dense_opt.step()
        return mean_loss

    def _sync_summaries(self) -> None:
        """A data_norm model's summaries averaged over the ranks (the
        reference pmeans each rank's running sums, :564-576)."""
        flat = self._all_reduce_mean(
            torch.cat([t.reshape(-1) for t in self._summaries]),
            "all_reduce_summary")
        off = 0
        for t in self._summaries:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n

    @torch.no_grad()
    def _param_sync(self) -> None:
        """K-step's sync (reference :697-722): one all_reduce-mean of the
        floating parameters and buffers and of the optimizer's floating
        state; Adam's step count, the same on every rank, passes
        through."""
        leaves = [t for _, t in dense_state(self.model)
                  if t.is_floating_point()]
        for st in self.dense_opt.state.values():
            leaves += [v for k, v in sorted(st.items())
                       if k != "step" and isinstance(v, torch.Tensor)
                       and v.is_floating_point()]
        flat = self._all_reduce_mean(
            torch.cat([t.reshape(-1) for t in leaves]), "param_sync")
        off = 0
        for t in leaves:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n
        self._steps_since_sync = 0

    # ---------------------------------------------------------------- step
    def train_step(self, st: Staged, seed: int):
        """One step on a staged batch: (mean loss over the ranks, this
        rank's predictions), device tensors. Updates the shard slab and
        the model IN PLACE; with device-collect metrics the predictions
        also go into the pass's bucket table."""
        self._wait_ready(st)
        emb, exp, req = self._pull(st)
        emb.requires_grad_(True)
        if exp is not None:
            exp.requires_grad_(True)
        pooled, loss, preds = self._forward(emb, exp, st)
        self.dense_opt.zero_grad(set_to_none=True)
        loss.backward()
        mean_loss = self._dense_step(loss)
        if self.has_summary:
            with torch.no_grad():
                self.model.update_summary(pooled.detach(), st.get("dense"))
                if self.k_step == 1:
                    self._sync_summaries()
        self._push(st, req, emb, exp, seed)
        if self.k_step > 1:
            self._steps_since_sync += 1
            if self._steps_since_sync >= self.k_step:
                self._param_sync()
        if isinstance(preds, dict):
            preds = {t: v.detach() for t, v in preds.items()}
        else:
            preds = preds.detach()
        if self._collect_T:
            self._collect(preds, st)
        return mean_loss.detach(), preds

    def _push(self, st: Staged, req: torch.Tensor, emb: torch.Tensor,
              exp: Optional[torch.Tensor], seed: int) -> None:
        """The push (reference :578-637): per-key grads (the expand grads
        after the embedx grads), merged into bucket slots in ascending
        order, the rows' a2a to the owners (under a bf16 a2a the slot,
        show and click columns on their own f32 a2a), and the in-table
        update of the owned shard by the products the step carries
        (trainer.py sparse_push, the single-device step's dispatch)."""
        S = self.num_slots
        segments, valid = st["segments"], st["valid"]
        clicks = task_label(st, self.task_names[0]).index_select(
            0, segments // S)
        if exp is not None:
            pg = build_push_grads_extended(emb.grad, exp.grad, segments % S,
                                           clicks, valid)
        else:
            pg = build_push_grads(emb.grad, segments % S, clicks, valid)
        bucket_g = merge_push_grads(pg, st["bperm"], st["boffsets"])
        if self.a2a_bf16:
            meta = self._a2a(bucket_g[:, :3], "a2a_push_meta")
            gw = self._a2a(bucket_g[:, 3:].to(torch.bfloat16), "a2a_push")
            recv = torch.cat([meta, gw.to(torch.float32)], dim=1)
        else:
            recv = self._a2a(bucket_g, "a2a_push")
        sparse_push(self.table.slab, st, req, st.get("push_n_valid", 0),
                    recv, seed, self.layout, self.table.shard.config,
                    self.push_write, self.push_flags.push_block_rows,
                    self.stage_flags.wire)

    @torch.no_grad()
    def _collect(self, preds, st: Staged) -> None:
        """Device-collect AUC (reference :639-669): this step's main-task
        predictions bucketed into the pass's int32 [2, T] table (integer
        adds: exact in any order) and its Kahan-compensated f32 sums of
        (abserr, sqrerr, pred, label, count); a NaN or inf prediction is
        left out of every sum and of the table."""
        T = self._collect_T
        praw = (preds[self.task_names[0]] if isinstance(preds, dict)
                else preds).to(torch.float32)
        finite = torch.isfinite(praw)
        ok = st["ins_valid"] & finite
        p = torch.where(finite, praw, torch.zeros_like(praw)).clamp(0.0, 1.0)
        lab = st["labels"].to(torch.int64)
        w = ok.to(torch.float32)
        pos = torch.clamp((p * T).to(torch.int64), max=T - 1)
        self._mtab.index_put_((lab, pos), ok.to(torch.int32),
                              accumulate=True)
        labf = lab.to(torch.float32)
        err = p - labf
        sums = torch.stack([(err.abs() * w).sum(), (err * err * w).sum(),
                            (p * w).sum(), (labf * w).sum(), w.sum()])
        s, c = self._mstats[0], self._mstats[1]
        y = sums - c
        t = s + y
        self._mstats = torch.stack([t, (t - s) - y])

    def eval_step(self, st: Staged) -> torch.Tensor:
        """The main task's predictions of a staged test batch: the pull,
        the pool and the forward under no_grad (the SetTestMode path,
        reference _build_eval_step :1050-1071)."""
        self._wait_ready(st)
        with torch.no_grad():
            emb, exp, _ = self._pull(st)
            _, _, preds = self._forward(emb, exp, st)
        if isinstance(preds, dict):
            preds = preds[self.task_names[0]]
        return preds

    # ---------------------------------------------------------- pass cadence
    def _device_collect_size(self) -> Optional[int]:
        """The table size when EVERY registered metric can be collected on
        the device (reference :298-322): a plain single-task AUC over
        label, pred and mask, all phases, with mode_collect_in_device, one
        table size among them, and no dump writer (it reads every
        prediction); else None, and the host path serves every metric."""
        msgs = self.metrics.messages()
        if not msgs or self.multi_task or self.dump_writer is not None:
            return None
        sizes = set()
        for m in msgs:
            c = getattr(m, "calculator", None)
            if (type(m) is not MetricMsg or m.kind != "auc"
                    or m.sample_scale_var or m.uid_var
                    or m.metric_phase != -1 or m.label_var != "label"
                    or m.pred_var != "pred" or m.mask_var != "mask"
                    or c is None or not c.mode_collect_in_device):
                return None
            sizes.add(c.table_size)
        return sizes.pop() if len(sizes) == 1 else None

    def _sync_collect_mode(self) -> None:
        """Decide the pass's collect mode from the registered metrics
        (reference :324-328) and make its state."""
        self._collect_T = self._device_collect_size()
        self._mtab, self._mstats = self.make_metric_state()

    def make_metric_state(self):
        """The pass's device metric state for the current collect mode
        (reference :277-296): ``mtab`` [2, T] int32 bucket counts (exact to
        2^31, where f32 would stop counting at 2^24) and ``mstats`` [2, 5]
        f32, the Kahan (sum, compensation) pairs of abserr, sqrerr, pred,
        label and count; T = 1 when collection is off."""
        T = self._collect_T or 1
        return (torch.zeros((2, T), dtype=torch.int32, device=self.device),
                torch.zeros((2, 5), dtype=torch.float32, device=self.device))

    def _merge_collected(self) -> None:
        """The pass's device table merged into every calculator and the
        quality plane (reference :991-1011): two reads to the host, the
        Kahan pairs resolved as s - c."""
        tab = self._mtab.cpu().numpy().astype(np.float64)
        st = self._mstats.cpu().numpy().astype(np.float64)
        self.d2h_reads += 2
        sums = st[0] - st[1]
        for m in self.metrics.messages():
            m.calculator.add_bucket_stats(tab, *sums)
        if self.quality is not None:
            try:
                self.quality.add_bucket_table(tab, *sums)
            except ValueError as e:
                obs_log.warning("quality plane skipped device table",
                                error=repr(e)[:200])

    def _host_preds(self, preds):
        self.d2h_reads += 1
        return preds_to_host(preds)

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

        if self.stage_flags.wire == "ids_only" and \
                self.push_write != "scatter":
            raise ValueError(
                "the ids-only wire (h2d_lean without h2d_uid_wire) stages no "
                "push products; the trainer's write %r needs them"
                % (self.push_write,))
        self._sync_collect_mode()
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
        preds_on = self._preds_consumed() and not self._collect_T
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
                        host = self._host_preds(preds_dev)
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
                host = self._host_preds(stack_preds(tail_preds))
                for j, b in enumerate(batches[n_steps - len(tail_preds):]):
                    self._add_metrics(preds_row(host, j), b)
                    self._dump_batch(preds_row(host, j), b)
        if self._collect_T:
            self._merge_collected()
        if self._steps_since_sync:
            # the pass end is always a sync point (reference :1012-1015)
            self._param_sync()
        lap("steps")
        self.table.end_pass()
        t_pass.pause()
        mean_loss = float(np.mean(np.asarray(losses, np.float32))) \
            if losses else 0.0
        extra = {"event": "pass_end", "loss": round(mean_loss, 6),
                 "auc": {m.name: float(m.calculator.auc())
                         for m in self.metrics.messages()}}
        quality.attach_pass_extras(extra, self.quality,
                                   monitor=self.drift)
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
        """Stop the dump writer, the routing pool and the reporter, then,
        where this trainer initialized the fleet, destroy the process group
        (Fleet.stop); a fleet the caller passed in stays up for the
        caller to stop."""
        if self.dump_writer is not None:
            self.dump_writer.close()
            self.dump_writer = None
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        if getattr(self, "reporter", None) is not None:
            self.reporter.close()
            self.reporter = None
        if self._owns_fleet and self.fleet.mesh is not None:
            self.fleet.stop()
