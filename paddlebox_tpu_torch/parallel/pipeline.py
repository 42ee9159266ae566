"""Micro-batch pipeline parallelism over a stage process group.

Counterpart of paddlebox_tpu/parallel/pipeline.py (the toy GPipeRunner,
the CTR program split, CtrPipelineRunner, and the same split over the
sharded pass table, ShardedCtrPipelineRunner, with their shared pass
drivers). The reference makes the stage a mesh axis and runs
the M + S - 1 GPipe ticks as one SPMD lax.scan whose hop is lax.ppermute
(:58-112). Here the stage is a rank of a stage process group (one process
a GPU): each rank holds its own [S, ...] slice of the stacked parameters
and runs the same tick schedule (``_spmd_pipeline``): at tick t rank s
works on micro-batch t - s, rank 0 ingesting it (the embedding section),
every rank applying its blocks, the last emitting it (the head); an
activation crosses to rank + 1 by a point-to-point send inside an autograd
Function whose backward sends the gradient the other way. A rank's bubble
ticks (t - s outside [0, M)) do no work: the reference computes them and
masks them out (its clamped ingest, masked emit and discarded wrap-around
hop), and their gradients are zeros, so the numbers are the reference's
without them.

Every rank runs every hop's backward, in the reverse order of the
forward, or the group deadlocks: the hops chain through a zero token (each
op's token output feeds the next op, the last feeds the replicated
outputs), so autograd reaches them one after another from the last, and
each hop's backward hands its token a zero gradient, never None, so the
chain stays connected. The last stage's outputs are replicated with the
port's autograd ``psum`` (tensor_parallel.py, whose backward all-reduces
the gradient) and every rank computes the same loss: the backward sums
the S identical loss cotangents, so every gradient is S times the
sequential composition's, as the reference's is (its psum's transpose
under shard_map(check_vma=False) does the same). Adam sees the scale only
through its eps; the push takes it whole.

CtrPipelineRunner: the pass table is a full PassTable replicated on every
rank (every rank loads all the files); a step's group is dp x M packed
batches in the reference's row-major order, row r taking its M. A step on
one rank of a (dp, stage) mesh is

    the row's M x K ids pulled (gather_rows; the expand block's columns
    beside them) -> the pre-projection features of all M micro-batches
    (fused_seqpool_cvm, seqpool_sum) -> the GPipe schedule over the stage
    group (rank 0's embedding section, each rank's blocks, the last's
    head) -> the loss on every rank -> autograd -> the embedding cotangent
    summed over the stage group (only rank 0's is not zero) -> the dense
    gradients and the loss averaged over the dp group -> Adam on the
    rank's slices -> the data_norm running sums -> build_push_grads over
    the M micro-batches, all-gathered over the dp group -> ONE fused
    push_adagrad (push_sparse_hostdedup over the host's dedup of the dp x
    M batches every rank staged)

with push seeds from ``seed_fn`` (a torch.Generator seeded with seed + 31,
no rank mixed in), so every rank applies the same push and the slabs and
host stores stay bit-identical. A parity test replaces ``seed_fn`` to
replay the reference's stream (PRNGKey(seed + 31), one split a step).

ShardedCtrPipelineRunner (its class docstring) runs the same sections,
schedule and dense step (the shared _CtrPipeline) over a ShardedPassTable
whose shards are the world's ranks: a rank pulls its micro slice of the
row through the two all-to-alls of the sharded trainer, the stage group
all-gathers the row's block, and the push rows go back to their owners.

One rank of each dp row (its stage 0) feeds the metric registry, the
quality plane, the dump and drift with its row's predictions, so the
world's registry (summed over the ranks) is the reference's
single-process one. ``predict_batches`` runs on the group (the reference
raises above one process; here every world above one is multi-process):
every rank returns the same (preds, labels), all dp rows' in order.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import queue
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from paddlebox_tpu_torch.config.configs import (DataFeedConfig, TableConfig,
                                                TrainerConfig)
from paddlebox_tpu_torch.config.flags import (ObsFlags, PushFlags,
                                              ShardFlags, StageFlags)
from paddlebox_tpu_torch.convert import (pipeline_params_from_jax,
                                         pipeline_params_to_jax)
from paddlebox_tpu_torch.data.packer import PackedBatch
from paddlebox_tpu_torch.device import DeviceLike, resolve_device
from paddlebox_tpu_torch.embedding.optimizers import push_sparse_hostdedup
from paddlebox_tpu_torch.embedding.pass_table import (PassTable,
                                                      segment_offsets)
from paddlebox_tpu_torch.embedding.push_kernels import merge_push_grads
from paddlebox_tpu_torch.fleet.fleet import fleet as default_fleet
from paddlebox_tpu_torch.metrics import drift, quality
from paddlebox_tpu_torch.metrics.auc import MetricRegistry
from paddlebox_tpu_torch.obs import (make_cluster_aggregator,
                                     make_step_reporter, obs_rank_world,
                                     span, watchdog)
from paddlebox_tpu_torch.obs.tracer import step_trace_id, trace_ctx
from paddlebox_tpu_torch.ops.data_norm import (DataNormState, data_norm,
                                               data_norm_summary_update)
from paddlebox_tpu_torch.ops.seqpool import fused_seqpool_cvm, seqpool_sum
from paddlebox_tpu_torch.ops.sparse import (build_push_grads,
                                            build_push_grads_extended,
                                            gather_slab_rows,
                                            pull_sparse_extended,
                                            pull_view_from_rows)
from paddlebox_tpu_torch.parallel.mesh import device_mesh_1d
from paddlebox_tpu_torch.parallel.sharded_table import ShardedPassTable
from paddlebox_tpu_torch.parallel.sharded_trainer import (rank_seed,
                                                          stage_routed)
from paddlebox_tpu_torch.parallel.sharding import resolve_sharding_policy
from paddlebox_tpu_torch.parallel.tensor_parallel import (LOCAL, all_reduce_,
                                                          group_rank,
                                                          group_size, psum)
from paddlebox_tpu_torch.train.dense_optim import make_dense_optimizer
from paddlebox_tpu_torch.train.dump import DumpWriter, build_dump_tensors
from paddlebox_tpu_torch.train.trainer import (STAGER_GRACE_S, _pull,
                                               sparse_push)

STAGE_AXIS = "stage"
Params = Dict[str, torch.Tensor]


def init_stage_params(seed: int, n_stages: int, d_model: int,
                      layers_per_stage: int = 1,
                      scale: float = 0.1) -> Dict[str, np.ndarray]:
    """[S, L, d, d] MLP blocks, one row of L dense layers a stage, as numpy
    (reference :40-47, whose draws are jax.random.normal; here a numpy
    RandomState(seed)): w = scale * N(0, 1), b = 0."""
    rng = np.random.RandomState(seed)
    w = (scale * rng.randn(n_stages, layers_per_stage, d_model, d_model)
         ).astype(np.float32)
    b = np.zeros((n_stages, layers_per_stage, d_model), np.float32)
    return {"w": w, "b": b}


def mlp_stage_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """One stage's block: L x (dense + relu); params [L, d, d] / [L, d]."""
    for i in range(params["w"].shape[0]):
        x = torch.relu(x @ params["w"][i] + params["b"][i])
    return x


# ------------------------------------------------------------ the schedule

@dataclasses.dataclass(frozen=True)
class StageGroup:
    """This rank's place in a stage process group: the ``group`` (LOCAL at
    one stage), its ``size`` S, this rank's ``index`` s and the global
    ranks of its neighbours (None past either end)."""

    group: object
    size: int
    index: int
    prev: Optional[int]
    next: Optional[int]


def stage_group(group) -> StageGroup:
    """The StageGroup of ``group`` (None: the world; LOCAL: one stage)."""
    S, s = group_size(group), group_rank(group)
    if S == 1:
        return StageGroup(LOCAL, 1, 0, None, None)
    g = group if group is not None else dist.group.WORLD
    return StageGroup(
        group, S, s, dist.get_global_rank(g, s - 1) if s > 0 else None,
        dist.get_global_rank(g, s + 1) if s < S - 1 else None)


def _token(device) -> torch.Tensor:
    """The hop chain's first token: a zero that requires grad, so every
    hop after it is recorded even where nothing else it takes does."""
    return torch.zeros((), device=device, requires_grad=True)


class _SendNext(torch.autograd.Function):
    """Send ``y`` to the next stage; the backward receives y's gradient
    from it. Returns the chain's next token."""

    @staticmethod
    def forward(ctx, y, tok, stage):
        ctx.stage, ctx.shape, ctx.dtype = stage, y.shape, y.dtype
        dist.send(y.detach().contiguous(), stage.next, group=stage.group)
        return torch.zeros_like(tok)

    @staticmethod
    def backward(ctx, g_tok):
        g = torch.empty(ctx.shape, dtype=ctx.dtype, device=g_tok.device)
        dist.recv(g, ctx.stage.next, group=ctx.stage.group)
        return g, torch.zeros_like(g_tok), None


class _RecvPrev(torch.autograd.Function):
    """Receive an activation of ``shape`` from the previous stage; the
    backward sends its gradient back (zeros where none came). Returns
    (activation, the chain's next token)."""

    @staticmethod
    def forward(ctx, tok, shape, dtype, stage):
        ctx.stage, ctx.shape, ctx.dtype = stage, shape, dtype
        x = torch.empty(shape, dtype=dtype, device=tok.device)
        dist.recv(x, stage.prev, group=stage.group)
        return x, torch.zeros_like(tok)

    @staticmethod
    def backward(ctx, g_x, g_tok):
        if g_x is None:
            g_x = torch.zeros(ctx.shape, dtype=ctx.dtype,
                              device=g_tok.device)
        dist.send(g_x.contiguous(), ctx.stage.prev, group=ctx.stage.group)
        return torch.zeros_like(g_tok), None, None, None


def _spmd_pipeline(stage_apply: Callable, stage: StageGroup, n_micro: int,
                   ingest: Optional[Callable] = None,
                   emit: Optional[Callable] = None,
                   act_shape: Optional[Tuple[int, ...]] = None):
    """One rank's GPipe schedule (reference :58-112): the ONE
    implementation both runners hang their sections on. ``inputs`` has a
    leading micro axis [M, ...]; ingest(stage_params, inputs, tm) builds
    stage 0's activation for micro tm (default inputs[tm]), emit(params,
    y) maps the last stage's block output to the collected output
    (default identity); ``act_shape`` is an activation's shape (default
    inputs[0]'s: the stages hold it). Returns the replicated [M,
    *emit_shape] outputs, on every rank of the stage group."""
    ingest_fn = ingest or (lambda p, inp, tm: inp[tm])
    emit_fn = emit or (lambda p, y: y)

    def run(p: Params, inputs) -> torch.Tensor:
        S, M, s = stage.size, n_micro, stage.index
        shape = act_shape or tuple(inputs[0].shape)
        dtype = next(iter(p.values())).dtype
        device = next(iter(p.values())).device
        tok = _token(device) if S > 1 else None
        outs: List[torch.Tensor] = []
        y = None
        for t in range(M + S - 1):
            tm = t - s
            if not 0 <= tm < M:
                continue                 # this rank's bubble tick
            if s == 0:
                x = ingest_fn(p, inputs, tm)
            else:
                x, tok = _RecvPrev.apply(tok, shape, dtype, stage)
            y = stage_apply(p, x)
            if s < S - 1:
                tok = _SendNext.apply(y, tok, stage)
            else:
                outs.append(emit_fn(p, y))
        if s == S - 1:
            buf = torch.stack(outs)
        else:
            with torch.no_grad():
                e = emit_fn(p, y)
            buf = torch.zeros((M,) + tuple(e.shape), dtype=e.dtype,
                              device=e.device)
        if S == 1:
            return buf
        # the chain's last token joins the replicated outputs (adding a
        # zero), so the psum's all-reduce runs first in every rank's
        # backward and the hops after it, last to first
        return psum(buf + tok, stage.group)

    return run


# ------------------------------------------------------------------ GPipe

@dataclasses.dataclass
class PipelineConfig:
    n_stages: int = 4
    n_micro: int = 8            # micro-batches per step (= cut_list sections)
    d_model: int = 64
    layers_per_stage: int = 2
    lr: float = 1e-3


def _stage_of(mesh, n_stages: int) -> Tuple[StageGroup, Optional[object]]:
    """(the StageGroup, the dp process group or None) of a runner's
    ``mesh``: None (one stage: LOCAL; more: the world, which must hold
    n_stages ranks), or parallel/mesh.py's AxisMesh, (stage,) or (dp,
    stage) with the stage axis last."""
    if mesh is None:
        if n_stages == 1:
            return stage_group(LOCAL), None
        world = group_size(None)
        if world != n_stages:
            raise ValueError("mesh size %d != n_stages %d"
                             % (world, n_stages))
        return stage_group(None), None
    if not mesh.member:
        raise ValueError("rank %d is outside the %s mesh"
                         % (mesh.rank, mesh.shape))
    if len(mesh.names) not in (1, 2):
        raise ValueError("pipeline meshes are (stage,) or (dp, stage); got "
                         "axes %s" % (mesh.names,))
    if mesh.sizes[-1] != n_stages:
        raise ValueError("mesh stage axis %d != n_stages %d"
                         % (mesh.sizes[-1], n_stages))
    stage = stage_group(mesh.groups[-1])
    return stage, (mesh.groups[0] if len(mesh.names) == 2 else None)


class GPipeRunner:
    """The stage-sharded MLP pipeline: this rank's stage slice of the [S,
    ...] params (each rank materialises only its own, as each
    SectionWorker owns only its section's program), Adam on it with local
    gradients (nothing crosses stages), the pipelined forward.

    mesh: None (the world, of n_stages ranks; LOCAL at one stage) or a
    1-D AxisMesh (parallel/mesh.py device_mesh_1d / make_mesh) of n_stages
    ranks. init_fn(seed) -> the stacked numpy params (default
    ``init_stage_params``); the reference's init_fn takes a PRNGKey, so a
    parity test passes its stacked params back through a lambda."""

    def __init__(self, cfg: PipelineConfig, mesh=None,
                 stage_apply: Callable = mlp_stage_apply,
                 init_fn: Optional[Callable] = None, seed: int = 0,
                 device: DeviceLike = None) -> None:
        self.cfg = cfg
        if mesh is not None and mesh.size != cfg.n_stages:
            raise ValueError("mesh size %d != n_stages %d"
                             % (mesh.size, cfg.n_stages))
        self.mesh = mesh
        self.stage, _ = _stage_of(mesh, cfg.n_stages)
        self.device = resolve_device(
            device if device is not None
            else (mesh.device if mesh is not None else None))
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        self.stage_apply = stage_apply
        init = init_fn or (lambda s: init_stage_params(
            s, cfg.n_stages, cfg.d_model, cfg.layers_per_stage))
        tensors, _ = pipeline_params_from_jax(init(seed), self.stage.index)
        self.tensors = {k: t.to(self.device).requires_grad_(True)
                        for k, t in tensors.items()}
        self.dense_opt = make_dense_optimizer(
            TrainerConfig(dense_lr=cfg.lr), list(self.tensors.values()))
        self._pipe = _spmd_pipeline(stage_apply, self.stage, cfg.n_micro)

    @property
    def params(self) -> Dict[str, np.ndarray]:
        """This rank's stage slice, as numpy copies."""
        return {k: t.detach().cpu().numpy().copy()
                for k, t in self.tensors.items()}

    def _micro(self, x) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(x, np.float32)).to(self.device)
        return t.reshape(self.cfg.n_micro, -1, self.cfg.d_model)

    def forward(self, x: np.ndarray) -> torch.Tensor:
        """x: [M*mb, d] -> the pipelined output [M*mb, d], on every rank."""
        with torch.no_grad():
            out = self._pipe(self.tensors, self._micro(x))
        return out.reshape(-1, self.cfg.d_model)

    def value_and_grad(self, x: np.ndarray, y: np.ndarray
                       ) -> Tuple[float, Dict[str, torch.Tensor]]:
        """The mean squared error of the pipelined output against ``y`` and
        this rank's gradients (S times the sequential composition's, as
        the reference's), nothing applied."""
        self.dense_opt.zero_grad(set_to_none=True)
        out = self._pipe(self.tensors, self._micro(x))
        loss = torch.mean(torch.square(out - self._micro(y)))
        loss.backward()
        return float(loss.detach()), {k: t.grad
                                      for k, t in self.tensors.items()}

    def train_step(self, x: np.ndarray, y: np.ndarray) -> float:
        """One pipelined step: Adam on this rank's stage with its local
        gradients (reference :184-227)."""
        loss, _ = self.value_and_grad(x, y)
        self.dense_opt.step()
        return loss

    def sequential_forward(self, x: np.ndarray) -> torch.Tensor:
        """The unpipelined oracle (reference :230-238): the stages in order
        on this rank, their slices all-gathered over the group, a
        micro-batch at a time (each matmul at the shape the pipeline gives
        it, so the two agree bit for bit on the card too)."""
        full = {k: _gather(t.detach()[None], self.stage.group)
                for k, t in self.tensors.items()}
        outs = []
        with torch.no_grad():
            for out in self._micro(x):
                for s in range(self.cfg.n_stages):
                    out = self.stage_apply(
                        {k: v[s] for k, v in full.items()}, out)
                outs.append(out)
        return torch.cat(outs)


# -------------------------------------------------------- the CTR sections

def _task_label_of(b: PackedBatch, t: str) -> np.ndarray:
    """The ONE per-task label fallback rule (reference :505-508): tasks
    without a label slot in the feed train on the click label."""
    return (b.task_labels or {}).get(t, b.labels)


def _bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy: -z*log_sigmoid(x) -
    (1-z)*log_sigmoid(-x)."""
    z = labels.to(logits.dtype)
    return -z * F.logsigmoid(logits) - (1.0 - z) * F.logsigmoid(-logits)


def ctr_pipeline_loss(logits: torch.Tensor, labels: torch.Tensor,
                      ins_valid: torch.Tensor,
                      task_labels: Optional[Dict[str, torch.Tensor]],
                      task_names: Sequence[str]):
    """(loss, preds) of the pipelined logits (reference :511-527). Single
    task: the masked mean BCE over [M, mb] logits. Multi-task: each task's
    masked mean BCE over the [M, mb, T] head, summed in task order."""
    denom = torch.clamp(ins_valid.sum().to(logits.dtype), min=1.0)
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    if len(task_names) == 1:
        bce = _bce(logits, labels)
        return (torch.where(ins_valid, bce, zero).sum() / denom,
                torch.sigmoid(logits))
    loss = None
    for ti, t in enumerate(task_names):
        bce = _bce(logits[..., ti], task_labels[t])
        term = torch.where(ins_valid, bce, zero).sum() / denom
        loss = term if loss is None else loss + term
    return loss, torch.sigmoid(logits)


def ctr_pipeline_sections(mb: int, num_slots: int, use_cvm: bool, E: int,
                          use_data_norm: bool = False, dn_slot_dim: int = 0):
    """The CTR pipeline's program sections (reference :530-588): (blocks,
    embed_section, head, proj_input_all). proj_input_all(emb_all, exp_all,
    segments, key_valid, n_valid) assembles all M micro-batches'
    pre-projection features [M, mb, in_dim] once (the CVM-pooled slots,
    then the expand block's sum-pooled ones; exp_all None when E is 0;
    n_valid[t] the real key slots of micro t, the packer's padding tail
    after them, None: all K); embed_section normalizes micro tm's by the
    data_norm summaries (detached) where on and projects it; head maps a
    block output to the logits."""

    def blocks(p: Params, state: torch.Tensor) -> torch.Tensor:
        y = state
        for i in range(p["blk_w"].shape[0]):
            y = torch.relu(y @ p["blk_w"][i] + p["blk_b"][i])
        return y

    def proj_input_all(emb_all, exp_all, segments, key_valid, n_valid=None):
        M, K = emb_all.shape[0], emb_all.shape[1]
        xs = []
        for t in range(M):
            nv = K if n_valid is None else int(n_valid[t])
            x = fused_seqpool_cvm(emb_all[t], segments[t], key_valid[t], mb,
                                  num_slots, nv, use_cvm).reshape(mb, -1)
            if E:
                pexp = seqpool_sum(exp_all[t], segments[t], key_valid[t], mb,
                                   num_slots, nv)
                x = torch.cat([x, pexp.reshape(mb, -1)], dim=-1)
            xs.append(x)
        return torch.stack(xs)

    def embed_section(p: Params, x_all: torch.Tensor,
                      tm: int) -> torch.Tensor:
        x = x_all[tm]
        if use_data_norm:
            st = DataNormState(p["dn_size"].detach(), p["dn_sum"].detach(),
                               p["dn_sqsum"].detach())
            x = data_norm(x, st, slot_dim=dn_slot_dim)
        return torch.relu(x @ p["proj_w"] + p["proj_b"])

    def head(p: Params, y: torch.Tensor) -> torch.Tensor:
        return y @ p["head_w"] + p["head_b"]

    return blocks, embed_section, head, proj_input_all


def dn_summary_apply(local: Params, x_all: torch.Tensor, dn_decay: float,
                     dn_slot_dim: int, dp_group=LOCAL) -> Params:
    """The running-sums summary update (reference :591-607): every micro's
    pre-projection features folded into the dn leaves; over a dp group of
    more than one row the result is averaged (psum / dp, the reference's
    pmean). Returns the updated dict, new tensors at the dn keys."""
    st = data_norm_summary_update(
        DataNormState(local["dn_size"], local["dn_sum"], local["dn_sqsum"]),
        x_all.reshape(-1, x_all.shape[-1]).to(torch.float32),
        decay=dn_decay, slot_dim=dn_slot_dim)
    dp = group_size(dp_group)
    if dp > 1:
        st = DataNormState(*(_pmean(a.clone(), dp_group, dp) for a in st))
    return dict(local, dn_size=st.batch_size, dn_sum=st.batch_sum,
                dn_sqsum=st.batch_square_sum)


def _pmean(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """``t`` summed over ``group`` in place, then divided by ``n``."""
    all_reduce_(t, group)
    return t.div_(n)


def ctr_stage_host_params(seed: int, n_stages: int, layers_per_stage: int,
                          pooled_dim: int, d_model: int, scale: float = 0.1,
                          n_tasks: int = 1, use_data_norm: bool = False
                          ) -> Dict[str, np.ndarray]:
    """The CTR pipeline's stage-stacked params (reference :610-644), bit
    for bit: numpy RandomState(seed) draws in the same order. proj is live
    on stage 0 only, head on the last only; n_tasks > 1 grows the head to
    [d_model, T]; use_data_norm adds the running-summary leaves at
    DataNormState's defaults."""
    S, L = n_stages, layers_per_stage
    rng = np.random.RandomState(seed)
    head_shape = (S, d_model) if n_tasks == 1 else (S, d_model, n_tasks)
    head_b = (S,) if n_tasks == 1 else (S, n_tasks)
    p = {
        "proj_w": (scale * rng.randn(S, pooled_dim, d_model)
                   ).astype(np.float32),
        "proj_b": np.zeros((S, d_model), np.float32),
        "blk_w": (scale * rng.randn(S, L, d_model, d_model)
                  ).astype(np.float32),
        "blk_b": np.zeros((S, L, d_model), np.float32),
        "head_w": (scale * rng.randn(*head_shape)).astype(np.float32),
        "head_b": np.zeros(head_b, np.float32),
    }
    if use_data_norm:
        p["dn_size"] = np.full((S, pooled_dim), 1e4, np.float32)
        p["dn_sum"] = np.zeros((S, pooled_dim), np.float32)
        p["dn_sqsum"] = np.full((S, pooled_dim), 1e4, np.float32)
    return p


# ------------------------------------------------------------ pass drivers

def _grouped_train_pass(runner, dataset, begin_pass: Callable,
                        end_pass: Callable,
                        allgather: Optional[Callable] = None,
                        n_groups_cap: Optional[Callable[[int], int]] = None
                        ) -> Dict[str, float]:
    """The pass cadence (reference :241-366): feed pass, slab build
    (``begin_pass``), full group steps, write-back (``end_pass``). Trailing
    batches short of a full group are dropped (the reference's section
    pipeline runs full pipelines only). ``allgather`` (fleet.all_gather)
    goes to the table's end_feed_pass: the feed keys' union over the
    ranks, so ranks that feed different files route alike;
    ``n_groups_cap(n)`` (the world's minimum) caps the step groups on the
    main thread before any staging, so every rank steps as often. Under
    ``runner.shard_flags.stream_depth`` > 0 one stager thread stages the
    next groups (``device_batch``: lookup or routing, dedup, copies) up to
    that many ahead while a step trains; it is drained while joined, a
    pass never returns with it alive, and its failure to stop never masks
    an error already propagating."""
    table = runner.table
    drift.set_active(runner.drift)
    table.begin_feed_pass()
    dataset.load_into_memory(add_keys_fn=table.add_keys)
    if allgather is not None:
        table.end_feed_pass(allgather=allgather)
    else:
        table.end_feed_pass()
    begin_pass()
    batches = dataset.split_batches(num_workers=1)[0]
    G = runner.batches_per_step
    n_groups = len(batches) // G
    if n_groups_cap is not None:
        n_groups = n_groups_cap(n_groups)
    groups = [batches[lo:lo + G] for lo in range(0, n_groups * G, G)]
    losses: List[float] = []
    depth = max(0, int(runner.shard_flags.stream_depth))

    def run_step(g, staged) -> None:
        # trace id off the persistent step counter (+1: noted after the
        # step), so ids never repeat across passes
        with trace_ctx(step_trace_id(runner.rank, runner._step_count + 1)), \
                span("pipe_step"):
            losses.append(runner.train_step_staged(staged, g))
        watchdog.beat("pipeline_step")
        _pipe_note_step(runner)

    if depth and len(groups) > 1:
        out: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def produce() -> None:
            try:
                for g in groups:
                    with span("pipe_stage"):
                        staged = runner.device_batch(g)
                    while not stop.is_set():
                        try:
                            out.put((g, staged), timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    else:
                        return
            except BaseException as e:  # noqa: BLE001 (handed to consumer)
                out.put(e)

        th = threading.Thread(target=produce, daemon=True,
                              name="pipe-prefetch")
        th.start()
        try:
            for _ in groups:
                item = out.get()
                if isinstance(item, BaseException):
                    raise item
                run_step(*item)
        finally:
            stop.set()
            deadline = time.monotonic() + STAGER_GRACE_S
            while th.is_alive():
                # keep draining so a producer blocked in out.put unblocks
                try:
                    while True:
                        out.get_nowait()
                except queue.Empty:
                    pass
                th.join(timeout=1.0)
                if th.is_alive() and time.monotonic() > deadline:
                    if sys.exc_info()[1] is not None:
                        logging.getLogger("paddlebox_tpu_torch").error(
                            "pipeline prefetch stager failed to stop within "
                            "%.0fs while unwinding %r", STAGER_GRACE_S,
                            sys.exc_info()[1])
                        break
                    raise RuntimeError(
                        "pipeline prefetch stager failed to stop within "
                        "%.0fs; not returning with a live stager"
                        % STAGER_GRACE_S)
    else:
        for g in groups:
            run_step(g, runner.device_batch(g))
    end_pass()
    mean = float(np.mean(losses)) if losses else 0.0
    extra = {"event": "pass_end", "loss": round(mean, 6)}
    quality.attach_pass_extras(extra, runner.quality, runner.drift,
                               ship_state=runner.world > 1)
    runner.reporter.maybe_report(runner._step_count, force=True, extra=extra)
    return {"loss": mean, "steps": len(losses),
            "dropped_batches": len(batches) - n_groups * G}


def _pipe_note_step(runner) -> None:
    """Per-step telemetry (reference :369-377): the monotone step count
    and this rank's examples into its StepReporter."""
    runner._step_count += 1
    runner.reporter.note_examples(runner._examples_per_step)
    runner.reporter.maybe_report(runner._step_count)


def _feed_pipeline_metrics(runner, preds: np.ndarray,
                           packed_batches: Sequence[PackedBatch]) -> None:
    """One step group's predictions of this rank's dp row ([M, mb] or [M,
    mb, T]) into the metric registry, the quality plane, the DumpField
    writer and the drift monitor (reference :380-445), on the row's feeding
    rank only: every stage of a row holds the same predictions, and the
    world's registry must count each instance once."""
    if not runner.feeds_metrics:
        return
    dump = runner.dump_writer
    q = runner.quality
    if not runner.metrics.metric_names() and dump is None and q is None:
        return
    names = runner.task_names
    arr = np.asarray(preds)
    if dump is not None:
        rows = arr.reshape((len(packed_batches), -1) + arr.shape[2:])
        for j, b in enumerate(packed_batches):
            per_task = ({t: rows[j][..., ti] for ti, t in enumerate(names)}
                        if len(names) > 1 else {names[0]: rows[j]})
            tens = build_dump_tensors(runner.dump_fields, b.labels,
                                      per_task, names[0])
            if tens:
                dump.dump_batch(tens, ins_ids=b.ins_ids, mask=b.ins_valid)
    if not runner.metrics.metric_names() and q is None:
        return
    labels = np.concatenate([b.labels for b in packed_batches])
    mask = np.concatenate([b.ins_valid for b in packed_batches])
    tensors = {"label": labels, "mask": mask}
    if len(names) > 1:
        for ti, t in enumerate(names):
            tensors["pred_" + t] = arr[..., ti].reshape(-1)
            tensors["label_" + t] = np.concatenate(
                [_task_label_of(b, t) for b in packed_batches])
        tensors["pred"] = tensors["pred_" + names[0]]
    else:
        tensors["pred"] = arr.reshape(-1)
    runner.metrics.add_batch(tensors)
    if q is not None:
        q.add_batch(tensors)
        preds_by_batch = tensors["pred"].reshape(len(packed_batches), -1)
        for j, b in enumerate(packed_batches):
            q.add_slot_batch(preds_by_batch[j], b.labels, b.slots,
                             b.segments, b.valid, runner.num_slots)
    if runner.drift is not None:
        runner.drift.observe_preds(tensors["pred"], mask=mask)


def _pipeline_predict(runner, dataset, begin_pass: Callable,
                      end_pass: Callable,
                      allgather: Optional[Callable] = None,
                      n_groups_cap: Optional[Callable[[int], int]] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Test-mode inference over full groups (reference :448-490: no
    creation, no push): (preds, labels) of the covered valid instances of
    every dp row, the same on every rank (``runner.group_labels``: each
    row's labels and masks in row order). ``allgather`` and
    ``n_groups_cap`` as _grouped_train_pass's. The pass is closed and test
    mode left on every exit."""
    table = runner.table
    table.set_test_mode(True)
    opened = False
    try:
        table.begin_feed_pass()
        if len(dataset) == 0:
            dataset.load_into_memory()
        table.add_keys(dataset.all_keys())
        if allgather is not None:
            table.end_feed_pass(allgather=allgather)
        else:
            table.end_feed_pass()
        begin_pass()
        opened = True
        batches = dataset.split_batches(num_workers=1)[0]
        G = runner.batches_per_step
        n_groups = len(batches) // G
        if n_groups_cap is not None:
            n_groups = n_groups_cap(n_groups)
        preds_all, labels_all = [], []
        for lo in range(0, n_groups * G, G):
            group = batches[lo:lo + G]
            preds = runner.eval_step(runner.device_batch(group))
            preds = _gather(preds, runner.dp_group).cpu().numpy()
            if runner.multi_task:
                preds = preds[..., 0]   # the main task (task_names[0])
            preds = preds.reshape(-1)
            labels, mask = runner.group_labels(group)
            preds_all.append(preds[mask])
            labels_all.append(labels[mask])
    finally:
        if opened:
            end_pass()
        table.set_test_mode(False)
    if not preds_all:
        return np.empty(0, np.float32), np.empty(0, np.int32)
    return np.concatenate(preds_all), np.concatenate(labels_all)


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    """The group's ``t`` concatenated on dim 0 in rank order (tiled),
    outside autograd; ``t`` itself in a group of one."""
    n = group_size(group)
    if n == 1:
        return t
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def _make_dump_writer(dump_fields, dump_fields_path, dump_thread_num,
                      rank: int):
    """(fields, writer) of the DumpField writers (reference :493-502),
    rank-tagged; the writer is None unless both fields and path are
    set."""
    fields = tuple(dump_fields or ())
    if not (fields and dump_fields_path):
        return fields, None
    return fields, DumpWriter(dump_fields_path, dump_thread_num, rank=rank)


# ------------------------------------------------------- the CTR pipeline

class _CtrPipeline:
    """The CTR program split's step over a (stage,) or (dp, stage) mesh,
    shared by the two runners: the sections and this rank's stage
    tensors, the forward over the row's pulled block, the backward and the
    dense update, the host planes. A runner gives the table
    (``self.table``), the staging (``device_batch``), ``_pull_block``
    (the row's [M, K, ...] block, its expand block and the ids its shard
    served), ``_key_valid``, ``push_grads``, ``step``, ``_row`` and
    ``group_labels``. Device collectives outside the schedule count by
    kind in ``collective_counts`` where their group holds more than one
    rank."""

    def _init_sections(self, table_cfg: TableConfig, feed: DataFeedConfig,
                       n_stages: int, d_model: int, layers_per_stage: int,
                       lr: float, n_micro: Optional[int], use_cvm: bool,
                       seed: int, task_names, use_data_norm: bool,
                       dn_slot_dim: int, dn_decay: float,
                       init_scale: float) -> None:
        """The sections, this rank's stage tensors and their Adam (after
        ``self.stage``, ``self.device`` and ``self.layout`` are set)."""
        self.task_names = tuple(task_names)
        self.multi_task = len(self.task_names) > 1
        self.use_data_norm = use_data_norm
        self.dn_slot_dim = dn_slot_dim
        self.dn_decay = dn_decay
        self.table_cfg = table_cfg
        self.feed = feed
        self.num_slots = len(feed.used_sparse_slots())
        self.mb = feed.batch_size          # one PackedBatch = one micro-batch
        self.use_cvm = use_cvm
        self.n_micro = n_micro or 2 * n_stages
        self.collective_counts = collections.Counter()
        E = self.layout.expand_dim
        D = table_cfg.embedx_dim
        slot_dim = (3 + D) if use_cvm else (1 + D)
        pooled_dim = self.num_slots * (slot_dim + E)
        host = ctr_stage_host_params(seed, n_stages, layers_per_stage,
                                     pooled_dim, d_model, scale=init_scale,
                                     n_tasks=len(self.task_names),
                                     use_data_norm=use_data_norm)
        tensors, _ = pipeline_params_from_jax(host, self.stage.index)
        self.tensors = {k: t.to(self.device).requires_grad_(
            not k.startswith("dn_")) for k, t in tensors.items()}
        self.dense_opt = make_dense_optimizer(
            TrainerConfig(dense_lr=lr),
            [t for k, t in sorted(self.tensors.items())
             if not k.startswith("dn_")])
        blocks, embed_section, head, self._proj_input_all = \
            ctr_pipeline_sections(self.mb, self.num_slots, use_cvm, E,
                                  use_data_norm, dn_slot_dim)
        self._pipe = _spmd_pipeline(blocks, self.stage, self.n_micro,
                                    ingest=embed_section, emit=head,
                                    act_shape=(self.mb, d_model))
        self.seed_fn: Callable[[], int] = self._draw_seed
        # the row's stage 0 feeds the host planes (every stage of a row
        # holds its predictions)
        self.feeds_metrics = self.stage.index == 0
        self.metrics = MetricRegistry()
        self._step_count = 0
        self._examples_per_step = self.mb * self.n_micro

    def _init_planes(self, obs_flags: Optional[ObsFlags], dump_fields,
                     dump_fields_path, dump_thread_num: int,
                     aggregator=None, obs_rank: Optional[int] = None
                     ) -> None:
        obs_flags = obs_flags or ObsFlags()
        self.quality = quality.make_from_flags(obs_flags)
        self.drift = drift.make_from_flags(obs_flags)
        self.reporter = make_step_reporter(
            rank=self.rank if obs_rank is None else obs_rank,
            flags=obs_flags, aggregator=aggregator)
        self.dump_fields, self.dump_writer = _make_dump_writer(
            dump_fields, dump_fields_path if self.feeds_metrics else None,
            dump_thread_num, self.rank)

    def _draw_seed(self) -> int:
        return int(torch.randint(0, 2**31 - 1, (), generator=self._seed_gen))

    def _count(self, kind: str, group) -> None:
        if group_size(group) > 1:
            self.collective_counts[kind] += 1

    @property
    def params(self) -> Dict[str, np.ndarray]:
        """This rank's stage slice by the reference's names, as numpy
        copies (convert.pipeline_params_to_jax stacks the stages')."""
        return {k: t.detach().cpu().numpy().copy()
                for k, t in self.tensors.items()}

    # ---------------------------------------------------------------- steps
    def _forward(self, batch, grad: bool):
        """(logits replicated over the stage group, x_all, emb_all,
        exp_all, the ids the pull served) of a staged batch."""
        emb_all, exp_all, served = self._pull_block(batch)
        if grad:
            emb_all.requires_grad_(True)
            if exp_all is not None:
                exp_all.requires_grad_(True)
        x_all = self._proj_input_all(emb_all, exp_all, batch["segments"],
                                     self._key_valid(batch),
                                     batch["n_valid"])
        return (self._pipe(self.tensors, x_all), x_all, emb_all, exp_all,
                served)

    def _loss(self, logits, batch):
        task_labels = ({t: batch["labels_" + t] for t in self.task_names}
                       if self.multi_task else None)
        return ctr_pipeline_loss(logits, batch["labels"], batch["ins_valid"],
                                 task_labels, self.task_names)

    def forward_backward(self, batch) -> Dict[str, object]:
        """The step's forward and backward on a staged batch, nothing
        applied: the loss and preds (this row's), x_all, the ids the pull
        served (``served``), and the gradients as the update takes them:
        ``dparams`` this rank's (S times the sequential composition's;
        averaged over the dp rows), ``demb`` and ``dexp`` summed over the
        stage group (reference :813-858)."""
        logits, x_all, emb_all, exp_all, served = self._forward(batch, True)
        loss, preds = self._loss(logits, batch)
        self.dense_opt.zero_grad(set_to_none=True)
        loss.backward()
        # only stage 0's pull carries gradient; the sum hands its cotangent
        # to every rank of the row
        demb = (emb_all.grad if emb_all.grad is not None
                else torch.zeros_like(emb_all))
        all_reduce_(demb, self.stage.group)
        self._count("all_reduce_stage", self.stage.group)
        dexp = None
        if exp_all is not None:
            dexp = (exp_all.grad if exp_all.grad is not None
                    else torch.zeros_like(exp_all))
            all_reduce_(dexp, self.stage.group)
            self._count("all_reduce_stage", self.stage.group)
        loss = loss.detach()
        dparams = {k: t.grad for k, t in self.tensors.items()
                   if t.grad is not None}
        if self.dp > 1:
            # the dp rows' gradients of each stage averaged (the per-step
            # data-parallel sync), and their losses
            for g in dparams.values():
                _pmean(g, self.dp_group, self.dp)
                self._count("all_reduce_dp", self.dp_group)
            loss = _pmean(loss.clone(), self.dp_group, self.dp)
            self._count("all_reduce_dp", self.dp_group)
        return {"loss": loss, "preds": preds.detach(), "x_all": x_all,
                "dparams": dparams, "demb": demb, "dexp": dexp,
                "served": served}

    def _dense_update(self, r) -> None:
        """Adam on this rank's tensors, then the data_norm running sums
        (averaged over the dp rows)."""
        self.dense_opt.step()
        if self.use_data_norm:
            with torch.no_grad():
                new = dn_summary_apply(self.tensors, r["x_all"].detach(),
                                       self.dn_decay, self.dn_slot_dim,
                                       self.dp_group)
                self._count("all_reduce_dp", self.dp_group)
                for k in ("dn_size", "dn_sum", "dn_sqsum"):
                    self.tensors[k].copy_(new[k])

    def _click_rows(self, batch, m: slice) -> torch.Tensor:
        """The first task's click of each key of micro-batches ``m`` (the
        push's per-key click stat, reference :866-882), flattened."""
        segments = batch["segments"][m]
        M = segments.shape[0]
        ins = (segments // self.num_slots).long()
        m_off = (torch.arange(M, device=ins.device) * self.mb)[:, None]
        click_src = (batch["labels_" + self.task_names[0]]
                     if self.multi_task else batch["labels"])[m]
        return click_src.reshape(-1).index_select(0,
                                                  (ins + m_off).reshape(-1))

    def eval_step(self, batch) -> torch.Tensor:
        """Test-mode predictions of this row [M, mb] (or [M, mb, T]): the
        same pipelined forward under no_grad, no push, no dense update."""
        with torch.no_grad():
            logits = self._forward(batch, False)[0]
            return torch.sigmoid(logits)

    def train_step(self, packed_batches: Sequence[PackedBatch]) -> float:
        """ONE pipelined train step over a step group
        (``batches_per_step`` micro-batches)."""
        return self.train_step_staged(self.device_batch(packed_batches),
                                      packed_batches)

    def train_step_staged(self, batch, packed_batches) -> float:
        """A step whose host staging (device_batch) already happened (the
        consumer half of the pass driver's stager); its row's predictions
        go to the host planes."""
        loss, preds = self.step(batch, self.seed_fn())
        _feed_pipeline_metrics(self, preds.cpu().numpy(),
                               self._row(packed_batches))
        return float(loss)

    def restore_dense(self, params: Dict[str, np.ndarray],
                      opt_state=None) -> None:
        """Set this rank's tensors from the reference's stacked [S, ...]
        params and, with ``opt_state`` (optax.adam's state over them, or
        convert.adam_state_from_optax's form), its Adam moments, bit for
        bit."""
        tensors, adam = pipeline_params_from_jax(params, self.stage.index,
                                                 opt_state)
        with torch.no_grad():
            for k, t in tensors.items():
                self.tensors[k].copy_(t)
        self.dense_opt.state.clear()
        if adam is not None and adam["count"]:
            for k, t in self.tensors.items():
                if k.startswith("dn_"):
                    continue
                self.dense_opt.state[t] = {
                    "step": torch.tensor(float(adam["count"])),
                    "exp_avg": adam["mu"][k].to(self.device),
                    "exp_avg_sq": adam["nu"][k].to(self.device)}

    def close(self) -> None:
        """Flush and stop the dump writer and the reporter's sink."""
        if self.dump_writer is not None:
            self.dump_writer.close()
            self.dump_writer = None
        if self.reporter is not None:
            self.reporter.close()
            self.reporter = None


class CtrPipelineRunner(_CtrPipeline):
    """Pipeline-parallel training of a CTR model (the program split,
    reference :647-1014), one rank of a (stage,) or (dp, stage) mesh:

      stage 0       the pull view -> fused seqpool+CVM -> the input
                    projection (the embedding section)
      every stage   its own block of the relu tower
      last stage    the head; every rank the loss

    mesh: None (the world, of n_stages ranks; LOCAL at one stage) or a
    parallel/mesh.py AxisMesh of one axis (the stage) or two (dp, stage).
    task_names: more than one grows the last stage's head to T logits per
    instance, each trained on its task's label (the click label where the
    feed has none). use_data_norm: stage 0's projection input normalized by
    running summaries (updated by the running-sums rule after each step,
    averaged over the dp rows). shard_flags: ``stream_depth`` (the pass
    driver's prefetch stager, 0: none); obs_flags: the host planes;
    init_scale: the weights' draws' scale (ctr_stage_host_params'; the
    reference's runner keeps its default, 0.1)."""

    def __init__(self, table_cfg: TableConfig, feed: DataFeedConfig,
                 n_stages: int = 2, d_model: int = 32,
                 layers_per_stage: int = 1, lr: float = 1e-2,
                 n_micro: Optional[int] = None, use_cvm: bool = True,
                 mesh=None, seed: int = 0, task_names=("ctr",),
                 use_data_norm: bool = False, dn_slot_dim: int = 0,
                 dn_decay: float = 0.9999999, dump_fields=None,
                 dump_fields_path: Optional[str] = None,
                 dump_thread_num: int = 1, device: DeviceLike = None,
                 shard_flags: Optional[ShardFlags] = None,
                 obs_flags: Optional[ObsFlags] = None,
                 init_scale: float = 0.1) -> None:
        self.stage, self.dp_group = _stage_of(mesh, n_stages)
        self.dp_group = self.dp_group if self.dp_group is not None else LOCAL
        self.dp = group_size(self.dp_group)
        self.dp_rank = group_rank(self.dp_group)
        self.mesh = mesh
        self.world = group_size(None)
        self.rank = group_rank(None)
        self.device = resolve_device(
            device if device is not None
            else (mesh.device if mesh is not None else None))
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        self.shard_flags = shard_flags or ShardFlags()
        self.table = PassTable(table_cfg, seed=seed, device=self.device)
        self.layout = self.table.layout
        self._init_sections(table_cfg, feed, n_stages, d_model,
                            layers_per_stage, lr, n_micro, use_cvm, seed,
                            task_names, use_data_norm, dn_slot_dim, dn_decay,
                            init_scale)
        self._seed_gen = torch.Generator().manual_seed(seed + 31)
        self._init_planes(obs_flags, dump_fields, dump_fields_path,
                          dump_thread_num)

    @property
    def batches_per_step(self) -> int:
        """PackedBatches one train_step consumes: dp rows x n_micro."""
        return self.dp * self.n_micro

    # ------------------------------------------------------------ host side
    def host_batch(self, packed_batches: Sequence[PackedBatch]
                   ) -> Dict[str, object]:
        """Host staging of one step group (dp x n_micro batches, row-major
        by dp row): this row's stacked [M, ...] ids, segments, labels,
        ins_valid (and labels_<task> under multi-task) and its n_valid (the
        real key slots a micro-batch); outside test mode the push's dedup
        over every row's ids concatenated in row order (uids, perm, the
        segment offsets of each unique's real occurrences, n_uniq)."""
        if len(packed_batches) != self.batches_per_step:
            raise ValueError("need exactly dp*n_micro=%d batches, got %d"
                             % (self.batches_per_step, len(packed_batches)))
        ids = [self.table.lookup_ids(b.keys, b.valid) for b in packed_batches]
        lo = self.dp_rank * self.n_micro
        row = packed_batches[lo:lo + self.n_micro]
        out: Dict[str, object] = {
            "ids": np.stack(ids[lo:lo + self.n_micro]),
            "segments": np.stack([b.segments for b in row]),
            "labels": np.stack([b.labels for b in row]),
            "ins_valid": np.stack([b.ins_valid for b in row]),
            "n_valid": [int(b.valid.sum()) for b in row]}
        if self.multi_task:
            for t in self.task_names:
                out["labels_" + t] = np.stack([_task_label_of(b, t)
                                               for b in row])
        if not self.table.test_mode:
            push_ids = np.concatenate(ids)
            uids, perm, inv, out["n_uniq"] = self.table.dedup_for_push(
                push_ids)
            # the real occurrences: every id but the trash row's, which
            # sorts last
            n_push = int((push_ids != self.table.padding_id).sum())
            out.update(uids=uids, perm=perm,
                       offsets=segment_offsets(inv, n_push))
        return out

    def device_batch(self, packed_batches: Sequence[PackedBatch]
                     ) -> Dict[str, object]:
        """host_batch, one copy per array to the device."""
        return {k: (torch.from_numpy(v).to(self.device)
                    if isinstance(v, np.ndarray) else v)
                for k, v in self.host_batch(packed_batches).items()}

    def _row(self, packed_batches):
        lo = self.dp_rank * self.n_micro
        return packed_batches[lo:lo + self.n_micro]

    def group_labels(self, packed_batches) -> Tuple[np.ndarray, np.ndarray]:
        """(labels, ins_valid) of every row of a group, in row order."""
        return (np.concatenate([b.labels for b in packed_batches]),
                np.concatenate([b.ins_valid for b in packed_batches]))

    # ---------------------------------------------------------------- steps
    def _pull_block(self, batch):
        """(emb_all [M, K, 3+D], exp_all [M, K, E] or None, the ids) of the
        row's ids: one gather_rows launch."""
        ids = batch["ids"]
        M, K = ids.shape
        flat = ids.reshape(-1)
        E = self.layout.expand_dim
        slab = self.table.slab
        if E:
            base, exp = pull_sparse_extended(slab, flat, self.layout)
            return base.reshape(M, K, -1), exp.reshape(M, K, E), ids
        return pull_view_from_rows(gather_slab_rows(slab, flat, self.layout),
                                   self.layout).reshape(M, K, -1), None, ids

    def _key_valid(self, batch) -> torch.Tensor:
        return batch["ids"] != self.table.padding_id

    def push_grads(self, batch, demb: torch.Tensor,
                   dexp: Optional[torch.Tensor]) -> torch.Tensor:
        """The push rows [dp*M*K, 4+D(+E)] of every row, in row order: this
        row's built over its M micro-batches (slot, show, the first task's
        click, the gradients; reference :866-882) and all-gathered over the
        dp group."""
        M, K = batch["ids"].shape
        clicks = self._click_rows(batch, slice(None))
        slots = (batch["segments"] % self.num_slots).reshape(-1)
        kv = (batch["ids"] != self.table.padding_id).reshape(-1)
        if dexp is not None:
            pg = build_push_grads_extended(
                demb.reshape(M * K, -1), dexp.reshape(M * K, -1), slots,
                clicks, kv)
        else:
            pg = build_push_grads(demb.reshape(M * K, -1), slots, clicks, kv)
        return _gather(pg, self.dp_group)

    def step(self, batch, seed: int):
        """One pipelined train step on the live slab: (loss, preds [M, mb]
        or [M, mb, T]) as device tensors. Updates the slab and this rank's
        tensors IN PLACE."""
        r = self.forward_backward(batch)
        self._dense_update(r)
        pg = self.push_grads(batch, r["demb"], r["dexp"])
        push_sparse_hostdedup(self.table.slab, batch["uids"], batch["perm"],
                              batch["offsets"], batch["n_uniq"], pg, seed,
                              self.layout, self.table_cfg.optimizer)
        return r["loss"], r["preds"]

    def predict_batches(self, dataset) -> Tuple[np.ndarray, np.ndarray]:
        """Test-mode inference (SetTestMode: no creation, no push) over
        full groups: (preds, labels) of the covered valid instances of all
        dp rows, on every rank of the group (the reference's is
        single-process only)."""
        return _pipeline_predict(self, dataset, self.table.begin_pass,
                                 self.table.end_pass)

    def train_pass(self, dataset) -> Dict[str, float]:
        """One pass of the pass cadence around the pipelined step
        (``_grouped_train_pass``): {loss, steps, dropped_batches}."""
        return _grouped_train_pass(self, dataset, self.table.begin_pass,
                                   self.table.end_pass)


# ------------------------------------------- the pipeline over the shards

class ShardedCtrPipelineRunner(_CtrPipeline):
    """The CTR pipeline over the sharded pass table (reference :1017-1616):
    one rank of a (stage,) or (dp, stage) mesh that spans the world, rank
    = shard = mesh position (row-major, rank = r * S + s), the table's
    rows split over every rank by the sharding policy (key-mod, or
    table-wise, or the 2-D grid with its hot tier: ShardFlags), so a
    rank's slab holds pass_capacity / P rows. A step on rank (r, s), with
    Ml = M / S micro-batches a stage:

      its micro slice [s Ml, (s+1) Ml) of the row's M batches routed
      (bucketize on the routing pool: [P, KB] buckets, the restore) ->
      the host exchange on the stager thread (fleet MeshComm: the ids its
      shard serves on the full wire, the uid vectors on the lean wires)
      and the owner's push dedup -> the served ids' rows (gather_rows; the
      expand block's columns beside them) -> their all-to-all back over
      the world group, restored to the slice's keys -> ONE all_gather of
      the [Ml, K, ...] block over the stage group: the row's [M, K, ...]
      block -> the sections, the GPipe schedule and the loss
      (CtrPipelineRunner's) -> the embedding cotangent all-reduced over the
      stage group, this rank's Ml slice taken out -> the dense gradients
      and loss averaged over the dp group, Adam, the data_norm sums ->
      build_push_grads over the slice -> merge_push_grads into the [P KB]
      bucket rows (a sorted segment sum) -> their all-to-all to the
      owners -> the owner's in-table push (train/trainer.py sparse_push:
      the fused push_adagrad by scatter, blocked_write or the rebuild
      gather, or the uid wire's maps) with this step's seed.

    Every rank calls every world collective in the same order on every
    step, at every world size, one included (the sharded trainer's rule);
    they count by kind in ``collective_counts`` (the stage and dp
    collectives where their group holds more than one rank), the a2a
    bytes in ``a2a_bytes``. Cross-row duplicate keys merge in the owner's
    dedup: no push crosses the dp group.

    A rank's dataset is its dp row's data: the reference keeps a row whole
    in one process, the port keeps it on the row's S ranks, which load
    the same files (``batches_per_step`` is n_micro, the row's M
    batches). Every stage rank of a row holds the row's batches on the
    host, so only the embedding block crosses the stage group: the
    segments, valid flags, labels and ins_valid are stacked locally from
    the row's batches, not all-gathered. The slice's rows the router
    dropped (a bucket overflow) are zeroed before the gather, so the
    pools of the other stage ranks, whose flags still hold them, leave
    them out as the reference's gathered flags do. Under a (stage,) mesh
    dp is 1 and every rank loads all the files. A pass unions the feed
    keys over the world (end_feed_pass(allgather=fleet.all_gather)) and
    steps the world's minimum of groups (fleet.all_reduce(.., "min")), so
    ranks that feed different files route alike and step alike.

    fleet: the host-collective facade (default the module's, initialized
    from the environment's role when it is not), whose ShardMesh gives
    the device, the world group and the host exchange; mesh: an AxisMesh
    (parallel/mesh.py make_mesh or device_mesh_1d) holding every rank of
    the world, its stage axis last (None: the world as one stage axis).
    store_factory: (layout, table, seed) -> the owned shard's store
    (embedding/ps_store.py ps_store_factory puts the CPU PS behind it:
    SectionPSTrainer).
    push_flags: the write, resolved once (PushFlags.resolve_push_write:
    the shard's rows against the P KB ids it receives a step);
    stage_flags: the wire. The push seeds: ``seed_fn``, by default a
    torch.Generator seeded from (seed, rank) (sharded_trainer.rank_seed),
    drawn once a step; a parity test replays the reference's stream
    through it. The other arguments are CtrPipelineRunner's.

    ``predict_batches`` runs on the world: every rank returns the same
    (preds, labels), each row's in row order (labels gathered over the dp
    group: a rank holds its own row only). ``table`` (the
    ShardedPassTable, whose store_view CheckpointManager and run_day
    drive at world 1), ``params``, ``opt_state``, ``merged_params`` /
    ``merged_opt_state`` (world 1) and ``restore_dense`` as the replicated
    runner's."""

    def __init__(self, table_cfg: TableConfig, feed: DataFeedConfig,
                 n_stages: int = 2, d_model: int = 32,
                 layers_per_stage: int = 1, lr: float = 1e-2,
                 n_micro: Optional[int] = None, use_cvm: bool = True,
                 mesh=None, bucket_cap: Optional[int] = None, seed: int = 0,
                 fleet=None, store_factory=None, task_names=("ctr",),
                 use_data_norm: bool = False, dn_slot_dim: int = 0,
                 dn_decay: float = 0.9999999, dump_fields=None,
                 dump_fields_path: Optional[str] = None,
                 dump_thread_num: int = 1, device: DeviceLike = None,
                 shard_flags: Optional[ShardFlags] = None,
                 push_flags: Optional[PushFlags] = None,
                 stage_flags: Optional[StageFlags] = None,
                 obs_flags: Optional[ObsFlags] = None,
                 init_scale: float = 0.1) -> None:
        n_micro = n_micro or 2 * n_stages
        if n_micro % n_stages:
            raise ValueError(
                "n_micro=%d must divide by n_stages=%d (each stage device "
                "pulls an equal micro slice)" % (n_micro, n_stages))
        self.fleet = fleet if fleet is not None else default_fleet
        # close() stops the fleet only where this runner initialized it
        self._owns_fleet = not self.fleet.initialized
        if self._owns_fleet:
            self.fleet.init()
        self.shard_mesh = self.fleet.mesh or self.fleet.init_distributed(
            device)
        self.P = self.world = self.shard_mesh.world
        self.rank = self.shard_mesh.rank
        self.device = self.shard_mesh.device
        if mesh is None:
            mesh = device_mesh_1d(self.P, axis=STAGE_AXIS,
                                  mesh=self.shard_mesh)
        if mesh.size != self.P:
            raise ValueError(
                "the sharded pipeline's table spans the world: the mesh %s "
                "holds %d ranks, the world %d" % (mesh.shape, mesh.size,
                                                  self.P))
        self.mesh = mesh
        self.stage, dp_group = _stage_of(mesh, n_stages)
        self.dp_group = dp_group if dp_group is not None else LOCAL
        self.dp = group_size(self.dp_group)
        self.dp_rank = group_rank(self.dp_group)
        self.m_local = n_micro // n_stages
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        self.shard_flags = shard_flags or ShardFlags()
        self.push_flags = push_flags or PushFlags()
        self.stage_flags = stage_flags or StageFlags()
        self.policy = resolve_sharding_policy(self.P, flags=self.shard_flags)
        # the per-step host exchange; its bring-up checks that every rank
        # runs this policy
        self.host_mesh = self.fleet.make_mesh_comm(
            [self.rank], policy_id=self.policy.describe())
        # bucket slack over the uniform Ml K / P expectation
        self.bucket_cap = bucket_cap or max(
            16, (2 * self.m_local * feed.key_capacity()) // self.P)
        self.table = ShardedPassTable(
            table_cfg, self.P, self.bucket_cap, seed=seed,
            owned_shards=[self.rank], policy=self.policy, device=self.device,
            shard_flags=self.shard_flags, store_factory=store_factory,
            host_ranks=self.shard_mesh.chips)
        self.layout = self.table.layout
        self.push_write = self.push_flags.resolve_push_write(
            self.table.shard_cap, self.P * self.bucket_cap, self.device,
            self.stage_flags)
        self.a2a_bytes = collections.Counter()
        self.hot_counts: Dict[str, int] = {}
        self._pool: Optional[ThreadPoolExecutor] = None
        self._init_sections(table_cfg, feed, n_stages, d_model,
                            layers_per_stage, lr, n_micro, use_cvm, seed,
                            task_names, use_data_norm, dn_slot_dim, dn_decay,
                            init_scale)
        self._seed_gen = torch.Generator().manual_seed(
            rank_seed(seed, self.rank))
        obs_rank, obs_world = (obs_rank_world(self.host_mesh, self.fleet)
                               if self.multiprocess else (0, 1))
        self.aggregator = (make_cluster_aggregator(
            fleet=self.fleet, rank=obs_rank, world=obs_world,
            flags=obs_flags) if self.multiprocess else None)
        self._init_planes(obs_flags, dump_fields, dump_fields_path,
                          dump_thread_num, self.aggregator, obs_rank)

    @property
    def multiprocess(self) -> bool:
        """Whether the job spans processes: every world above one."""
        return self.P > 1

    @property
    def batches_per_step(self) -> int:
        """PackedBatches one train_step consumes: this rank's row's
        n_micro."""
        return self.n_micro

    @property
    def opt_state(self) -> Dict[str, object]:
        """This rank's Adam state in convert.adam_state_from_optax's form
        ({"mu", "nu": {name: numpy}, "count"}), the data_norm leaves
        without moments."""
        mu, nu, count = {}, {}, 0
        for k, t in self.tensors.items():
            st = self.dense_opt.state.get(t)
            if k.startswith("dn_") or not st:
                continue
            mu[k] = st["exp_avg"].detach().cpu().numpy().copy()
            nu[k] = st["exp_avg_sq"].detach().cpu().numpy().copy()
            count = int(st["step"])
        return {"mu": mu, "nu": nu, "count": count}

    def merged_params(self) -> Dict[str, np.ndarray]:
        """The reference's stacked [S, ...] params: at world 1 this rank's
        one stage (run_day's dense save); above it every rank holds its
        own stage, and the job saves per rank."""
        self._one_process("merged_params")
        return pipeline_params_to_jax([self.params])

    def merged_opt_state(self) -> Dict[str, object]:
        self._one_process("merged_opt_state")
        st = self.opt_state
        return dict(st, mu={k: v[None] for k, v in st["mu"].items()},
                    nu={k: v[None] for k, v in st["nu"].items()})

    def _one_process(self, what: str) -> None:
        if self.multiprocess:
            raise TypeError("%s needs every stage in one process (world 1); "
                            "a multi-process pipeline saves per rank" % what)

    # ------------------------------------------------------------ host side
    def _stager_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max(1, self.shard_flags.stager_threads),
                thread_name_prefix="pipe-stager")
        return self._pool

    def host_batch(self, packed_batches: Sequence[PackedBatch]
                   ) -> Dict[str, object]:
        """Host staging of this row's M batches (reference :1476-1539):
        the row's stacked [M, ...] segments, valid flags, labels,
        ins_valid (labels_<task> under multi-task) and n_valid; this
        stage's micro slice's Ml x K keys routed on the routing pool
        (``restore``, and ``valid_loc``, the slice's flags after the
        routing) while the row stacks; then sharded_trainer.stage_routed's
        products: the host exchange and, outside test mode, the push's
        dedup by the wire and the bucket merge's order. Collective (the
        exchange): every rank stages its steps in the same order."""
        if len(packed_batches) != self.n_micro:
            raise ValueError("need exactly n_micro=%d batches (this rank's "
                             "dp row), got %d"
                             % (self.n_micro, len(packed_batches)))
        Ml, s = self.m_local, self.stage.index
        sub = packed_batches[s * Ml:(s + 1) * Ml]
        keys = np.concatenate([b.keys for b in sub])
        valid = np.concatenate([b.valid for b in sub])
        routed = self._stager_pool().submit(self.table.bucketize, keys,
                                            valid)
        out: Dict[str, object] = {
            "segments": np.stack([b.segments for b in packed_batches]),
            "valid": np.stack([b.valid for b in packed_batches]),
            "labels": np.stack([b.labels for b in packed_batches]),
            "ins_valid": np.stack([b.ins_valid for b in packed_batches]),
            "n_valid": [int(b.valid.sum()) for b in packed_batches]}
        if self.multi_task:
            for t in self.task_names:
                out["labels_" + t] = np.stack(
                    [_task_label_of(b, t) for b in packed_batches])
        idx = routed.result()
        out.update(restore=idx.restore, valid_loc=valid)
        out.update(stage_routed(idx, valid, self.rank, self.P,
                                self.bucket_cap, self.table, self.host_mesh,
                                self.policy, self.stage_flags.wire,
                                self.push_write, self.hot_counts))
        return out

    def device_batch(self, packed_batches: Sequence[PackedBatch]
                     ) -> Dict[str, object]:
        """host_batch, one copy per array to the device (ints stay host
        ints)."""
        return {k: (torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device) if isinstance(v, np.ndarray) else v)
            for k, v in self.host_batch(packed_batches).items()}

    def _row(self, packed_batches):
        return packed_batches

    def group_labels(self, packed_batches) -> Tuple[np.ndarray, np.ndarray]:
        """(labels, ins_valid) of every row of the world's step group, in
        row order: this row's gathered over the dp group."""
        labels = np.concatenate([b.labels for b in packed_batches])
        mask = np.concatenate([b.ins_valid for b in packed_batches])
        if self.dp == 1:
            return labels, mask
        t = torch.from_numpy(np.stack([labels.astype(np.int64),
                                       mask.astype(np.int64)], axis=1))
        got = _gather(t.to(self.device), self.dp_group).cpu().numpy()
        return got[:, 0].astype(labels.dtype), got[:, 1].astype(bool)

    # ---------------------------------------------------------------- steps
    def _a2a(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous(),
                               group=self.shard_mesh.group)
        self.collective_counts[kind] += 1
        self.a2a_bytes[kind] += t.nbytes
        return out

    def _pull_block(self, batch):
        """The row's block (reference :1262-1295): the ids this shard
        serves (the host exchange's on the full wire, else the buckets'
        a2a), their rows (gather_rows; the extended pull's base and expand
        columns side by side), the values' a2a back, restored to the
        slice's keys (rows the router dropped zeroed), then all-gathered
        over the stage group outside autograd: (emb_all [M, K, 3+D],
        exp_all [M, K, E] or None, the served ids)."""
        req = (batch["req"] if "req" in batch
               else self._a2a(batch["buckets"], "a2a_ids"))
        E = self.layout.expand_dim
        base, exp = _pull(self.table.slab, req, self.layout, bool(E))
        vals = base if exp is None else torch.cat([base, exp], dim=1)
        loc = self._a2a(vals, "a2a_pull").index_select(0, batch["restore"])
        loc = torch.where(batch["valid_loc"][:, None], loc,
                          torch.zeros_like(loc))
        K = batch["segments"].shape[1]
        blk = _gather(loc.reshape(self.m_local, K, -1), self.stage.group)
        self._count("all_gather_stage", self.stage.group)
        if not E:
            return blk, None, req
        w = 3 + self.layout.embedx_dim
        return blk[..., :w].clone(), blk[..., w:].clone(), req

    def _key_valid(self, batch) -> torch.Tensor:
        return batch["valid"]

    def push_grads(self, batch, demb: torch.Tensor,
                   dexp: Optional[torch.Tensor]) -> torch.Tensor:
        """This rank's push rows [Ml*K, 4+D(+E)]: its micro slice of the
        cotangent (summed over the stage group), with the slice's slot,
        show and first task's click (reference :1317-1344); the keys the
        router dropped are masked."""
        Ml, s = self.m_local, self.stage.index
        m = slice(s * Ml, (s + 1) * Ml)
        K = batch["segments"].shape[1]
        clicks = self._click_rows(batch, m)
        slots = (batch["segments"][m] % self.num_slots).reshape(-1)
        kv = batch["valid_loc"]
        if dexp is not None:
            return build_push_grads_extended(
                demb[m].reshape(Ml * K, -1), dexp[m].reshape(Ml * K, -1),
                slots, clicks, kv)
        return build_push_grads(demb[m].reshape(Ml * K, -1), slots, clicks,
                                kv)

    def step(self, batch, seed: int):
        """One pipelined train step on the shard slab: (loss, preds [M, mb]
        or [M, mb, T]) as device tensors. Updates the slab and this rank's
        tensors IN PLACE (reference :1259-1392)."""
        r = self.forward_backward(batch)
        self._dense_update(r)
        pg = self.push_grads(batch, r["demb"], r["dexp"])
        recv = self._a2a(merge_push_grads(pg, batch["bperm"],
                                          batch["boffsets"]), "a2a_push")
        sparse_push(self.table.slab, batch, r["served"],
                    batch.get("push_n_valid", 0), recv, seed, self.layout,
                    self.table.shard.config, self.push_write,
                    self.push_flags.push_block_rows, self.stage_flags.wire)
        return r["loss"], r["preds"]

    # ---------------------------------------------------------------- passes
    def _n_groups_min(self, n: int) -> int:
        return int(self.fleet.all_reduce(np.asarray([n], np.int64),
                                         "min")[0])

    def train_pass(self, dataset) -> Dict[str, float]:
        """One pass (reference :1602-1616): the feed keys' union over the
        world, the owned shard's slab (build_owned_slabs: the incremental
        lifecycle), the world's minimum of step groups, the touched rows'
        write-back and check_need_limit_mem (the table's end_pass):
        {loss, steps, dropped_batches}."""
        if self.stage_flags.wire == "ids_only" and \
                self.push_write != "scatter":
            raise ValueError(
                "the ids-only wire (h2d_lean without h2d_uid_wire) stages no "
                "push products; the runner's write %r needs them"
                % (self.push_write,))
        return _grouped_train_pass(self, dataset,
                                   self.table.build_owned_slabs,
                                   self.table.end_pass,
                                   allgather=self.fleet.all_gather,
                                   n_groups_cap=self._n_groups_min)

    def predict_batches(self, dataset) -> Tuple[np.ndarray, np.ndarray]:
        """Test-mode inference (SetTestMode: no creation, no push) over the
        world's minimum of full groups: (preds, labels) of every row's
        covered valid instances, in row order, on every rank."""
        return _pipeline_predict(self, dataset, self.table.build_owned_slabs,
                                 self.table.end_pass,
                                 allgather=self.fleet.all_gather,
                                 n_groups_cap=self._n_groups_min)

    def close(self) -> None:
        """Stop the dump writer, the routing pool and the reporter, then,
        where this runner initialized the fleet, destroy the process group
        (Fleet.stop); a fleet the caller passed in stays up."""
        super().close()
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        if self._owns_fleet and self.fleet.mesh is not None:
            self.fleet.stop()
