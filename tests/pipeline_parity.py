"""The pipeline runners' parity harness, shared by tests/test_torch_pipeline.py
and the test_torch_pipeline_cluster*.py files: the small configuration, the
port's runs (in process at one stage, or on one rank of a gloo cluster of
tests/sharded_cluster.py run_cluster), the JAX runners on S (or dp x S)
virtual CPU devices (tests/conftest.py), and the sequential compositions
the port's gradients are held to.

The data has live push gradients: embedx is created at the first touch
(mf_create_thresholds=0, mf_initial_range 1e-3), so the embed columns of
the push rows are not zero (``first_step``, asserted by the tests). The
CTR oracle runs with use_pallas_push, its kernel interpreted (the expand
block's push runs apply_push, its creation replaced by the port's hash,
sharded_cluster.hash_fresh); the port replays its push seeds
(PRNGKey(seed + 31), one split a step, carried across passes:
``replay_seeds``). The pipeline over the sharded table (``sharded=`` in
the port's runs, ``sharded=True`` in the oracle's) draws a third stream:
the second half of each step's split, folded with the flat mesh index,
one list a rank (``replay_shard_seeds``). The reference's imports stay
inside the functions that build the oracle, so a spawned rank loads torch
and the port only.
"""

import dataclasses
import functools
import hashlib

import numpy as np
import torch

from paddlebox_tpu_torch.config.configs import (SparseOptimizerConfig,
                                                TableConfig)
from paddlebox_tpu_torch.config.flags import (ObsFlags, PushFlags,
                                              ShardFlags, StageFlags)
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.ops.sparse import (gather_slab_rows,
                                            pull_view_from_rows)
from paddlebox_tpu_torch.parallel.pipeline import (CtrPipelineRunner,
                                                   GPipeRunner,
                                                   PipelineConfig,
                                                   ShardedCtrPipelineRunner,
                                                   ctr_pipeline_loss,
                                                   ctr_pipeline_sections,
                                                   mlp_stage_apply)

D = 4
E = 3                 # the expand block's width
NUM_SLOTS = 4
BATCH = 16            # one packed batch = one micro-batch
D_MODEL = 16
N_MICRO = 4
CAP = 1 << 12
LR = 5e-3
SEED = 3
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
INT_COLS = [acc.SLOT, acc.SHOW, acc.CLICK, acc.UNSEEN_DAYS, acc.MF_SIZE]
MAX_STEPS = 64        # push seeds replayed: more than two passes take
# the CTR runner's forms: its keyword arguments (expand: the table's)
FORMS = {"plain": {}, "multi_task": dict(task_names=("ctr", "cvr")),
         "data_norm": dict(use_data_norm=True, dn_slot_dim=3 + D),
         "expand": dict(expand=E)}
# GPipe's configurations: the issue's two depths and the bubble case
# (micro-batches not a multiple of the depth)
GPIPE = {"S2": dict(n_stages=2, n_micro=4, d_model=8, layers_per_stage=2,
                    lr=1e-2),
         "S4": dict(n_stages=4, n_micro=8, d_model=16, layers_per_stage=2,
                    lr=1e-2),
         "S4_bubble": dict(n_stages=4, n_micro=5, d_model=16,
                           layers_per_stage=1, lr=1e-2)}
GPIPE_STEPS = 5


def write_data(out, lines=128, num_files=2):
    """(files, the port's feed) of the synthetic CTR data with the
    conversion label (the multi-task form's cvr task)."""
    from paddlebox_tpu_torch.data.generator import write_synthetic_ctr_files
    files, feed = write_synthetic_ctr_files(
        str(out), num_files=num_files, lines_per_file=lines,
        num_slots=NUM_SLOTS, vocab_per_slot=60, max_len=3, seed=12,
        conversion=True)
    return files, dataclasses.replace(feed, batch_size=BATCH)


def table_cfg(expand=0):
    return TableConfig(embedx_dim=D, pass_capacity=CAP,
                       expand_embed_dim=expand,
                       optimizer=SparseOptimizerConfig(**OPT))


def replay_seeds(n=MAX_STEPS, seed=SEED):
    """The reference's push seeds: PRNGKey(seed + 31), one split a step
    carried across passes, randint of the split-off key."""
    import jax
    import jax.numpy as jnp
    key, out = jax.random.PRNGKey(seed + 31), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(int(jax.random.randint(sub, (), 0, jnp.int32(2**31 - 1))))
    return out


def replay_shard_seeds(P, n=MAX_STEPS, seed=SEED):
    """The sharded pipeline's push seeds of each flat mesh index p < P:
    PRNGKey(seed + 31), one split a step carried across passes, the split's
    second half folded with p (reference pipeline.py:1265-1266), randint of
    that (optimizers.py:238)."""
    import jax
    import jax.numpy as jnp
    key, out = jax.random.PRNGKey(seed + 31), [[] for _ in range(P)]
    for _ in range(n):
        key, sub = jax.random.split(key)
        for p in range(P):
            k = jax.random.fold_in(sub, p)
            out[p].append(int(jax.random.randint(k, (), 0,
                                                 jnp.int32(2**31 - 1))))
    return out


def sorted_store(store):
    k, v = store.state_items()
    o = np.argsort(k)
    return k[o], v[o]


def world_allreduce(v):
    """MetricRegistry's allreduce over the default process group."""
    import torch.distributed as dist
    t = torch.from_numpy(np.array(v, np.float64))
    dist.all_reduce(t)
    return t.numpy()


# ------------------------------------------------------------------- port

def port_runner(form, S, feed, seeds, mesh=None, depth=2, dump_path=None,
                sharded=None):
    """A CtrPipelineRunner of ``form`` at S stages on the CPU, replaying
    ``seeds``, its per-step losses recorded in ``runner.step_losses``; with
    ``sharded`` (the keyword arguments of a ShardedCtrPipelineRunner:
    ``fleet`` and any of push_write, stage (StageFlags fields), and
    ps_client with ps_table_id for SectionPSTrainer) the pipeline over the
    sharded table on that fleet, built by train/factory.py."""
    kw = dict(FORMS[form])
    expand = kw.pop("expand", 0)
    common = dict(n_stages=S, d_model=D_MODEL, lr=LR, n_micro=N_MICRO,
                  mesh=mesh, seed=SEED, device="cpu",
                  shard_flags=ShardFlags(stream_depth=depth),
                  obs_flags=ObsFlags.off(),
                  dump_fields=("label", "pred") if dump_path else None,
                  dump_fields_path=dump_path, **kw)
    if sharded is None:
        r = CtrPipelineRunner(table_cfg(expand), feed, **common)
    else:
        from paddlebox_tpu_torch.train.factory import create_trainer
        sh = dict(sharded)
        r = create_trainer(
            "SectionPSTrainer" if "ps_client" in sh
            else "ShardedCtrPipelineTrainer", table_cfg(expand), feed,
            fleet=sh.pop("fleet"),
            push_flags=PushFlags(sh.pop("push_write", "auto"), 64),
            stage_flags=StageFlags(**sh.pop("stage", {})), **common, **sh)
    r.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    r.seed_fn = iter(seeds).__next__
    r.step_losses = []
    inner = r.train_step_staged

    def staged(batch, group):
        loss = inner(batch, group)
        r.step_losses.append(loss)
        return loss

    r.train_step_staged = staged
    return r


def table_store(r):
    """The runner's store: the replicated table's, or the owned shard's."""
    return getattr(r.table, "shard", r.table).store


def port_run(form, S, feed, files, seeds, mesh=None, passes=2, depth=2,
             predict=False, allreduce=None, dump_path=None, sharded=None):
    """Two passes (``passes``) of a port runner over ``files``: each
    pass's (loss, steps, world AUC), the store after it (the owned
    shard's) and its resident slab's sha256, the last
    pass's metric message (``allreduce``: the world's), the step
    losses, the initial and final params (this rank's slice), the next
    step's gradients (``probe_step``) and with ``predict``
    predict_batches' (preds, labels). ``sharded``: port_runner's (over
    the PS no store is kept: the server holds the rows)."""
    r = port_runner(form, S, feed, seeds, mesh, depth, dump_path, sharded)
    out = {"params0": r.params, "passes": [], "stores": [], "slabs": [],
           "stage": r.stage.index, "dp_rank": r.dp_rank, "dp": r.dp}
    for _ in range(passes):
        ds = BoxDataset(feed)
        ds.set_filelist(files)
        res = r.train_pass(ds)
        out["msg"] = r.metrics.get_metric_msg("auc", allreduce=allreduce)
        out["passes"].append((res["loss"], res["steps"], out["msg"]["auc"]))
        if not (sharded and "ps_client" in sharded):
            out["stores"].append(sorted_store(table_store(r)))
        out["slabs"].append(hashlib.sha256(
            r.table.resident_slab.numpy().tobytes()).hexdigest())
    out["step_losses"] = list(r.step_losses)
    out["params"] = r.params
    out["probe"] = probe_step(r, feed, files)
    if sharded is not None:
        out["collectives"] = dict(r.collective_counts)
        out["exchanges"] = r.host_mesh.exchanges
        out["push_write"] = r.push_write
    if predict:
        ds = BoxDataset(feed)
        ds.set_filelist(files)
        out["predict"] = r.predict_batches(ds)
    r.close()
    return out


def probe_step(r, feed, files):
    """The next step's forward_backward of a trained runner, nothing
    applied (its pass opened over ``files`` and closed; on the sharded
    table the feed keys unioned over the world): the row's staged leaves,
    its block and key flags as the test makes them from the pre-step slab
    (``emb``, ``exp``, ``key_valid``: slab_block, asserted bit-equal to
    the runner's pulled block), this rank's dparams, demb (and dexp) and
    the push rows (the sharded runner's: its micro slice's), as numpy. (A
    first step's push rows are zero: a fresh table's pooled features are
    all zero, so every projection sits at relu's kink.)"""
    sharded = isinstance(r, ShardedCtrPipelineRunner)
    ds = BoxDataset(feed)
    ds.set_filelist(files)
    r.table.begin_feed_pass()
    ds.load_into_memory(add_keys_fn=r.table.add_keys)
    if sharded:
        r.table.end_feed_pass(allgather=r.fleet.all_gather)
        r.table.build_owned_slabs()
    else:
        r.table.end_feed_pass()
        r.table.begin_pass()
    try:
        g = ds.split_batches(num_workers=1)[0][:r.batches_per_step]
        batch = r.device_batch(g)
        want = slab_block(r, r.table.slab.clone(), g, batch)
        with torch.no_grad():
            emb, exp, _ = r._pull_block(batch)
        np.testing.assert_array_equal(emb.numpy(), want["emb"])
        if exp is not None:
            np.testing.assert_array_equal(exp.numpy(), want["exp"])
        res = r.forward_backward(batch)
        pg = r.push_grads(batch, res["demb"], res["dexp"])
        return dict(want, batch={k: (v.numpy() if isinstance(v, torch.Tensor)
                                     else v) for k, v in batch.items()},
                    loss=float(res["loss"]),
                    dparams={k: v.numpy() for k, v in res["dparams"].items()},
                    demb=res["demb"].numpy(), pg=pg.numpy())
    finally:
        r.dense_opt.zero_grad(set_to_none=True)
        r.table.end_pass()


def slab_block(r, slab, group, batch):
    """The row's block of the pre-step ``slab`` as the sequential
    composition reads it, made apart from the runner's pull: the replicated
    runner's row ids gathered from its slab, the key flags ids != CAP - 1;
    on the sharded table every rank's pass keys with their slab rows
    (a shard's row i holds its i-th sorted pass key) all-gathered over the
    world by the fleet, looked up at the row's keys (``group``'s M
    batches), zero where a key is not valid, the flags the batches' own.
    {"emb" [M, K, 3+D], "exp" [M, K, E] or None, "key_valid" [M, K]}."""
    layout = r.layout
    if isinstance(r, ShardedCtrPipelineRunner):
        keys = np.stack([b.keys for b in group])
        valid = np.stack([b.valid for b in group])
        mine = r.table.shard.pass_keys
        allk = np.concatenate(r.fleet.all_gather(mine))
        allr = np.concatenate(r.fleet.all_gather(slab[:mine.size].numpy()))
        o = np.argsort(allk)
        allk, allr = allk[o], allr[o]
        pos = np.searchsorted(allk, keys[valid])
        assert np.array_equal(allk[pos], keys[valid])
        rows = np.zeros(keys.shape + (allr.shape[1],), np.float32)
        rows[valid] = allr[pos]
        rows = torch.from_numpy(rows.reshape(-1, allr.shape[1]))
    else:
        ids = batch["ids"]
        keys, valid = ids, (ids != CAP - 1).numpy()
        rows = gather_slab_rows(slab, ids.reshape(-1), layout)
    M, K = keys.shape
    E_ = layout.expand_dim
    emb = pull_view_from_rows(rows, layout).reshape(M, K, -1).numpy()
    exp = (rows[:, layout.expand_w:layout.expand_w + E_].reshape(M, K, E_)
           .numpy() if E_ else None)
    if isinstance(r, ShardedCtrPipelineRunner):
        emb = np.where(valid[..., None], emb, np.float32(0))
        if E_:
            exp = np.where(valid[..., None], exp, np.float32(0))
    return {"emb": emb, "exp": exp, "key_valid": valid}


# ------------------------------------------------- sequential compositions

def sequential_ctr_grads(form, params, probe):
    """The sequential composition of the S stages on one process (stage
    0's projection, every stage's blocks in order, the last's head) of
    the stacked [S, ...] ``params`` over a rank's pulled row ``probe``
    (probe_step's): (loss, {leaf: [S, ...] grads}, demb)."""
    kw = dict(FORMS[form])
    E_ = kw.pop("expand", 0)
    names = kw.get("task_names", ("ctr",))
    S = params["blk_w"].shape[0]
    p = {k: torch.from_numpy(np.array(v)).requires_grad_(
        not k.startswith("dn_")) for k, v in params.items()}
    b = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
         for k, v in probe["batch"].items()}
    M = b["segments"].shape[0]
    emb = torch.from_numpy(probe["emb"].copy()).requires_grad_(True)
    exp = None
    if E_:
        exp = torch.from_numpy(probe["exp"].copy()).requires_grad_(True)
    blocks, embed, head, proj_all = ctr_pipeline_sections(
        BATCH, NUM_SLOTS, True, E_, kw.get("use_data_norm", False),
        kw.get("dn_slot_dim", 0))
    x_all = proj_all(emb, exp, b["segments"],
                     torch.from_numpy(probe["key_valid"]), b["n_valid"])
    logits = []
    for t in range(M):
        y = embed({k: v[0] for k, v in p.items()}, x_all, t)
        for s in range(S):
            y = blocks({k: v[s] for k, v in p.items()}, y)
        logits.append(head({k: v[S - 1] for k, v in p.items()}, y))
    task_labels = ({t: b["labels_" + t] for t in names}
                   if len(names) > 1 else None)
    loss, _ = ctr_pipeline_loss(torch.stack(logits), b["labels"],
                                b["ins_valid"], task_labels, names)
    loss.backward()
    return float(loss.detach()), {k: (v.grad.numpy() if v.grad is not None
                                      else np.zeros(v.shape, np.float32))
                                  for k, v in p.items()}, emb.grad.numpy()


def assert_s_times_sequential(form, params, probes):
    """Each rank's probe-step gradients against S times the sequential
    composition's of the stacked ``params`` (the reference's scale), at
    rtol 1e-5: its stage's slice of every leaf (over dp rows, the mean of
    the rows'), the cotangent summed over its stage group (its row's);
    the push rows' embed_w and embedx columns are not all zero. ``probes``
    [(stage, dp_rank, probe)] of every rank."""
    S = params["blk_w"].shape[0]
    rows = {}
    for _, d, pr in probes:
        rows.setdefault(d, sequential_ctr_grads(form, params, pr))
    n = len(rows)
    for s, d, pr in probes:
        loss, grads, demb = rows[d]
        np.testing.assert_allclose(
            pr["loss"], np.mean([rows[i][0] for i in range(n)]), rtol=1e-5)
        np.testing.assert_allclose(pr["demb"], S * demb, rtol=1e-5,
                                   atol=1e-9)
        for k, g in pr["dparams"].items():
            want = np.mean([rows[i][1][k][s] for i in range(n)], axis=0)
            np.testing.assert_allclose(g, S * want, rtol=1e-5, atol=1e-9,
                                       err_msg="%s stage %d" % (k, s))
        pg = pr["pg"]
        assert np.abs(pg[:, 3]).max() > 0, "embed_w grads all zero"
        assert np.abs(pg[:, 4:4 + D]).max() > 0, "embedx grads all zero"


def gpipe_run(name, params0, x, y, mesh=None):
    """A port GPipeRunner of GPIPE[name] from the reference's stacked
    ``params0``: forward, sequential_forward, the first step's gradients
    and loss, then GPIPE_STEPS steps' losses and the final params (this
    rank's slice)."""
    cfg = PipelineConfig(**GPIPE[name])
    r = GPipeRunner(cfg, mesh=mesh, init_fn=lambda _: params0, device="cpu")
    out = {"forward": r.forward(x).numpy(),
           "sequential": r.sequential_forward(x).numpy(),
           "stage": r.stage.index}
    loss, grads = r.value_and_grad(x, y)
    out["grad_loss"] = loss
    out["grads"] = {k: g.numpy().copy() for k, g in grads.items()}
    out["losses"] = [r.train_step(x, y) for _ in range(GPIPE_STEPS)]
    out["params"] = r.params
    return out


def gpipe_inputs(name):
    c = GPIPE[name]
    rng = np.random.RandomState(4)
    n = c["n_micro"] * 3
    return (rng.randn(n, c["d_model"]).astype(np.float32),
            rng.randn(n, c["d_model"]).astype(np.float32))


def sequential_gpipe_grads(params0, x, y):
    """(loss, {leaf: [S, ...] grads}) of the plain composition of the
    stages: the MSE of the stacked MLP blocks in order."""
    p = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
         for k, v in params0.items()}
    out = torch.from_numpy(x)
    for s in range(p["w"].shape[0]):
        out = mlp_stage_apply({k: v[s] for k, v in p.items()}, out)
    loss = torch.mean(torch.square(out - torch.from_numpy(y)))
    loss.backward()
    return float(loss.detach()), {k: v.grad.numpy() for k, v in p.items()}


# ----------------------------------------------------------------- oracle

def jax_feed(pfeed):
    from paddlebox_tpu.config.configs import DataFeedConfig as JFeed
    from paddlebox_tpu.config.configs import SlotConfig as JSlot
    return JFeed(slots=tuple(JSlot(name=s.name, type=s.type, dim=s.dim,
                                   is_used=s.is_used, max_len=s.max_len)
                             for s in pfeed.slots),
                 batch_size=pfeed.batch_size,
                 task_label_slots=pfeed.task_label_slots)


def _jax_row_groups(jr, jfeed, halves, train):
    """A pass of the reference's single-process (dp, stage) runner fed one
    group at a time from the dp rows' files ``halves`` (reference
    test_multihost.py:387-460): the feed keys of every row, the slab, and
    the groups (row 0's M batches, then row 1's, ...), as many as the
    shortest row fills."""
    from paddlebox_tpu.data.dataset import BoxDataset as JDataset
    jr.table.begin_feed_pass()
    rows = []
    for h in halves:
        ds = JDataset(jfeed, read_threads=1, columnar=False)
        ds.set_filelist(h)
        if train:
            ds.load_into_memory(add_keys_fn=jr.table.add_keys)
        else:
            ds.load_into_memory()
            jr.table.add_keys(ds.all_keys())
        rows.append(ds.split_batches(num_workers=1)[0])
    jr.table.end_feed_pass()
    jr.begin_pass()
    n = min(len(b) for b in rows) // N_MICRO
    return [sum((b[g * N_MICRO:(g + 1) * N_MICRO] for b in rows), [])
            for g in range(n)]


def _jax_rows_predict(jr, jfeed, halves):
    """predict_batches of the single-process (dp, stage) runner over the
    rows' files, grouped as _jax_row_groups groups them."""
    jr.table.set_test_mode(True)
    try:
        preds_all, labels_all = [], []
        for group in _jax_row_groups(jr, jfeed, halves, False):
            preds = np.asarray(jr._eval(jr.params, jr._slabs,
                                        jr.device_batch(group)))
            if jr.multi_task:
                preds = preds[..., 0]
            mask = np.concatenate([b.ins_valid for b in group])
            preds_all.append(preds.reshape(-1)[mask])
            labels_all.append(np.concatenate([b.labels for b in group])[mask])
        jr.end_pass()
    finally:
        jr.table.set_test_mode(False)
    return np.concatenate(preds_all), np.concatenate(labels_all)


def jax_run(form, S, pfeed, files, dp=1, passes=2, predict=False,
            dump_path=None, sharded=False, store_factory=None, halves=None):
    """The reference's CtrPipelineRunner (``sharded``: its
    ShardedCtrPipelineRunner, the store its shards' store_view, or with
    ``store_factory`` over the CPU PS and no store) of ``form`` on S (dp x
    S) virtual CPU devices with use_pallas_push (its kernel interpreted;
    the expand block's creation the port's hash): initial and final params
    (stacked), each pass's (loss, steps, AUC) and sorted store, the step
    losses, and with ``predict`` predict_batches'. ``halves``: the dp
    rows' files, fed one group at a time (_jax_row_groups) instead of
    ``files``."""
    import jax
    import pytest
    from jax.sharding import Mesh

    import paddlebox_tpu.embedding.optimizers as jopt
    import paddlebox_tpu.embedding.pallas_push as pp
    from paddlebox_tpu.config import flags as jflags
    from paddlebox_tpu.config.configs import SparseOptimizerConfig as JOpt
    from paddlebox_tpu.config.configs import TableConfig as JTable
    from paddlebox_tpu.data.dataset import BoxDataset as JDataset
    from paddlebox_tpu.parallel.pipeline import STAGE_AXIS
    from paddlebox_tpu.parallel.pipeline import CtrPipelineRunner
    from paddlebox_tpu.parallel.pipeline import ShardedCtrPipelineRunner
    from sharded_cluster import hash_fresh

    kw = dict(FORMS[form])
    expand = kw.pop("expand", 0)
    jfeed = jax_feed(pfeed)
    old = jflags.get_flag("use_pallas_push")
    jflags.set_flag("use_pallas_push", True)
    patch = pytest.MonkeyPatch()
    patch.setattr(pp, "pallas_apply_push",
                  functools.partial(pp.pallas_apply_push, interpret=True))
    patch.setattr(jopt, "_fresh_uniform", hash_fresh(D))
    try:
        devs = np.array(jax.devices()[:dp * S])
        mesh = (Mesh(devs, (STAGE_AXIS,)) if dp == 1
                else Mesh(devs.reshape(dp, S), ("dp", STAGE_AXIS)))
        if sharded:
            JRunner = ShardedCtrPipelineRunner
            kw["store_factory"] = store_factory
        else:
            JRunner = CtrPipelineRunner
        jr = JRunner(JTable(embedx_dim=D, pass_capacity=CAP,
                            expand_embed_dim=expand, optimizer=JOpt(**OPT)),
                     jfeed, n_stages=S, d_model=D_MODEL, lr=LR,
                     n_micro=N_MICRO, mesh=mesh, seed=SEED,
                     dump_fields=("label", "pred") if dump_path else None,
                     dump_fields_path=dump_path, **kw)
        jr.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
        steps = []
        inner = jr.train_step_staged

        def staged(batch, group):
            loss = inner(batch, group)
            steps.append(loss)
            return loss

        jr.train_step_staged = staged
        out = {"params0": {k: np.array(v) for k, v in jr.params.items()},
               "passes": [], "stores": []}
        for _ in range(passes):
            if halves is not None:
                groups = _jax_row_groups(jr, jfeed, halves, True)
                losses = [jr.train_step(g) for g in groups]
                jr.end_pass()
                res = {"loss": float(np.mean(losses)), "steps": len(groups)}
            else:
                ds = JDataset(jfeed, read_threads=1, columnar=False)
                ds.set_filelist(files)
                res = jr.train_pass(ds)
            out["msg"] = jr.metrics.get_metric_msg("auc")
            out["passes"].append((res["loss"], res["steps"],
                                  out["msg"]["auc"]))
            if store_factory is None:
                out["stores"].append(sorted_store(
                    jr.table.store_view() if sharded else jr.table.store))
        out["step_losses"] = steps
        out["params"] = {k: np.array(v) for k, v in jr.params.items()}
        if predict and halves is not None:
            out["predict"] = _jax_rows_predict(jr, jfeed, halves)
        elif predict:
            ds = JDataset(jfeed, read_threads=1, columnar=False)
            ds.set_filelist(files)
            out["predict"] = jr.predict_batches(ds)
        jr.close()
    finally:
        jflags.set_flag("use_pallas_push", old)
        patch.undo()
    return out


def jax_gpipe(name, x, y):
    """The reference's GPipeRunner of GPIPE[name] on S virtual CPU
    devices: its initial params (stacked numpy), forward, sequential
    forward, GPIPE_STEPS steps' losses and final params."""
    from paddlebox_tpu.parallel.pipeline import GPipeRunner as JG
    from paddlebox_tpu.parallel.pipeline import PipelineConfig as JC
    r = JG(JC(**GPIPE[name]), seed=7)
    out = {"params0": {k: np.array(v) for k, v in r.params.items()},
           "forward": np.asarray(r.forward(x)),
           "sequential": np.asarray(r.sequential_forward(x))}
    out["losses"] = [r.train_step(x, y) for _ in range(GPIPE_STEPS)]
    out["params"] = {k: np.array(v) for k, v in r.params.items()}
    return out


# ------------------------------------------------------------- assertions

def assert_store(got, want):
    """Keys and the integer columns (show and click among them) exact, the
    rows rtol 1e-4 / atol 1e-6."""
    (gk, gv), (wk, wv) = got, want
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gv[:, INT_COLS], wv[:, INT_COLS])
    np.testing.assert_allclose(gv, wv, rtol=1e-4, atol=1e-6)


def assert_ctr_matches_jax(got, want, stage):
    """A rank's run against the reference's: the first step's loss rtol
    1e-5, every step's and pass's loss rtol 1e-4, the steps and the world
    AUC (within 1e-4), the stores after each pass (assert_store), the
    initial params bit for bit and the final ones rtol 2e-4 / atol 1e-6
    (this rank's stage slice)."""
    np.testing.assert_allclose(got["step_losses"][0],
                               want["step_losses"][0], rtol=1e-5)
    np.testing.assert_allclose(got["step_losses"], want["step_losses"],
                               rtol=1e-4)
    for (gl, gs, ga), (wl, ws, wa) in zip(got["passes"], want["passes"]):
        assert gs == ws
        np.testing.assert_allclose(gl, wl, rtol=1e-4)
        assert abs(ga - wa) <= 1e-4, (ga, wa)
    assert len(got["stores"]) == len(want["stores"])
    for g, w in zip(got["stores"], want["stores"]):
        assert_store(g, w)
    for k, v in want["params0"].items():
        assert_bits(got["params0"][k], v[stage])
    assert set(got["params"]) == set(want["params"])
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v[stage], rtol=2e-4,
                                   atol=1e-6, err_msg=k)


def assert_bits(a, b):
    np.testing.assert_array_equal(np.asarray(a).view(np.uint32),
                                  np.asarray(b).view(np.uint32))


def assert_same_stores(a, b):
    for (ak, av), (bk, bv) in zip(a, b):
        np.testing.assert_array_equal(ak, bk)
        assert_bits(av, bv)


# ---------------------------------------------------------------- clusters

def gpipe_params0(name):
    """The reference's initial GPipe params of GPIPE[name] (seed 7), as
    numpy: what jax_gpipe's runner starts from."""
    import jax
    from paddlebox_tpu.parallel.pipeline import init_stage_params as jinit
    c = GPIPE[name]
    return {k: np.array(v) for k, v in jinit(
        jax.random.PRNGKey(7), c["n_stages"], c["d_model"],
        c["layers_per_stage"]).items()}


def pipeline_rank(rank, world, port, spec):
    """A spawned rank (sharded_cluster.run_cluster's ``fn``): the world's
    mesh (``spec["dp"]`` rows: make_mesh's (data, pipeline); else
    device_mesh_1d's stage axis), then each GPipe configuration of
    ``spec["gpipe"]`` from its reference params and each CTR form of
    ``spec["forms"]`` (port_run over all the files, the world's metric
    reduction, predict_batches)."""
    from paddlebox_tpu_torch.config.configs import MeshConfig
    from paddlebox_tpu_torch.parallel.mesh import device_mesh_1d, make_mesh
    from paddlebox_tpu_torch.parallel.pipeline import STAGE_AXIS
    from sharded_cluster import join_group
    join_group(rank, world, port)
    dp = spec.get("dp", 1)
    S = world // dp
    mesh = (make_mesh(MeshConfig(data=dp, pipeline=S,
                                 axis_names=("data", "pipeline")))
            if dp > 1 else device_mesh_1d(world, axis=STAGE_AXIS))
    out = {"coords": mesh.coords}
    for name, params0 in spec.get("gpipe", {}).items():
        x, y = gpipe_inputs(name)
        out["gpipe_" + name] = gpipe_run(name, params0, x, y, mesh=mesh)
    for form in spec.get("forms", ()):
        out[form] = port_run(form, S, spec["feed"], spec["files"],
                             spec["seeds"], mesh=mesh, predict=True,
                             allreduce=world_allreduce)
    return out


def assert_gpipe_matches_jax(ranks, name, want):
    """Every rank's GPipe run against the reference's: forward and the
    gathered sequential forward (rtol 1e-5 / atol 1e-6), each step's loss
    rtol 1e-5, its stage's final params rtol 2e-4 / atol 1e-6, and its
    gradients S times the sequential composition's (rtol 1e-5)."""
    S = GPIPE[name]["n_stages"]
    x, y = gpipe_inputs(name)
    loss, grads = sequential_gpipe_grads(want["params0"], x, y)
    for r, res in enumerate(ranks):
        g = res["gpipe_" + name]
        assert g["stage"] == r
        for k in ("forward", "sequential"):
            np.testing.assert_allclose(g[k], want[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        np.testing.assert_allclose(g["losses"], want["losses"], rtol=1e-5)
        for k, v in want["params"].items():
            np.testing.assert_allclose(g["params"][k], v[r], rtol=2e-4,
                                       atol=1e-6, err_msg=k)
        np.testing.assert_allclose(g["grad_loss"], loss, rtol=1e-6)
        for k, v in grads.items():
            np.testing.assert_allclose(g["grads"][k], S * v[r], rtol=1e-5,
                                       atol=1e-9, err_msg=k)


def assert_ctr_cluster(ranks, form, want, dp=1):
    """Every rank's CTR run against the reference's (assert_ctr_matches_jax
    on its stage's slice, the world's AUC), the ranks' runs bit-identical
    to each other (the stores and slabs after each pass, the losses, a
    stage's params across dp rows), predict_batches the reference's on every
    rank, the probe step's gradients S times the sequential
    composition's."""
    from paddlebox_tpu_torch.convert import pipeline_params_to_jax
    S = len(ranks) // dp
    first = ranks[0][form]
    by_stage = {}
    for res in ranks:
        got = res[form]
        assert got["dp"] == dp
        assert_ctr_matches_jax(got, want, got["stage"])
        assert got["passes"] == first["passes"]
        assert got["step_losses"] == first["step_losses"]
        assert_same_stores(got["stores"], first["stores"])
        assert got["slabs"] == first["slabs"]
        (gp, gl), (wp, wl) = got["predict"], want["predict"]
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gp, wp, rtol=1e-4, atol=1e-6)
        prev = by_stage.setdefault(got["stage"], got["params"])
        for k, v in prev.items():
            assert_bits(got["params"][k], v)
    assert sorted(by_stage) == list(range(S))
    params = pipeline_params_to_jax([by_stage[s] for s in range(S)])
    assert_s_times_sequential(form, params,
                              [(r[form]["stage"], r[form]["dp_rank"],
                                r[form]["probe"]) for r in ranks])
    losses = [p[0] for p in first["passes"]]
    assert losses[1] < losses[0], losses


# ------------------------------------------------- the pipeline over shards

def sharded_pipeline_rank(rank, world, port, spec):
    """A spawned rank of the pipeline over the sharded table
    (sharded_cluster.run_cluster's ``fn``): a fleet over the test's
    TCPStore, the world's mesh (``spec["dp"]`` rows: make_mesh's (data,
    pipeline), each row loading its files ``spec["row_files"][row]``;
    else device_mesh_1d's stage axis, every rank loading ``spec["files"]``),
    then each run of ``spec["runs"]`` ({"form", and "ps": (port, table
    id) for SectionPSTrainer over a TcpPSClient}): port_run with the
    world's metric reduction and predict_batches, the rank's push seeds
    ``spec["seeds"][rank]``. With ``spec["refusal"]`` first the error of
    a runner over a mesh of half the world."""
    from paddlebox_tpu_torch.config.configs import MeshConfig
    from paddlebox_tpu_torch.fleet.fleet import Fleet
    from paddlebox_tpu_torch.fleet.role_maker import RoleMaker
    from paddlebox_tpu_torch.parallel.mesh import device_mesh_1d, make_mesh
    from paddlebox_tpu_torch.parallel.pipeline import STAGE_AXIS
    from paddlebox_tpu_torch.ps import TcpPSClient
    from sharded_cluster import GROUP_TIMEOUT_S
    fl = Fleet().init(RoleMaker(rank, world, "127.0.0.1:%d" % port))
    fl.init_distributed("cpu", timeout=GROUP_TIMEOUT_S)
    out = {}
    try:
        if spec.get("refusal"):
            half = device_mesh_1d(world // 2, axis=STAGE_AXIS, mesh=fl.mesh,
                                  timeout=GROUP_TIMEOUT_S)
            try:
                ShardedCtrPipelineRunner(table_cfg(), spec["feed"],
                                         n_stages=world // 2, fleet=fl,
                                         mesh=half, device="cpu")
                out["refusal"] = None
            except ValueError as e:
                out["refusal"] = str(e)
        dp = spec.get("dp", 1)
        S = world // dp
        mesh = (make_mesh(MeshConfig(data=dp, pipeline=S,
                                     axis_names=("data", "pipeline")),
                          fl.mesh, timeout=GROUP_TIMEOUT_S) if dp > 1
                else device_mesh_1d(world, axis=STAGE_AXIS, mesh=fl.mesh,
                                    timeout=GROUP_TIMEOUT_S))
        out["coords"] = mesh.coords
        files = (spec["row_files"][mesh.coords[0]] if dp > 1
                 else spec["files"])
        for name, run in spec["runs"].items():
            sharded = {"fleet": fl}
            client = None
            if run.get("ps"):
                client = TcpPSClient("127.0.0.1", run["ps"][0])
                sharded.update(ps_client=client, ps_table_id=run["ps"][1])
            try:
                out[name] = port_run(run["form"], S, spec["feed"], files,
                                     spec["seeds"][rank], mesh=mesh,
                                     predict=True, allreduce=world_allreduce,
                                     sharded=sharded)
            finally:
                if client is not None:
                    client.close()
    finally:
        fl.stop()
    return out


def union_stores(ranks, name):
    """The union of the ranks' shard stores after each pass of run
    ``name``, sorted by key."""
    out = []
    for i in range(len(ranks[0][name]["stores"])):
        k = np.concatenate([r[name]["stores"][i][0] for r in ranks])
        v = np.vstack([r[name]["stores"][i][1] for r in ranks])
        o = np.argsort(k)
        out.append((k[o], v[o]))
    return out


def assert_sharded_cluster(ranks, name, form, want, dp=1, loss_rtol=1e-4,
                           auc_atol=1e-4):
    """Every rank's run of the pipeline over the sharded table against the
    reference's: the step and pass losses (``loss_rtol``), the steps and
    the world's AUC (within ``auc_atol``), its stage's dense slices (initial bit
    for bit, final rtol 2e-4 / atol 1e-6), predict_batches (the same on
    every rank); the ranks' losses and a stage's params across dp rows
    bit-identical; the union of the shard stores after each pass the
    reference's store_view (assert_store); the probe step's gradients S
    times the sequential composition's and its push rows live on every
    rank."""
    from paddlebox_tpu_torch.convert import pipeline_params_to_jax
    S = len(ranks) // dp
    first = ranks[0][name]
    by_stage = {}
    for res in ranks:
        got = res[name]
        assert got["dp"] == dp
        assert got["passes"] == first["passes"]
        assert got["step_losses"] == first["step_losses"]
        np.testing.assert_allclose(got["step_losses"][0],
                                   want["step_losses"][0], rtol=1e-5)
        np.testing.assert_allclose(got["step_losses"], want["step_losses"],
                                   rtol=loss_rtol)
        for (gl, gs, ga), (wl, ws, wa) in zip(got["passes"],
                                              want["passes"]):
            assert gs == ws
            np.testing.assert_allclose(gl, wl, rtol=loss_rtol)
            assert abs(ga - wa) <= auc_atol, (ga, wa)
        s = got["stage"]
        for k, v in want["params0"].items():
            assert_bits(got["params0"][k], v[s])
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v[s], rtol=2e-4,
                                       atol=1e-6, err_msg=k)
        (gp, gl), (wp, wl) = got["predict"], want["predict"]
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gp, wp, rtol=1e-4, atol=1e-6)
        prev = by_stage.setdefault(s, got["params"])
        for k, v in prev.items():
            assert_bits(got["params"][k], v)
    assert sorted(by_stage) == list(range(S))
    if want["stores"]:
        union = union_stores(ranks, name)
        assert len(union) == len(want["stores"])
        for g, w in zip(union, want["stores"]):
            assert_store(g, w)
    params = pipeline_params_to_jax([by_stage[s] for s in range(S)])
    assert_s_times_sequential(form, params,
                              [(r[name]["stage"], r[name]["dp_rank"],
                                r[name]["probe"]) for r in ranks])
