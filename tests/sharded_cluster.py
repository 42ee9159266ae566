"""The sharded trainer's parity harness, shared by the test_torch_sharded*
files: the small configuration, the JAX oracle and the gloo cluster.

The port runs P gloo ranks, each spawned by ``run_cluster``
(torch.multiprocessing, spawn; each rank one thread, a process group
timeout, a TCPStore on an ephemeral port and a wall limit) and loading the
files the reference's worker r trains on; the oracle is the JAX
ShardedBoxTrainer on a P-device mesh of virtual CPU devices
(tests/conftest.py), with use_pallas_push, its kernel interpreted, and
dataset_disable_shuffle (``use_jax_pallas``); every rank replays its
shard's push seeds (``jax_shard_seeds``). The reference's imports stay
inside the functions that build the oracle, so the spawned ranks load
torch and the port only.

A rank runs the dicts of ``spec["runs"]`` in order, each a fresh
ShardedBoxTrainer over its files (``_run_rank`` names the keys a run may
carry: the model, TrainerConfig fields, the write, the wire, the slab, a
2-D mesh, the pass count and file list, the metric, a shard checkpoint
to load before or save after).
"""

import dataclasses
import functools
import os
import pickle
import time
import traceback

import numpy as np
import torch

from paddlebox_tpu_torch.config.configs import (DataFeedConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.config.flags import (DtypeFlags, HostFlags,
                                              PushFlags, ShardFlags,
                                              StageFlags)
from paddlebox_tpu_torch.convert import params_from_jax
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.data.generator import write_synthetic_ctr_files
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.fleet.fleet import Fleet
from paddlebox_tpu_torch.fleet.role_maker import RoleMaker
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.parallel.mesh import device_mesh_2d

D = 4
E = 8                   # the expand block's width
NUM_SLOTS = 4
BATCH = 32
MAX_LEN = 3
HIDDEN = (32, 16)
CAP = 1024
LR = 5e-3
NUM_FILES = 8
LINES = 128
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
INT_COLS = [acc.SLOT, acc.SHOW, acc.CLICK, acc.UNSEEN_DAYS, acc.MF_SIZE]
# a spawned rank's process group timeout and the cluster's wall limit
GROUP_TIMEOUT_S = 60.0
CLUSTER_WALL_S = 150.0


# ------------------------------------------------------------------ setup

def write_data(out, lines=LINES, num_files=NUM_FILES):
    """(files, the port's feed) of the synthetic CTR data."""
    files, feed = write_synthetic_ctr_files(
        str(out), num_files=num_files, lines_per_file=lines,
        num_slots=NUM_SLOTS, vocab_per_slot=100, max_len=MAX_LEN, seed=7)
    return files, DataFeedConfig(slots=feed.slots, batch_size=BATCH)


def table_cfg(expand=0):
    return TableConfig(embedx_dim=D, pass_capacity=CAP, expand_embed_dim=expand,
                       optimizer=SparseOptimizerConfig(**OPT))


def port_model(jparams, name="deepfm"):
    """The port's model (CtrDnn with data_norm for ``name`` 'ctr_dnn',
    CtrDnnExpand for 'expand', else DeepFM) with the reference's initial
    parameters (None: torch's initialization under seed 0)."""
    torch.manual_seed(0)
    spec = ModelSpec(num_slots=NUM_SLOTS, slot_dim=3 + D)
    if name == "ctr_dnn":
        from paddlebox_tpu_torch.models.ctr_dnn import CtrDnn
        model = CtrDnn(spec, hidden=HIDDEN, use_data_norm=True,
                       dn_slot_dim=3 + D)
    elif name == "expand":
        from paddlebox_tpu_torch.models.nn_cross import CtrDnnExpand
        model = CtrDnnExpand(spec, E, hidden=HIDDEN)
    else:
        model = DeepFM(spec, hidden=HIDDEN)
    if jparams is not None:
        model.load_state_dict(params_from_jax(jparams))
    return model


def flat_leaves(params, prefix=""):
    """{path: array} of a params dict, data_norm's nested summaries too."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(flat_leaves(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def port_dataset(feed, files):
    return BoxDataset(feed, flags=HostFlags(dataset_disable_shuffle=True))


def worker_order(files, P):
    """The file list whose i % P == r files are the reference's worker r's
    (a contiguous run of the file order: its instances)."""
    per = len(files) // P
    return [files[(i % P) * per + i // P] for i in range(len(files))]


def jax_feed(pfeed):
    from paddlebox_tpu.config.configs import DataFeedConfig as JFeed
    from paddlebox_tpu.config.configs import SlotConfig as JSlot
    return JFeed(slots=tuple(JSlot(s.name, s.type, s.is_used, s.max_len)
                             for s in pfeed.slots),
                 batch_size=pfeed.batch_size)


def jax_table_cfg(cap=CAP, expand=0):
    from paddlebox_tpu.config.configs import SparseOptimizerConfig as JOpt
    from paddlebox_tpu.config.configs import TableConfig as JTable
    return JTable(embedx_dim=D, pass_capacity=cap, expand_embed_dim=expand,
                  optimizer=JOpt(**OPT))


def jax_shard_seeds(seed, n_steps, P):
    """Each shard's push seeds of the reference's steps: the step's key is
    the first half of split(prng), folded with the shard's index
    (sharded_trainer.py:458-459), then randint (optimizers.py:235-240)."""
    import jax
    import jax.numpy as jnp
    prng = jax.random.PRNGKey(seed + 17)
    out = [[] for _ in range(P)]
    for _ in range(n_steps):
        prng, nxt = jax.random.split(prng)
        for s in range(P):
            k = jax.random.fold_in(prng, s)
            out[s].append(int(jax.random.randint(k, (), 0,
                                                 jnp.int32(2**31 - 1))))
        prng = nxt
    return out


def use_jax_pallas(monkeypatch):
    """use_pallas_push with its kernel interpreted on the CPU and
    dataset_disable_shuffle, as the port's other parity tests run them."""
    from paddlebox_tpu.config import flags as jflags
    import paddlebox_tpu.embedding.pallas_push as pp
    jflags.set_flag("use_pallas_push", True)
    jflags.set_flag("dataset_disable_shuffle", True)
    monkeypatch.setattr(pp, "pallas_apply_push",
                        functools.partial(pp.pallas_apply_push,
                                          interpret=True))


def hash_fresh(d):
    """The reference's _fresh_uniform as the port creates columns: the
    Pallas kernel's hash of (row id, column, seed), the seed the one
    _dispatch_apply_push would hand that kernel, expand column e (stream
    1) hashing d + e (the expand block's push runs apply_push)."""
    import jax
    import jax.numpy as jnp

    def fresh(prng, row_ids, shape, dtype, maxval, stream=0):
        seed = jax.random.randint(prng, (), 0, jnp.int32(2**31 - 1))
        r = jnp.asarray(row_ids).astype(jnp.uint32)[:, None]
        c = (jnp.arange(shape[1], dtype=jnp.uint32)[None, :]
             + jnp.uint32(d if stream else 0))
        bits = (r * jnp.uint32(2654435761)) ^ (c * jnp.uint32(40503)
                                               + seed.astype(jnp.uint32))
        bits = bits * jnp.uint32(747796405) + jnp.uint32(2891336453)
        bits ^= bits >> 16
        u01 = ((bits >> 8).astype(jnp.int32).astype(jnp.float32)
               * (1.0 / (1 << 24)))
        return (u01 * maxval).astype(dtype)

    return fresh


def jax_model(model_name):
    from paddlebox_tpu.models.base import ModelSpec as JSpec
    spec = JSpec(num_slots=NUM_SLOTS, slot_dim=3 + D)
    if model_name == "ctr_dnn":
        from paddlebox_tpu.models.ctr_dnn import CtrDnn as JCtrDnn
        return JCtrDnn(spec, hidden=HIDDEN, use_data_norm=True,
                       dn_slot_dim=3 + D)
    if model_name == "expand":
        from paddlebox_tpu.models.nn_cross import CtrDnnExpand as JExpand
        return JExpand(spec, expand_dim=E, hidden=HIDDEN)
    from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
    return JDeepFM(spec, hidden=HIDDEN)


def jax_reference(files, pfeed, P, predict=False, model_name="deepfm",
                  slab="float32", fields=None, flags=None, mesh2d=None,
                  passes=2, metric=None, save=None, table=None,
                  store_factory=None, day=False):
    """The JAX ShardedBoxTrainer on device_mesh_1d(P), or
    device_mesh_2d(*mesh2d): ``passes`` passes over all files (worker r
    takes the r-th contiguous run), each pass's loss and AUC (and the
    metric message), every shard's sorted store, the dense parameters and
    optimizer state, with ``predict`` predict_batches' preds after them.
    ``fields``: TrainerConfig fields besides dense_lr and scan_chunk=1;
    ``flags``: the reference's flags for the run; ``metric``: init_metric
    keywords; ``save``: a prefix the table saves its shards at;
    ``table``: TableConfig fields (the SSD tier's), the shards' tier
    sizes after each pass kept (``tier``); ``store_factory``: the shards'
    store (the reference's ps_store_factory; no store is read back);
    ``day``: end_day(age=True) after the passes, then the stores
    (``day_stores``) and LoadSSD2Mem's count and stores."""
    import jax
    from paddlebox_tpu.config import flags as jflags
    from paddlebox_tpu.config.configs import TrainerConfig as JTC
    from paddlebox_tpu.data.dataset import BoxDataset as JDataset
    from paddlebox_tpu.parallel.mesh import device_mesh_1d
    from paddlebox_tpu.parallel.mesh import device_mesh_2d as jmesh_2d
    from paddlebox_tpu.parallel.sharded_trainer import (
        ShardedBoxTrainer as JSharded)
    jfeed = jax_feed(pfeed)
    set_flags = dict(flags or {}, slab_embed_dtype=slab)
    old = {k: jflags.get_flag(k) for k in set_flags}
    for k, v in set_flags.items():
        jflags.set_flag(k, v)
    patch = None
    if model_name == "expand":
        import pytest
        from paddlebox_tpu.embedding import optimizers as jopt
        patch = pytest.MonkeyPatch()
        patch.setattr(jopt, "_fresh_uniform", hash_fresh(D))
    try:
        mesh = jmesh_2d(*mesh2d) if mesh2d else device_mesh_1d(P)
        jtable = dataclasses.replace(
            jax_table_cfg(expand=E if model_name == "expand" else 0),
            **(table or {}))
        jt = JSharded(jax_model(model_name), jtable, jfeed,
                      JTC(dense_lr=LR, scan_chunk=1, **(fields or {})),
                      mesh=mesh, seed=0, store_factory=store_factory)
        # (k_step holds P equal replicas: merged is their mean, exact)
        params0 = jax_numpy(jt.merged_params())
        jt.metrics.init_metric("auc", "label", "pred", table_size=1 << 14,
                               **(metric or {}))
        out_passes, msgs, tier = [], [], []
        for _ in range(passes):
            ds = JDataset(jfeed, read_threads=1)
            ds.set_filelist(files)
            r = jt.train_pass(ds)
            msg = jt.metrics.get_metric_msg("auc")
            msgs.append(dict(msg))
            out_passes.append((r["loss"], msg["auc"], r["batches"]))
            if store_factory is None:
                tier.append([st.spilled_count() for st in jt.table.stores])
        stores = ([] if store_factory is not None
                  else [union_store(st) for st in jt.table.stores])
        out = {"params0": params0, "passes": out_passes, "msgs": msgs,
               "stores": stores, "params": jax_numpy(jt.merged_params()),
               "opt_state": jax.tree.map(np.asarray, jt.opt_state),
               "policy": jt.table.policy.describe(), "tier": tier,
               "pass_keys": [np.asarray(k)
                             for k in jt.table._shard_keys or ()]}
        if save:
            jt.table.save(save)
            out["saved"] = [union_store(st) for st in jt.table.stores]
        if day:
            out["shrunk"] = jt.table.end_day(age=True)
            out["day_stores"] = [union_store(st) for st in jt.table.stores]
            out["day_spilled"] = [st.spilled_count()
                                  for st in jt.table.stores]
            out["ssd_loaded"] = jt.table.load_ssd_to_mem()
            out["after_load"] = [union_store(st) for st in jt.table.stores]
        frozen = getattr(jt.table.policy, "hot_keys_frozen", None)
        if frozen is not None:
            out["hot_keys"] = np.asarray(frozen())
        if predict:
            ds = JDataset(jfeed, read_threads=1)
            ds.set_filelist(files)
            out["predict"] = jt.predict_batches(ds)
        jt.close()
    finally:
        for k, v in old.items():
            jflags.set_flag(k, v)
        if patch is not None:
            patch.undo()
    return out


def jax_numpy(params):
    return {k: (jax_numpy(v) if isinstance(v, dict) else np.asarray(v))
            for k, v in params.items()}


# ----------------------------------------------------------- the cluster

def build_run(run, spec, fl, rank, mesh=None):
    """A fresh ShardedBoxTrainer of one run dict: ``model`` (deepfm,
    ctr_dnn or expand), ``cfg`` (TrainerConfig fields; scan_chunk 1 by
    default), ``table`` (TableConfig fields: the SSD tier's), ``ps`` (the
    port and table id of a PSServer: the trainer is PSGPUTrainer over a
    TcpPSClient, ``t.ps_client``), ``push`` and ``push_rows``
    (push_write and its block rows), ``stage`` (StageFlags fields),
    ``shard`` (ShardFlags fields; ``shard_rank`` {rank: fields} on top),
    ``slab``, ``metric`` (init_metric keywords), its push seeds
    spec["seeds"][run["seeds"] or the model][rank]."""
    from paddlebox_tpu_torch.train import factory
    model = run.get("model", "deepfm")
    fields = dict(run.get("cfg", {}))
    fields.setdefault("scan_chunk", 1)
    table = dataclasses.replace(table_cfg(E if model == "expand" else 0),
                                **run.get("table", {}))
    name, kw, client = "ShardedBoxTrainer", {}, None
    if run.get("ps"):
        from paddlebox_tpu_torch.ps import TcpPSClient
        client = TcpPSClient("127.0.0.1", run["ps"][0])
        name, kw = "PSGPUTrainer", dict(ps_client=client,
                                        ps_table_id=run["ps"][1])
    t = factory.create_trainer(
        name, port_model(spec["params0"][model], model), table,
        spec["feed"], TrainerConfig(dense_lr=LR, **fields), seed=0, fleet=fl,
        device="cpu", mesh=mesh, **kw,
        push_flags=PushFlags(run.get("push", "auto"),
                             run.get("push_rows", 1024)),
        stage_flags=StageFlags(**run.get("stage", {})),
        shard_flags=ShardFlags(**dict(run.get("shard", {}),
                                      **run.get("shard_rank", {}).get(
                                          rank, {}))),
        dtype_flags=DtypeFlags(run.get("slab", "float32")))
    t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14,
                          **run.get("metric", {}))
    t.seed_fn = iter(spec["seeds"][run.get("seeds", model)][rank]).__next__
    t.ps_client = client
    return t


def union_store(store):
    """(keys, rows) of a store's resident and SSD-tier rows (the tier's at
    their effective values), sorted by key."""
    k, v = store.state_items()
    snap = getattr(store, "spilled_snapshot", None)
    if snap is not None:
        sk, sv = snap()
        k, v = np.concatenate([k, sk]), np.vstack([v, sv])
    o = np.argsort(k)
    return k[o], v[o]


TIER_STATS = ("sparse_keys_spilled", "sparse_keys_faulted_in",
              "ps_rows_spilled")


def tier_day(t, fl, rank, run):
    """The day after a run's passes (``day``: end_day(age=True) on every
    rank between two barriers; over the PS, rank 0 reads 32 of its shard's
    keys from the server before and after), then with ``load_ssd`` the
    owned shard's LoadSSD2Mem, and with ``save_tier`` the shard's save
    at that prefix. Returns the record."""
    out = {}
    ps = t.ps_client
    probe = None
    if ps is not None and rank == 0:
        # the shard's 32 hottest keys: resident on the server, where the
        # shrink's decay reaches them (the tier's sweep reads unseen days
        # only)
        keys = np.sort(t.table.shard_keys(0))
        rows = ps.pull_sparse(run["ps"][1], keys, create=False)
        probe = keys[np.argsort(-rows[:, acc.SHOW], kind="stable")[:32]]
        out["probe_before"] = ps.pull_sparse(run["ps"][1], probe,
                                             create=False)
    if run.get("save_tier"):
        t.table.save(run["save_tier"])
        out["saved_union"] = union_store(t.table.stores[rank])
    fl.barrier_worker()
    if run.get("day"):
        out["shrunk"] = t.table.end_day(age=True)
    fl.barrier_worker()
    if probe is not None:
        out["probe_keys"] = probe
        out["probe_after"] = ps.pull_sparse(run["ps"][1], probe,
                                            create=False)
    if ps is None:
        out["day_union"] = union_store(t.table.stores[rank])
        out["day_spilled"] = t.table.spilled_count()
    if run.get("load_ssd"):
        out["ssd_loaded"] = t.table.load_ssd_to_mem()
        out["after_load"] = union_store(t.table.stores[rank])
        out["after_load_spilled"] = t.table.spilled_count()
        out["after_load_resident"] = len(t.table.stores[rank])
    return out


def rank_files(spec, run, rank, world):
    ds = port_dataset(spec["feed"], None)
    ds.set_filelist(run.get("files", spec["files"]))
    return ds.my_shard_files(rank, world)


def _run_rank(rank, world, port, spec):
    """One spawned rank: the runs of ``spec`` in order. Besides
    build_run's keys a run may carry ``mesh2d`` (nodes, chips),
    ``passes`` (default 2), ``files``, ``load`` / ``save`` (a shard
    checkpoint prefix read before the passes / written after them),
    ``predict`` and ``refusals`` (store_view and run_day's errors),
    ``new_fleet`` (the rank leaves its fleet and joins a new one under a
    new run id first: an exchange serves one sharding policy a fleet),
    ``raises`` (the construction must raise: its type and message are the
    run's result), ``shuffle`` (the files load through the fleet's
    TcpShuffler, make_shuffler's), ``telemetry`` (after the passes rank 0
    merges every rank's fresh report: the cluster and health records,
    /health from an exporter on a free port)."""
    def join(run_id):
        os.environ["PBTPU_RUN_ID"] = run_id
        fl = Fleet().init(RoleMaker(rank, world, "127.0.0.1:%d" % port))
        fl.init_distributed(GROUP_TIMEOUT_S, device="cpu")
        return fl

    fl = join("0")
    out, trainers = [], []
    try:
        for i, run in enumerate(spec["runs"]):
            if run.get("new_fleet"):
                # a fleet's exchange serves one sharding policy
                fl.stop()
                fl = join("run%d" % i)
            mesh = None
            if run.get("mesh2d"):
                mesh = device_mesh_2d(fl.mesh, *run["mesh2d"],
                                      timeout=GROUP_TIMEOUT_S)
            if run.get("raises"):
                try:
                    build_run(run, spec, fl, rank, mesh)
                except Exception as e:  # the run's result
                    out.append({"raised": type(e).__name__, "msg": str(e)})
                    continue
                raise AssertionError("the run did not raise")
            t = build_run(run, spec, fl, rank, mesh)
            trainers.append(t)
            shuffler = fl.make_shuffler() if run.get("shuffle") else None
            loaded = None
            if run.get("load"):
                t.table.load(run["load"])
                k, v = t.table.stores[rank].state_items()
                o = np.argsort(k)
                loaded = (k[o], v[o])
            files = rank_files(spec, run, rank, world)
            passes, msgs, instances, tier = [], [], [], []
            from paddlebox_tpu_torch.utils.stats import stat_get
            last = {n: stat_get(n) for n in TIER_STATS}
            for _ in range(run.get("passes", 2)):
                ds = (BoxDataset(spec["feed"], shuffler=shuffler)
                      if shuffler is not None
                      else port_dataset(spec["feed"], files))
                ds.set_filelist(files)
                r = t.train_pass(ds)
                msg = t.metrics.get_metric_msg(
                    "auc", allreduce=fl.metric_allreduce())
                msgs.append(dict(msg))
                passes.append((r["loss"], msg["auc"], r["batches"]))
                instances.append(r["instances"])
                now = {n: stat_get(n) for n in TIER_STATS}
                tier.append(dict({n: now[n] - last[n] for n in TIER_STATS},
                                 spilled=t.table.spilled_count()))
                last = now
            store = (None if t.ps_client is not None
                     else union_store(t.table.stores[rank]))
            res = {"passes": passes, "msgs": msgs, "store": store,
                   "tier": tier,
                   "params": t.params, "opt_state": t.opt_state,
                   # (a spill drops the residency: no slab is kept)
                   "slab_dtype": str(getattr(t.table.resident_slab,
                                             "dtype", None)),
                   "collectives": dict(t.collective_counts),
                   "a2a_bytes": dict(t.a2a_bytes),
                   "d2h_reads": t.d2h_reads,
                   "exchanges": t.host_mesh.exchanges, "loaded": loaded,
                   "policy": t.policy.describe(), "instances": instances,
                   "hot_counts": dict(t.hot_counts),
                   "route_counts": dict(t.table.route_counts),
                   "aggregator": type(t.aggregator).__name__}
            frozen = getattr(t.policy, "hot_keys_frozen", None)
            if frozen is not None:
                res["hot_keys"] = np.asarray(frozen())
                res["hot_local"] = {d: t.policy.hot_local_ids(d)
                                    for d in range(world)}
            if shuffler is not None:
                res["shuffler"] = type(shuffler).__name__
                res["shuffle_bytes"] = (shuffler.bytes_sent,
                                        shuffler.bytes_received)
                shuffler.close()
            if run.get("telemetry"):
                res["telemetry"] = telemetry(t, fl, rank)
            if run.get("day") or run.get("load_ssd") or run.get("save_tier"):
                res["day"] = tier_day(t, fl, rank, run)
            if run.get("save"):
                t.table.save(run["save"])
            if run.get("predict"):
                ds = port_dataset(spec["feed"], files)
                ds.set_filelist(files)
                preds, labels = t.predict_batches(ds)
                counts = [int(b.ins_valid.sum())
                          for b in ds.split_batches(1)[0]]
                res["predict"] = (preds, labels, counts)
            if run.get("refusals"):
                res["refusals"] = refusals(t)
            out.append(res)
    finally:
        for t in trainers:
            t.close()
            if t.ps_client is not None:
                t.ps_client.close()
        fl.stop()
    return out


def telemetry(t, fl, rank):
    """Every rank other than 0 publishes a fresh report; then rank 0
    reports and merges: (the merged cluster record, the health record,
    /health as an exporter on a free port serves it) on rank 0, None
    elsewhere."""
    import json
    import urllib.request
    from paddlebox_tpu_torch.obs import exporter
    fl.barrier_worker()
    if rank:
        t.reporter.maybe_report(t._step_count, force=True)
    fl.barrier_worker()
    if rank:
        return None
    t.reporter.maybe_report(t._step_count, force=True)
    exp = exporter.ObsExporter(0).bind(t.reporter)
    try:
        with urllib.request.urlopen("http://127.0.0.1:%d/health" % exp.port,
                                    timeout=10) as r:
            served = json.loads(r.read().decode())
    finally:
        exp.close()
    agg = t.aggregator
    return {"cluster": agg.last_cluster_report,
            "health": agg.last_cluster_health, "served": served}


def refusals(t):
    """The TypeErrors store_view, the table's store and run_day raise on
    ``t`` ({name: msg})."""
    from paddlebox_tpu_torch.train.checkpoint import run_day
    out = {}
    try:
        t.table.store_view()
    except TypeError as e:
        out["store_view"] = str(e)
    try:
        t.table.store
    except TypeError as e:
        out["store"] = str(e)
    try:
        run_day(t, [], None, "20240101")
    except TypeError as e:
        out["run_day"] = str(e)
    return out


def join_group(rank, world, port, timeout=GROUP_TIMEOUT_S):
    """A spawned rank's plain gloo process group over the test's TCPStore
    (no fleet), ``timeout`` on every collective."""
    import datetime
    import torch.distributed as dist
    td = datetime.timedelta(seconds=timeout)
    store = dist.TCPStore("127.0.0.1", port, None, is_master=False,
                          timeout=td)
    dist.init_process_group("gloo", store=dist.PrefixStore("group", store),
                            rank=rank, world_size=world, timeout=td)


def _rank_main(rank, world, port, spec, out_dir):
    """A spawned rank: ``spec["fn"](rank, world, port, spec)`` (default
    _run_rank, the sharded trainer's runs), its result pickled."""
    torch.set_num_threads(1)
    path = os.path.join(out_dir, "rank%d" % rank)
    try:
        res = spec.get("fn", _run_rank)(rank, world, port, spec)
        with open(path + ".pkl", "wb") as fh:
            pickle.dump(res, fh)
    except BaseException:
        with open(path + ".err", "w") as fh:
            fh.write(traceback.format_exc())
        raise


def run_cluster(world, spec, out_dir, target=_rank_main, meanwhile=None):
    """Spawn ``world`` ranks around a TCPStore on an ephemeral port; every
    rank must end within CLUSTER_WALL_S, or all are killed and the test
    fails. Returns the ranks' results in rank order, or with ``meanwhile``
    (a callable run here while the ranks run, such as the oracle) the pair
    (results, what it returned)."""
    import torch.distributed as dist
    import torch.multiprocessing as tmp
    store = dist.TCPStore("127.0.0.1", 0, None, is_master=True,
                          wait_for_workers=False)
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=target,
                         args=(r, world, store.port, spec, str(out_dir)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + CLUSTER_WALL_S
    side = None
    try:
        if meanwhile is not None:
            side = meanwhile()
    finally:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = {}
    for r in range(world):
        err = os.path.join(str(out_dir), "rank%d.err" % r)
        if os.path.exists(err):
            errs[r] = open(err).read()
    assert not hung, "ranks %s passed the %s s wall limit; errors %s" % (
        hung, CLUSTER_WALL_S, errs)
    assert all(p.exitcode == 0 for p in procs) and not errs, (
        [p.exitcode for p in procs], errs)
    out = []
    for r in range(world):
        with open(os.path.join(str(out_dir), "rank%d.pkl" % r), "rb") as fh:
            out.append(pickle.load(fh))
    return out if meanwhile is None else (out, side)


def cluster_spec(pfeed, files, P, refs, runs, n_steps):
    """The spec of a cluster replaying the reference's seeds: ``refs``
    {model: jax_reference's result} gives each model's initial
    parameters."""
    seeds = jax_shard_seeds(0, n_steps, P)
    return {"feed": pfeed, "files": worker_order(files, P),
            "params0": {m: r["params0"] for m, r in refs.items()},
            "runs": runs, "seeds": {m: seeds for m in refs}}


# ------------------------------------------------- the exchange in threads

class FakeMesh:
    """P ranks of MeshComm's exchange in threads of one process: each
    rank's ``exchange(parts)`` returns {source: the part it sent here}."""

    def __init__(self, world, rank, board, barrier):
        self.world, self.rank = world, rank
        self.positions_of = {r: [r] for r in range(world)}
        self._board, self._barrier = board, barrier

    def rank_of_position(self):
        return {r: r for r in range(self.world)}

    def exchange(self, parts):
        for dst, part in parts.items():
            self._board[(self.rank, dst)] = part
        self._barrier.wait()
        got = {src: self._board[(src, self.rank)] for src in range(self.world)}
        self._barrier.wait()
        return got


def threaded_exchange(P, fn):
    """fn(mesh) on P threads over one FakeMesh board: results by rank."""
    import threading
    board, barrier = {}, threading.Barrier(P)
    out = [None] * P

    def run(r):
        out[r] = fn(FakeMesh(P, r, board, barrier))

    threads = [threading.Thread(target=run, args=(r,)) for r in range(P)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    return out


# ------------------------------------------------------------ assertions

def assert_store(got, want, slab="float32"):
    """Integer columns bit-equal; float columns rtol 1e-4 / atol 1e-6, and
    on the bf16 slab its 2-byte weight columns within one bf16 step
    (2^-7 relative) as in tests/test_torch_bf16.py."""
    (gk, gv), (wk, wv) = got, want
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gv[:, INT_COLS], wv[:, INT_COLS])
    if slab == "float32":
        np.testing.assert_allclose(gv, wv, rtol=1e-4, atol=1e-6)
        return
    bf = acc.slab_codec_plan(acc.ValueLayout(D, embed_dtype=slab)).bf16_cols
    assert (np.abs(gv[:, bf] - wv[:, bf])
            <= np.abs(wv[:, bf]) * 2.0 ** -7 + 1e-30).all()
    np.testing.assert_allclose(gv[:, ~bf], wv[:, ~bf], rtol=1e-4, atol=1e-6)


def assert_bits(a, b):
    np.testing.assert_array_equal(np.asarray(a).view(np.uint32),
                                  np.asarray(b).view(np.uint32))


def assert_params(got, want, rtol=1e-4, atol=1e-6):
    gp, wp = flat_leaves(got), flat_leaves(want)
    assert set(gp) == set(wp)
    for k, v in wp.items():
        np.testing.assert_allclose(gp[k], v, rtol=rtol, atol=atol,
                                   err_msg=k)


def assert_matches_jax(res, want, rank, slab="float32", loss_rtol=1e-4,
                       auc_atol=1e-4):
    """A rank's run against the JAX run: each pass's loss and cluster AUC,
    the shard's store and the dense parameters, to the stated
    tolerances."""
    for (gl, ga, gb), (wl, wa, wb) in zip(res["passes"], want["passes"]):
        assert gb == wb
        np.testing.assert_allclose(gl, wl, rtol=loss_rtol)
        assert abs(ga - wa) <= auc_atol, (ga, wa)
    assert_store(res["store"], want["stores"][rank], slab)
    assert_params(res["params"], want["params"])


def assert_same_run(a, b):
    """Two port runs bit for bit: losses, AUC, the shard's store and the
    dense parameters."""
    assert a["passes"] == b["passes"]
    np.testing.assert_array_equal(a["store"][0], b["store"][0])
    assert_bits(a["store"][1], b["store"][1])
    fa, fb = flat_leaves(a["params"]), flat_leaves(b["params"])
    assert set(fa) == set(fb)
    for k, v in fa.items():
        assert_bits(fb[k], v)


def world_one():
    fl = Fleet().init(RoleMaker(0, 1))
    fl.init_distributed(GROUP_TIMEOUT_S, device="cpu")
    return fl
