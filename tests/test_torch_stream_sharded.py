"""The streaming runner over the sharded trainer: StreamingRunner driving
ShardedBoxTrainer, its feed passes unioned across the ranks by the fleet's
all_gather (wait_admit(allgather=), reference streaming_runner.py:55-82,
265-268).

  * World 1 (gloo in this process): the stream over ShardedBoxTrainer
    equals the stream over BoxTrainer bit for bit, micro-checkpoints and
    journal publishes included: every pass's loss and AUC, the admitted
    and refused windows, the store at every boundary.
  * Gloo clusters of P = 2 and 4 ranks (tests/sharded_cluster.py
    run_cluster), each rank streaming its own files: three clean windows
    and, third, a poisoned one that every rank refuses. The stream equals
    the same ranks' sequential preloaded passes over the admitted windows
    (run_preloaded_passes, its feed passes unioned the same way) bit for
    bit: each pass's loss and cluster AUC and the rank's store after it.
    The refused window leaves every rank's store as it was. Against the
    JAX StreamingRunner over a P-device ShardedBoxTrainer (use_pallas_push
    interpreted, dataset_disable_shuffle, the shards' push seeds
    replayed), whose window is the P ranks' windows in worker order: the
    same admitted and refused windows, each pass's loss rtol 1e-4 and AUC
    within 1e-4, each rank's store against its shard's at
    tests/test_torch_sharded.py's tolerances (integer columns exact, rows
    rtol 1e-4 / atol 1e-6).
  * Ranks that disagree on a window (one refuses what the other admits)
    do not stall: a rank's run raises within the process group's timeout
    (the rank that ends first may return normally, as in the reference).
"""

import os
import shutil

import numpy as np
import pytest

from paddlebox_tpu_torch.config.configs import (CheckpointConfig,
                                                DataFeedConfig, TrainerConfig)
from paddlebox_tpu_torch.config.flags import (HostFlags, PushFlags,
                                              StreamFlags)
from paddlebox_tpu_torch.data import StreamingDataset
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.data.generator import write_synthetic_ctr_files
from paddlebox_tpu_torch.fleet.fleet import Fleet
from paddlebox_tpu_torch.fleet.role_maker import RoleMaker
from paddlebox_tpu_torch.train import StreamingRunner, factory
from paddlebox_tpu_torch.train.checkpoint import CheckpointManager
from paddlebox_tpu_torch.train.preload import run_preloaded_passes
from paddlebox_tpu_torch.train.trainer import BoxTrainer
from sharded_cluster import (GROUP_TIMEOUT_S, assert_bits, assert_store,
                             jax_feed, jax_model, jax_shard_seeds,
                             jax_table_cfg, port_model, run_cluster,
                             table_cfg, union_store, use_jax_pallas,
                             world_one)

NUM_SLOTS = 4
BATCH = 32
LINES = 64
WINDOW = 2 * LINES       # a rank's window: two files
N_CLEAN = 3
LR = 5e-3
POLL = 0.02
FLAGS = StreamFlags(streaming_poll_secs=POLL)
POISON_SLOT = 2
NO_SHUFFLE = {"flags": HostFlags(dataset_disable_shuffle=True)}
# the windows in order: clean, clean, poisoned, clean
ORDER = ("c0", "c1", "poison", "c2")
MAX_STEPS = 64
# the disagreement run's process-group timeout
DISAGREE_TIMEOUT_S = 10.0


def _poison_line(line):
    """The line with every id of slot POISON_SLOT replaced by one key."""
    tok = line.split()
    pos = 2   # the click slot: "1 <label>"
    for s in range(NUM_SLOTS):
        n = int(tok[pos])
        if s == POISON_SLOT:
            tok[pos + 1:pos + 1 + n] = ["999999"] * n
        pos += 1 + n
    return " ".join(tok)


def _poison(srcs, dst):
    with open(dst, "w") as fh:
        for f in srcs:
            for line in open(f):
                fh.write(_poison_line(line) + "\n")
    return dst


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(clean files of LINES lines, the port's feed): enough for four
    ranks' three clean windows of two files."""
    out = tmp_path_factory.mktemp("torch_stream_sharded")
    files, feed = write_synthetic_ctr_files(
        str(out), num_files=4 * 2 * N_CLEAN, lines_per_file=LINES,
        num_slots=NUM_SLOTS, vocab_per_slot=80, max_len=3, seed=13)
    return files, DataFeedConfig(slots=feed.slots, batch_size=BATCH)


def rank_windows(files, P, r, root):
    """Rank r's windows in ORDER: (kind, its files); the poisoned window
    is rank r's first window's lines, slot POISON_SLOT collapsed."""
    clean = [files[(w * P + r) * 2:(w * P + r) * 2 + 2]
             for w in range(N_CLEAN)]
    os.makedirs(root, exist_ok=True)
    poison = _poison(clean[0], os.path.join(root, "poison-r%d.txt" % r))
    return [(k, [poison] if k == "poison" else clean[int(k[1])])
            for k in ORDER]


def drop(windows, watch, t0=1.7e9):
    """Copy each window's files into ``watch`` in order, by
    write-temp-then-rename, their mtimes a second apart."""
    os.makedirs(watch, exist_ok=True)
    i = 0
    for _, fs in windows:
        for f in fs:
            dst = os.path.join(watch, "drop-%04d.txt" % i)
            shutil.copy(f, dst + ".tmp")
            os.replace(dst + ".tmp", dst)
            os.utime(dst, (t0 + i, t0 + i))
            i += 1


def record_passes(trainer, log, allreduce=None):
    """Wrap ``trainer.train_pass`` to log (loss, AUC, batches) after each
    pass, the AUC the cluster's under ``allreduce``."""
    inner = trainer.train_pass

    def train_pass(ds, preloaded=False):
        r = inner(ds, preloaded=preloaded)
        msg = trainer.metrics.get_metric_msg("auc", allreduce=allreduce)
        log.append((r["loss"], msg["auc"], r["batches"]))
        return r
    trainer.train_pass = train_pass


def spy_boundaries(runner, store_of, out):
    """Record (window, admitted, the store) at every boundary, before its
    publish and save."""
    inner = runner._boundary

    def boundary(win, admitted):
        out.append((win.index, admitted, union_store(store_of())))
        return inner(win, admitted)
    runner._boundary = boundary


def stream(trainer, feed, watch, ledger, store_of, allreduce=None, cm=None,
           dataset_kwargs=None):
    """One StreamingRunner run over ``watch``: its result, the passes'
    (loss, AUC, batches) and the boundaries' stores."""
    log, bounds = [], []
    record_passes(trainer, log, allreduce)
    s = StreamingDataset(feed, watch, ledger_dir=ledger,
                         micro_pass_instances=WINDOW,
                         dataset_kwargs=dataset_kwargs, flags=FLAGS)
    runner = StreamingRunner(trainer, s, cm=cm, flags=FLAGS)
    spy_boundaries(runner, store_of, bounds)
    res = runner.run(idle_timeout=1.0)
    del trainer.train_pass
    return res, log, bounds


# ---------------------------------------------------------------- world 1

def test_world_one_stream_equals_the_single_device_stream(data, tmp_path):
    """BoxTrainer and ShardedBoxTrainer at world 1, each streaming the
    same four windows with a CheckpointManager and its journal (a publish
    at every admitted boundary, the micro-checkpoints StreamFlags' cadence
    gives): bit for bit."""
    import jax
    files, pfeed = data
    windows = rank_windows(files, 1, 0, str(tmp_path / "src"))
    jparams = {k: np.asarray(v) for k, v in jax_model("deepfm").init(
        jax.random.PRNGKey(0)).items()}
    seeds = [int(x) for x in np.random.RandomState(1).randint(
        0, 2**31 - 1, MAX_STEPS)]
    cfg = TrainerConfig(dense_lr=LR, scan_chunk=2)
    fl = world_one()
    out = {}
    try:
        for name in ("single", "sharded"):
            if name == "single":
                t = BoxTrainer(port_model(jparams), table_cfg(), pfeed, cfg,
                               seed=0, flags=PushFlags("scatter"),
                               device="cpu")
                store_of = lambda t=t: t.table.store  # noqa: E731
            else:
                t = factory.create_trainer(
                    "ShardedBoxTrainer", port_model(jparams), table_cfg(),
                    pfeed, cfg, seed=0, fleet=fl, device="cpu")
                assert not t.multiprocess
                store_of = lambda t=t: t.table.stores[0]  # noqa: E731
            t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
            t.seed_fn = iter(seeds).__next__
            root = tmp_path / name
            watch = str(root / "watch")
            drop(windows, watch)
            cm = CheckpointManager(CheckpointConfig(
                batch_model_dir=str(root / "batch"),
                xbox_model_dir=str(root / "xbox"), async_save=False),
                t.table)
            res, log, bounds = stream(t, pfeed, watch, str(root), store_of,
                                      cm=cm)
            out[name] = (res, log, bounds, sorted(os.listdir(root / "batch")))
            t.close()
    finally:
        fl.stop()
    (ra, la, ba, da), (rb, lb, bb, db) = out["single"], out["sharded"]
    seq = [(p["window"], p["admitted"]) for p in ra["passes"]]
    assert seq == [(p["window"], p["admitted"]) for p in rb["passes"]]
    assert seq == [(0, True), (1, True), (2, False), (3, True)]
    assert la == lb and len(la) == 3
    assert da == db and "stream-000000" in da
    for (wa, aa, sa), (wb, ab, sb) in zip(ba, bb):
        assert (wa, aa) == (wb, ab)
        np.testing.assert_array_equal(sa[0], sb[0])
        assert_bits(sa[1], sb[1])
    # the refused window's boundary sees the store of the one before
    assert_bits(ba[2][2][1], ba[1][2][1])


# ------------------------------------------------------------ the cluster

def join(rank, world, port, timeout=GROUP_TIMEOUT_S):
    os.environ["PBTPU_RUN_ID"] = "0"
    fl = Fleet().init(RoleMaker(rank, world, "127.0.0.1:%d" % port))
    fl.init_distributed(timeout, device="cpu")
    return fl


def rank_trainer(spec, fl, rank):
    t = factory.create_trainer(
        "ShardedBoxTrainer", port_model(spec["params0"]), table_cfg(),
        spec["feed"], TrainerConfig(dense_lr=LR, scan_chunk=1), seed=0,
        fleet=fl, device="cpu", push_flags=PushFlags("scatter"))
    t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    t.seed_fn = iter(spec["seeds"][rank]).__next__
    return t


def _stream_rank(rank, world, port, spec):
    """A spawned rank: its stream, then its sequential preloaded passes
    over the windows the stream admitted, each on a fresh trainer."""
    fl = join(rank, world, port)
    root = os.path.join(spec["root"], "rank%d" % rank)
    windows = rank_windows(spec["files"], world, rank,
                           os.path.join(root, "src"))
    drop(windows, os.path.join(root, "watch"))
    allreduce = fl.metric_allreduce()
    out = {}
    try:
        t = rank_trainer(spec, fl, rank)
        res, log, bounds = stream(
            t, spec["feed"], os.path.join(root, "watch"), root,
            lambda: t.table.stores[rank], allreduce,
            dataset_kwargs=NO_SHUFFLE)
        out["stream"] = {"passes": log, "bounds": bounds,
                         "admitted": [(p["window"], p["admitted"])
                                      for p in res["passes"]],
                         "store": union_store(t.table.stores[rank])}
        t.close()
        t = rank_trainer(spec, fl, rank)
        log, stores = [], []
        record_passes(t, log, allreduce)
        admitted = [fs for (kind, fs), (_, ok) in
                    zip(windows, out["stream"]["admitted"]) if ok]
        datasets = []
        for fs in admitted:
            ds = BoxDataset(spec["feed"], **NO_SHUFFLE)
            ds.set_filelist(fs)
            datasets.append(ds)
        run_preloaded_passes(t, datasets, after_pass=lambda i, r: stores.append(
            union_store(t.table.stores[rank])))
        out["sequential"] = {"passes": log, "stores": stores}
        t.close()
    finally:
        fl.stop()
    return out


def jax_stream(files, pfeed, P, root):
    """The JAX StreamingRunner over a P-device ShardedBoxTrainer, its
    window the P ranks' windows in worker order: the windows' sequence,
    each pass's (loss, AUC, batches) and every shard's store."""
    import jax
    import pytest as _pytest
    from paddlebox_tpu.config import flags as jflags
    from paddlebox_tpu.config.configs import TrainerConfig as JTC
    from paddlebox_tpu.data.streaming import StreamingDataset as JStream
    from paddlebox_tpu.parallel.mesh import device_mesh_1d
    from paddlebox_tpu.parallel.sharded_trainer import \
        ShardedBoxTrainer as JSharded
    from paddlebox_tpu.train.streaming_runner import \
        StreamingRunner as JRunner
    patch = _pytest.MonkeyPatch()
    old = {k: jflags.get_flag(k) for k in ("use_pallas_push",
                                           "dataset_disable_shuffle",
                                           "streaming_poll_secs")}
    try:
        use_jax_pallas(patch)
        jflags.set_flag("streaming_poll_secs", POLL)
        ranks = [rank_windows(files, P, r, os.path.join(root, "src%d" % r))
                 for r in range(P)]
        windows = [(ranks[0][w][0], [f for r in range(P)
                                     for f in ranks[r][w][1]])
                   for w in range(len(ORDER))]
        watch = os.path.join(root, "watch")
        drop(windows, watch)
        jfeed = jax_feed(pfeed)
        jt = JSharded(jax_model("deepfm"), jax_table_cfg(), jfeed,
                      JTC(dense_lr=LR, scan_chunk=1), mesh=device_mesh_1d(P),
                      seed=0)
        jt.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
        log = []
        record_passes(jt, log)
        s = JStream(jfeed, watch, ledger_dir=root, read_threads=1,
                    micro_pass_instances=P * WINDOW)
        res = JRunner(jt, s).run(idle_timeout=1.0)
        out = {"admitted": [(p["window"], p["admitted"])
                            for p in res["passes"]],
               "passes": log,
               "stores": [union_store(st) for st in jt.table.stores]}
        jt.close()
    finally:
        for k, v in old.items():
            jflags.set_flag(k, v)
        patch.undo()
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def clusters(request, data, tmp_path_factory):
    import jax
    P = request.param
    files, pfeed = data
    root = tmp_path_factory.mktemp("torch_stream_sharded_P%d" % P)
    spec = {"fn": _stream_rank, "feed": pfeed, "files": files,
            "root": str(root / "port"),
            "params0": {k: np.asarray(v) for k, v in jax_model(
                "deepfm").init(jax.random.PRNGKey(0)).items()},
            "seeds": jax_shard_seeds(0, MAX_STEPS, P)}
    ranks, want = run_cluster(
        P, spec, root, meanwhile=lambda: jax_stream(files, pfeed, P,
                                                    str(root / "jax")))
    return P, ranks, want


def test_stream_equals_sequential_preloaded_passes(clusters):
    _, ranks, _ = clusters
    for res in ranks:
        got, seq = res["stream"], res["sequential"]
        assert got["admitted"] == [(0, True), (1, True), (2, False),
                                   (3, True)]
        assert got["passes"] == seq["passes"] and len(seq["passes"]) == 3
        admitted = [b for b in got["bounds"] if b[1]]
        for (_, _, (gk, gv)), (sk, sv) in zip(admitted, seq["stores"]):
            np.testing.assert_array_equal(gk, sk)
            assert_bits(gv, sv)


def test_refused_window_leaves_every_store_as_it_was(clusters):
    _, ranks, _ = clusters
    for res in ranks:
        bounds = res["stream"]["bounds"]
        (w1, ok1, (k1, v1)), (w2, ok2, (k2, v2)) = bounds[1], bounds[2]
        assert (w1, ok1, w2, ok2) == (1, True, 2, False)
        np.testing.assert_array_equal(k1, k2)
        assert_bits(v1, v2)
        assert 999999 not in set(k2.tolist())


def test_stream_matches_the_jax_stream(clusters):
    P, ranks, want = clusters
    assert want["admitted"] == [(0, True), (1, True), (2, False), (3, True)]
    for r, res in enumerate(ranks):
        got = res["stream"]
        assert got["admitted"] == want["admitted"]
        for (gl, ga, gb), (wl, wa, wb) in zip(got["passes"],
                                              want["passes"]):
            assert gb == wb
            np.testing.assert_allclose(gl, wl, rtol=1e-4)
            assert abs(ga - wa) <= 1e-4, (ga, wa)
        assert_store(got["store"], want["stores"][r])


def _disagree_rank(rank, world, port, spec):
    """A spawned rank whose admission gate refuses window 1 on rank 0
    only: its run must raise, within the group's timeout."""
    import time
    fl = join(rank, world, port, timeout=DISAGREE_TIMEOUT_S)
    root = os.path.join(spec["root"], "rank%d" % rank)
    windows = rank_windows(spec["files"], world, rank,
                           os.path.join(root, "src"))
    drop([windows[0], windows[1], windows[3]], os.path.join(root, "watch"))
    t = rank_trainer(spec, fl, rank)
    s = StreamingDataset(spec["feed"], os.path.join(root, "watch"),
                         ledger_dir=root, micro_pass_instances=WINDOW,
                         dataset_kwargs=NO_SHUFFLE, flags=FLAGS)
    runner = StreamingRunner(t, s, flags=FLAGS)
    admit = runner._admit
    runner._admit = lambda win: (admit(win) and not (rank == 0
                                                     and win.index == 1))
    t0 = time.monotonic()
    try:
        runner.run(idle_timeout=1.0)
        out = {"raised": None}
    except Exception as e:   # the collective's timeout or a lost peer
        out = {"raised": type(e).__name__}
    out["secs"] = time.monotonic() - t0
    try:
        t.close()
        fl.stop()
    except Exception:        # the group is already broken
        pass
    return out


def test_disagreeing_ranks_fail_within_the_timeout(data, tmp_path):
    """Rank 0 refuses a window rank 1 admits: rank 1's feed-pass
    all_gather pairs with rank 0's next window, the ranks fall out of step
    in their collectives, and a rank's run raises within the process
    group's timeout instead of stalling."""
    files, pfeed = data
    import jax
    spec = {"fn": _disagree_rank, "feed": pfeed, "files": files,
            "root": str(tmp_path / "port"),
            "params0": {k: np.asarray(v) for k, v in jax_model(
                "deepfm").init(jax.random.PRNGKey(0)).items()},
            "seeds": jax_shard_seeds(0, MAX_STEPS, 2)}
    ranks = run_cluster(2, spec, tmp_path)
    assert any(r["raised"] is not None for r in ranks), ranks
    for r in ranks:
        assert r["secs"] < 6 * DISAGREE_TIMEOUT_S, ranks
