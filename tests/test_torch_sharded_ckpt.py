"""The sharded trainer's checkpoint plane against the JAX package's and the
single-device trainer's.

At P = 2 (a gloo cluster, tests/sharded_cluster.py): each rank's
ShardedPassTable.save writes its shard's rows at {prefix}.shard{s:03d},
the rows of the JAX table's shard s (the integer columns bit-equal, the
float columns rtol 1e-4 / atol 1e-6); a fresh port cluster loads those
files, and the JAX-written ones, bit for bit and trains on; store_view
and run_day raise the reference's TypeError (a job above world 1 is
multi-process in the port and checkpoints per owned shard).

At world 1, in process over gloo: run_day over a ShardedBoxTrainer, its
CheckpointManager driving the table's store_view (the owned shard's
store: at world 1 every key is that shard's), equals the single-device
BoxTrainer's run_day bit for bit (the sparse base, each delta view, the
base view, dense.pkl), preloaded and sequential; a JAX single-process
sharded base loads through the port's store_view.
"""

import os

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch.config.configs import CheckpointConfig, TrainerConfig
from paddlebox_tpu_torch.config.flags import CkptFlags
from paddlebox_tpu_torch.embedding import ckpt_store
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.parallel.sharded_table import ShardedPassTable
from paddlebox_tpu_torch.parallel.sharded_trainer import ShardedBoxTrainer
from paddlebox_tpu_torch.serving.store import read_xbox_view
from paddlebox_tpu_torch.train import checkpoint as pckpt
from paddlebox_tpu_torch.train.trainer import BoxTrainer
from sharded_cluster import (D, HIDDEN, INT_COLS, LR, NUM_SLOTS, assert_bits,
                             assert_store, cluster_spec, flat_leaves,
                             jax_feed, jax_reference, jax_table_cfg,
                             port_dataset, run_cluster, table_cfg,
                             use_jax_pallas, world_one, write_data)

P = 2
# the reference's text (checkpoint.py:537-540, sharded_table.py:1164-1167)
STORE_VIEW_ERR = "multi-process jobs checkpoint per owned shard via table.save"
RUN_DAY_ERR = "multi-process jobs checkpoint per owned shard (table.save)"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_data(tmp_path_factory.mktemp("torch_sharded_ckpt"),
                      lines=96)


def sorted_rows(blob):
    keys = np.asarray(blob["keys"], np.uint64)
    order = np.argsort(keys)
    return keys[order], np.asarray(blob["values"], np.float32)[order]


@pytest.fixture(scope="module")
def ckpt_cluster(data, tmp_path_factory):
    """The JAX run saving its shards, then one cluster: two passes saving
    each rank's shard (and the refusals), a fresh trainer loading those
    files and training a pass, one loading the JAX files and training a
    pass."""
    files, pfeed = data
    root = tmp_path_factory.mktemp("torch_sharded_ckpt_cluster")
    prefix = {k: str(root / k / "table") for k in ("jax", "port")}
    for p in prefix.values():
        os.makedirs(os.path.dirname(p))
    with pytest.MonkeyPatch.context() as mp:
        from paddlebox_tpu.config import flags as jflags
        old = {k: jflags.get_flag(k)
               for k in ("use_pallas_push", "dataset_disable_shuffle")}
        use_jax_pallas(mp)
        try:
            ref = jax_reference(files, pfeed, P, save=prefix["jax"])
        finally:
            for k, v in old.items():
                jflags.set_flag(k, v)
    os.makedirs(root / "ranks")
    runs = [{"save": prefix["port"], "refusals": True},
            {"load": prefix["port"], "passes": 1},
            {"load": prefix["jax"], "passes": 1}]
    got = run_cluster(P, cluster_spec(pfeed, files, P, {"deepfm": ref},
                                      runs, sum(p[2] for p in ref["passes"])),
                      root / "ranks")
    return ref, got, prefix


def test_rank_saves_write_the_jax_shards_rows(ckpt_cluster):
    ref, got, prefix = ckpt_cluster
    for s in range(P):
        saved = sorted_rows(ckpt_store.load_sparse_any(
            "%s.shard%03d" % (prefix["port"], s)))
        np.testing.assert_array_equal(saved[0], got[s][0]["store"][0])
        assert_bits(saved[1], got[s][0]["store"][1])
        assert_store(saved, ref["stores"][s])
        # the JAX files: the same format, read by the port's reader
        jsaved = sorted_rows(ckpt_store.load_sparse_any(
            "%s.shard%03d" % (prefix["jax"], s)))
        np.testing.assert_array_equal(jsaved[0], ref["stores"][s][0])
        assert_bits(jsaved[1], ref["stores"][s][1])


def test_a_fresh_cluster_loads_the_shard_files_and_trains_on(ckpt_cluster):
    """The loaded store is the saved one bit for bit (the port's files
    and the JAX package's); a pass on it updates every row it touches
    (shows grow) and creates no row twice."""
    ref, got, _ = ckpt_cluster
    for s in range(P):
        for run, want in ((1, got[s][0]["store"]), (2, ref["stores"][s])):
            res = got[s][run]
            (lk, lv) = res["loaded"]
            np.testing.assert_array_equal(lk, want[0])
            assert_bits(lv, want[1])
            (loss, auc, batches), = res["passes"]
            assert np.isfinite(loss) and 0.0 < auc < 1.0 and batches == 12
            k, v = res["store"]
            assert np.isin(lk, k).all() and np.unique(k).size == k.size
            shows = v[np.searchsorted(k, lk), INT_COLS[1]]
            assert (shows >= lv[:, INT_COLS[1]]).all()
            assert (shows > lv[:, INT_COLS[1]]).any()


def test_store_view_and_run_day_refuse_above_world_one(ckpt_cluster):
    _, got, _ = ckpt_cluster
    for s in range(P):
        msgs = got[s][0]["refusals"]
        assert STORE_VIEW_ERR in msgs["store_view"]
        assert STORE_VIEW_ERR in msgs["store"]
        assert RUN_DAY_ERR in msgs["run_day"]


# ------------------------------------------------------ world one, in process

SEEDS = [int(x) for x in np.random.RandomState(2).randint(0, 2**31 - 1, 96)]


def day_trainers(pfeed, fl):
    torch.manual_seed(4)
    spec = ModelSpec(num_slots=NUM_SLOTS, slot_dim=3 + D)
    state = DeepFM(spec, hidden=HIDDEN).state_dict()
    models = []
    for _ in range(2):
        m = DeepFM(spec, hidden=HIDDEN)
        m.load_state_dict(state)
        models.append(m)
    cfg = TrainerConfig(dense_lr=LR, scan_chunk=4)
    single = BoxTrainer(models[0], table_cfg(), pfeed, cfg, seed=0,
                        device="cpu")
    sharded = ShardedBoxTrainer(models[1], table_cfg(), pfeed, cfg, seed=0,
                                fleet=fl, device="cpu")
    for t in (single, sharded):
        t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
        t.seed_fn = iter(SEEDS).__next__
    return single, sharded


@pytest.mark.parametrize("preload", [True, False])
def test_world_one_run_day_equals_the_single_device_day(preload, data,
                                                         tmp_path):
    """run_day over three windows with a delta save after each pass: the
    sharded trainer at world 1 writes the single-device day bit for bit
    (sparse base, delta views, base view, dense.pkl), and its table's
    residency drops at every stat rewrite as the single table's does, so
    each later pass promotes the same rows."""
    files, pfeed = data
    windows = [files[0:2], files[2:4], files[4:6]]
    fl = world_one()
    try:
        single, sharded = day_trainers(pfeed, fl)
        out = {}
        for name, t in (("single", single), ("sharded", sharded)):
            root = tmp_path / name
            cm = pckpt.CheckpointManager(
                CheckpointConfig(batch_model_dir=str(root / "batch"),
                                 xbox_model_dir=str(root / "xbox")),
                t.table, CkptFlags())
            if name == "sharded":
                assert cm.store is t.table.shard.store
            dss = []
            for w in windows:
                ds = port_dataset(pfeed, w)
                ds.set_filelist(w)
                dss.append(ds)
            stats, dirs = pckpt.run_day(t, dss, cm, "d0", preload=preload)
            out[name] = (root, stats, dirs, dict(t.table.counters))
        (sroot, sstats, sdirs, scount) = out["sharded"]
        (broot, bstats, bdirs, bcount) = out["single"]
        assert [s["loss"] for s in sstats] == [s["loss"] for s in bstats]
        assert scount == bcount
        for got, want in ((sdirs[0], bdirs[0]),):
            gk, gv = sorted_rows(pckpt.read_batch_sparse(got))
            wk, wv = sorted_rows(pckpt.read_batch_sparse(want))
            np.testing.assert_array_equal(gk, wk)
            assert_bits(gv, wv)
        for view in ("d0/delta-1", "d0/delta-2", "d0/delta-3", "d0"):
            gk, gv = read_xbox_view(str(sroot / "xbox" / view))
            wk, wv = read_xbox_view(str(broot / "xbox" / view))
            np.testing.assert_array_equal(gk, wk)
            assert_bits(gv, wv)
        dense = {}
        for name, d in (("sharded", sdirs[0]), ("single", bdirs[0])):
            with open(os.path.join(d, "dense.pkl"), "rb") as fh:
                dense[name] = ckpt_store.safe_load(fh)
        for part in ("params", "opt_state"):
            g = flat_leaves(dense["sharded"][part])
            w = flat_leaves(dense["single"][part])
            assert set(g) == set(w)
            for k, v in w.items():
                assert_bits(np.asarray(g[k], np.float32),
                            np.asarray(v, np.float32))
    finally:
        single.close()
        fl.stop()


def test_jax_sharded_base_loads_through_the_store_view(data, tmp_path,
                                                       monkeypatch):
    """A base saved by the JAX single-process ShardedBoxTrainer (two
    shards on two virtual devices, its CheckpointManager over the
    reference's store_view) loads through the port's store_view at
    world 1, the owned shard's store: every row bit for bit, the tier
    empty; the view's write_back and state_items round trip."""
    from paddlebox_tpu.config.configs import CheckpointConfig as JCkptCfg
    from paddlebox_tpu.config.configs import TrainerConfig as JTC
    from paddlebox_tpu.data.dataset import BoxDataset as JDataset
    from paddlebox_tpu.models.base import ModelSpec as JSpec
    from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
    from paddlebox_tpu.parallel.mesh import device_mesh_1d
    from paddlebox_tpu.parallel.sharded_trainer import \
        ShardedBoxTrainer as JSharded
    from paddlebox_tpu.train import checkpoint as jckpt
    files, pfeed = data
    use_jax_pallas(monkeypatch)
    jfeed = jax_feed(pfeed)
    jt = JSharded(JDeepFM(JSpec(num_slots=NUM_SLOTS, slot_dim=3 + D),
                          hidden=HIDDEN), jax_table_cfg(), jfeed,
                  JTC(dense_lr=LR, scan_chunk=1), mesh=device_mesh_1d(2),
                  seed=0)
    ds = JDataset(jfeed, read_threads=1)
    ds.set_filelist(files[:4])
    jt.train_pass(ds)
    # the base is the snapshot before the save's stat rewrite
    want = sorted_rows({
        "keys": np.concatenate([st.state_items()[0]
                                for st in jt.table.stores]),
        "values": np.vstack([st.state_items()[1]
                             for st in jt.table.stores])})
    jcm = jckpt.CheckpointManager(
        JCkptCfg(batch_model_dir=str(tmp_path / "batch"),
                 xbox_model_dir=str(tmp_path / "xbox")), jt.table)
    batch_dir, _ = jcm.save_base(jt.params, jt.opt_state, "d0")
    jcm.wait()
    jt.close()
    table = ShardedPassTable(table_cfg(), 1, 64, device="cpu")
    view = table.store_view()
    assert view is table.shard.store and table.store is view
    view.load(os.path.join(batch_dir, pckpt.SPARSE_MANIFEST))
    got = sorted_rows(dict(zip(("keys", "values"), view.state_items())))
    np.testing.assert_array_equal(got[0], want[0])
    assert_bits(got[1], want[1])
    assert not table.shard.store.spilled_count()
    # write_back through the view lands every row in its shard's store
    keys, vals = view.state_items()
    view.write_back(keys, vals * 2)
    k2, v2 = sorted_rows(dict(zip(("keys", "values"), view.state_items())))
    assert_bits(v2, want[1] * 2)
