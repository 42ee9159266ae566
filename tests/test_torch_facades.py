"""The standalone table pull and push, the AUC runner and the trainer
factory against the JAX package.

The same keys, gradients, files, carried DeepFM weights and replayed push
seeds go through both packages on the CPU (the reference's push through
its Pallas kernel, interpreted, as tests/test_torch_train.py wires it).
Tolerances:

  * PassTable.pull / push on the f32 and bf16 slabs: the pull of the
    freshly built slab bit for bit (a gather); after each of three pushes
    the pulled show and click and the store's integer columns exact, the
    other floats rtol 1e-5 atol 1e-8 (the reference merges an id's
    duplicate occurrences by a scatter-add, the port by a sorted segment
    sum: the same terms in another order; the update and the creation
    hash are the Pallas kernel's in both);
  * AUC runner: base_auc within 1e-4 and each slot's delta within 2e-4
    (a trained pass's last-bit differences, as in tests/test_torch_train.
    py); slots_shuffle's records exact;
  * the Executor's pass and test pass equal the trainer's own bit for bit.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.config import flags as jflags
from paddlebox_tpu.config.configs import (DataFeedConfig as JFeed,
                                          SparseOptimizerConfig as JSparse,
                                          TableConfig as JTable,
                                          TrainerConfig as JTrainerCfg)
from paddlebox_tpu.data.dataset import BoxDataset as JDataset
from paddlebox_tpu.data.generator import write_synthetic_ctr_files
from paddlebox_tpu.embedding.pass_table import PassTable as JPassTable
from paddlebox_tpu.models.base import ModelSpec as JSpec
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.train import auc_runner as jauc_runner
from paddlebox_tpu.train import factory as jfactory
from paddlebox_tpu.train.trainer import BoxTrainer as JTrainer

from paddlebox_tpu_torch.config.configs import (DataFeedConfig, SlotConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.config.flags import HostFlags, PushFlags
from paddlebox_tpu_torch.convert import params_from_jax, params_to_numpy
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.embedding.pass_table import PassTable
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.train import auc_runner, factory
from paddlebox_tpu_torch.train.trainer import BoxTrainer

D = 8
NUM_SLOTS = 4
BATCH = 32
HIDDEN = (16, 8)
CAP = 1024
LR = 5e-3
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
INT_COLS = [acc.SLOT, acc.SHOW, acc.CLICK, acc.UNSEEN_DAYS, acc.MF_SIZE]


@pytest.fixture
def pallas_interpret(monkeypatch):
    import paddlebox_tpu.embedding.pallas_push as pp
    jflags.set_flag("use_pallas_push", True)
    monkeypatch.setattr(pp, "pallas_apply_push",
                        functools.partial(pp.pallas_apply_push,
                                          interpret=True))
    yield
    jflags.set_flag("use_pallas_push", False)


def split_seeds(key, n):
    """n seeds drawn one split of ``key`` each (the reference table's
    push draws), and the next key."""
    seeds = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        seeds.append(int(jax.random.randint(sub, (), 0,
                                            jnp.int32(2**31 - 1))))
    return seeds, key


def push_grads(rng, slots, valid):
    """[K, 4+D] push rows: slot, g_show, g_click, g_embed_w, g_embedx;
    padding rows all zero."""
    K = slots.size
    g = np.zeros((K, 4 + D), np.float32)
    g[:, 0] = slots
    g[:, 1] = 1.0
    g[:, 2] = rng.randint(0, 2, K)
    g[:, 3:] = rng.randn(K, 1 + D).astype(np.float32) * 0.1
    g[~valid] = 0.0
    return g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_table_pull_push_match_the_reference(dtype, pallas_interpret):
    jflags.set_flag("slab_embed_dtype", dtype)
    try:
        jt = JPassTable(JTable(embedx_dim=D, pass_capacity=CAP,
                               optimizer=JSparse(**OPT)), seed=0)
    finally:
        jflags.set_flag("slab_embed_dtype", "float32")
    pt = PassTable(TableConfig(embedx_dim=D, pass_capacity=CAP,
                               optimizer=SparseOptimizerConfig(**OPT)),
                   seed=0, device="cpu", embed_dtype=dtype)
    assert pt.layout.bf16 == (dtype == "bfloat16")
    assert jt.layout.embed_dtype == dtype
    rng = np.random.RandomState(4)
    keys = np.unique(rng.randint(1, 1 << 40, 300).astype(np.uint64))
    for t in (jt, pt):
        with pytest.raises(RuntimeError, match="pull outside pass"):
            t.pull(jnp.zeros(4, jnp.int32) if t is jt
                   else torch.zeros(4, dtype=torch.int32))
        with pytest.raises(RuntimeError, match="push outside pass"):
            t.push(jnp.zeros(4, jnp.int32) if t is jt
                   else torch.zeros(4, dtype=torch.int32),
                   jnp.zeros((4, 4 + D)) if t is jt
                   else torch.zeros(4, 4 + D))
        t.begin_feed_pass()
        t.add_keys(keys)
        t.end_feed_pass()
        t.begin_pass()
    key = jt._prng
    K = 256
    ids = pt.lookup_ids(keys, np.ones(keys.size, bool))
    np.testing.assert_array_equal(pt.pull(torch.from_numpy(ids)).numpy(),
                                  np.asarray(jt.pull(jnp.asarray(ids))))
    for step in range(3):
        bk = keys[rng.randint(0, keys.size // 2, K)]   # duplicates
        valid = np.ones(K, bool)
        valid[-40:] = False                             # padding: trash row
        ids = pt.lookup_ids(bk, valid)
        np.testing.assert_array_equal(ids, jt.lookup_ids(bk, valid))
        assert (ids[~valid] == CAP - 1).all()
        slots = rng.randint(0, NUM_SLOTS, K)
        g = push_grads(rng, slots, valid)
        seeds, key = split_seeds(key, 1)
        pt.seed_fn = iter(seeds).__next__
        jt.push(jnp.asarray(ids), jnp.asarray(g))
        pt.push(torch.from_numpy(ids), torch.from_numpy(g))
        got = pt.pull(torch.from_numpy(ids)).numpy()
        want = np.asarray(jt.pull(jnp.asarray(ids)))
        assert got.shape == (K, 3 + D)
        np.testing.assert_array_equal(got[:, :2], want[:, :2])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-8)
    for t in (jt, pt):
        t.end_pass()
    p_rows, j_rows = pt.store.lookup(keys), jt.store.lookup(keys)
    np.testing.assert_array_equal(p_rows[:, INT_COLS], j_rows[:, INT_COLS])
    np.testing.assert_allclose(p_rows, j_rows, rtol=1e-5, atol=1e-8)
    # a test pass pushes nothing and still pulls
    for t in (jt, pt):
        t.set_test_mode(True)
        t.begin_feed_pass()
        t.add_keys(keys)
        t.end_feed_pass()
        t.begin_pass()
    ids = pt.lookup_ids(keys[:64])
    before = pt.slab.clone()
    pt.push(torch.from_numpy(ids), torch.ones(64, 4 + D))
    jt.push(jnp.asarray(ids), jnp.ones((64, 4 + D)))
    assert torch.equal(pt.slab, before)
    np.testing.assert_allclose(pt.pull(torch.from_numpy(ids)).numpy(),
                               np.asarray(jt.pull(jnp.asarray(ids))),
                               rtol=1e-5, atol=1e-8)
    for t in (jt, pt):
        t.end_pass()
        t.set_test_mode(False)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    out = tmp_path_factory.mktemp("facades")
    files, feed = write_synthetic_ctr_files(
        str(out), num_files=2, lines_per_file=256, num_slots=NUM_SLOTS,
        vocab_per_slot=30, max_len=3, seed=17)
    jfeed = JFeed(slots=feed.slots, batch_size=BATCH)
    pfeed = DataFeedConfig(
        slots=tuple(SlotConfig(s.name, s.type, s.is_used, s.max_len)
                    for s in feed.slots), batch_size=BATCH)
    return files, jfeed, pfeed


def jax_trainer(jfeed):
    t = JTrainer(JDeepFM(JSpec(num_slots=NUM_SLOTS, slot_dim=3 + D),
                         hidden=HIDDEN),
                 JTable(embedx_dim=D, pass_capacity=CAP,
                        optimizer=JSparse(**OPT)),
                 jfeed, JTrainerCfg(dense_lr=LR, scan_chunk=1), seed=0)
    t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    return t


def port_args(pfeed, jparams):
    model = DeepFM(ModelSpec(num_slots=NUM_SLOTS, slot_dim=3 + D),
                   hidden=HIDDEN)
    model.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}))
    return ((model, TableConfig(embedx_dim=D, pass_capacity=CAP,
                                optimizer=SparseOptimizerConfig(**OPT)),
             pfeed, TrainerConfig(dense_lr=LR, scan_chunk=1)),
            dict(seed=0, flags=PushFlags("scatter"), device="cpu"))


def port_trainer(pfeed, jparams, name="BoxPSTrainer"):
    args, kwargs = port_args(pfeed, jparams)
    t = factory.create_trainer(name, *args, **kwargs)
    t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    return t


def recs(ds):
    return [{k: v.tolist() for k, v in sorted(r.uint64_slots.items())}
            for r in ds.records]


def test_slots_shuffle_same_permutation(data):
    files, jfeed, pfeed = data
    ours = BoxDataset(pfeed, columnar=False)
    theirs = JDataset(jfeed, read_threads=1, columnar=False)
    for ds in (ours, theirs):
        ds.set_filelist(files)
        ds.load_into_memory()
    before = recs(ours)
    for ds in (ours, theirs):
        ds.slots_shuffle([1, 3], seed=5)
    assert recs(ours) == recs(theirs)
    after = recs(ours)
    for s in range(NUM_SLOTS):
        col_b = [r.get(s) for r in before]
        col_a = [r.get(s) for r in after]
        if s in (1, 3):
            assert col_a != col_b and sorted(map(str, col_a)) == \
                sorted(map(str, col_b))
        else:
            assert col_a == col_b
    col = BoxDataset(pfeed)
    col.set_filelist(files)
    col.load_into_memory()
    with pytest.raises(RuntimeError, match="record path"):
        col.slots_shuffle([0], seed=1)


def test_auc_runner_matches_the_reference(data, monkeypatch,
                                          pallas_interpret):
    files, jfeed, pfeed = data
    jt = jax_trainer(jfeed)
    pt = port_trainer(pfeed, jt.params)
    _, prng = jax.random.split(jt.table._prng)
    pt.seed_fn = iter(split_seeds(prng, 16)[0]).__next__
    jds = JDataset(jfeed, read_threads=1, columnar=False)
    pds = BoxDataset(pfeed, columnar=False)
    for t, ds in ((jt, jds), (pt, pds)):
        ds.set_filelist(files)
        t.train_pass(ds)
    assert auc_runner.maybe_run_auc_runner(pt, pds) is None
    assert jauc_runner.maybe_run_auc_runner(jt, jds) is None
    monkeypatch.setenv("PBTPU_AUC_RUNNER_MODE", "1")
    jflags.set_flag("auc_runner_mode", True)
    try:
        got = auc_runner.maybe_run_auc_runner(pt, pds, seed=3)
        want = jauc_runner.maybe_run_auc_runner(jt, jds, seed=3)
    finally:
        jflags.set_flag("auc_runner_mode", False)
    assert sorted(got) == sorted(want) == ["base_auc"] + [
        "slot_%d" % i for i in range(NUM_SLOTS)]
    assert abs(got["base_auc"] - want["base_auc"]) <= 1e-4
    for i in range(NUM_SLOTS):
        assert abs(got["slot_%d" % i] - want["slot_%d" % i]) <= 2e-4, i
    assert any(got["slot_%d" % i] != 0.0 for i in range(NUM_SLOTS))
    # the probes restored every slot
    ref = BoxDataset(pfeed, columnar=False)
    ref.set_filelist(files)
    ref.load_into_memory()
    assert sorted(map(str, recs(pds))) == sorted(map(str, recs(ref)))
    monkeypatch.delenv("PBTPU_AUC_RUNNER_MODE")
    assert auc_runner.maybe_run_auc_runner(
        pt, pds, slots=[0], flags=HostFlags(auc_runner_mode=True)) is not None
    for t in (jt, pt):
        t.close()


def test_factory_names_resolve_as_the_reference(data):
    files, jfeed, pfeed = data
    src = open(jfactory.__file__).read()
    builtin = src[src.index("def _builtin"):src.index("def create_trainer")]
    ref_names = set(re.findall(r'"([A-Za-z]+Trainer|HeterCpuWorker)"',
                               builtin))
    assert ref_names == (set(factory.BOX_TRAINERS)
                         | set(factory.SHARDED_TRAINERS)
                         | set(factory.PS_TRAINERS)
                         | set(factory.HETER_TRAINERS)
                         | set(factory.MESH_TOWER_TRAINERS)
                         | set(factory.PIPELINE_TRAINERS)
                         | set(factory.SHARDED_PIPELINE_TRAINERS))
    # no name of the reference's factory is left unported
    assert not hasattr(factory, "A10_TRAINERS")
    assert set(factory.SHARDED_PIPELINE_TRAINERS) == {
        "ShardedCtrPipelineTrainer", "SectionPSTrainer"}
    # the accelerator-side, heter and mesh-tower names resolve in both
    # packages to their counterparts
    from paddlebox_tpu.fleet.heter import HeterTrainer as JHeter
    from paddlebox_tpu.parallel.mesh_tower import MeshTowerTrainer as JTower
    from paddlebox_tpu.parallel.sharded_trainer import \
        ShardedBoxTrainer as JSharded
    from paddlebox_tpu_torch.fleet.heter import HeterTrainer
    from paddlebox_tpu_torch.parallel.mesh_tower import MeshTowerTrainer
    from paddlebox_tpu_torch.parallel.sharded_trainer import \
        ShardedBoxTrainer
    from paddlebox_tpu.parallel.pipeline import CtrPipelineRunner as JCtrPipe
    from paddlebox_tpu.parallel.pipeline import GPipeRunner as JGPipe
    from paddlebox_tpu.parallel.pipeline import \
        ShardedCtrPipelineRunner as JShardedPipe
    from paddlebox_tpu_torch.parallel.pipeline import (
        CtrPipelineRunner, GPipeRunner, ShardedCtrPipelineRunner)
    for name, mine, theirs in (
            ("HeterXpuTrainer", ShardedBoxTrainer, JSharded),
            ("MeshTowerTrainer", MeshTowerTrainer, JTower),
            ("HeterTrainer", HeterTrainer, JHeter),
            ("HeterCpuWorker", HeterTrainer, JHeter),
            ("PipelineTrainer", GPipeRunner, JGPipe),
            ("CtrPipelineTrainer", CtrPipelineRunner, JCtrPipe),
            ("HeterPipelineTrainer", CtrPipelineRunner, JCtrPipe),
            ("ShardedCtrPipelineTrainer", ShardedCtrPipelineRunner,
             JShardedPipe)):
        assert factory._builtin(name) is mine, name
        assert jfactory._builtin(name) is theirs, name
    # the PS trainers resolve: PSGPUTrainer wants its client, as the
    # reference's, and DownpourTrainer is ps/worker.py's
    for mod in (factory, jfactory):
        for name in ("PSGPUTrainer", "SectionPSTrainer"):
            with pytest.raises(ValueError, match="ps_client"):
                mod.create_trainer(name)
    from paddlebox_tpu_torch.ps.worker import DownpourTrainer
    assert factory._builtin("DownpourTrainer") is DownpourTrainer
    for mod in (factory, jfactory):
        with pytest.raises(KeyError, match="unknown trainer"):
            mod.create_trainer("NoSuchTrainer")
    jparams = jax_trainer(jfeed).params
    for name in factory.BOX_TRAINERS:
        t = port_trainer(pfeed, jparams, name)
        assert type(t) is BoxTrainer
        t.close()
    factory.register_trainer("Custom", lambda *a, **k: ("custom", a, k))
    try:
        assert factory.create_trainer("Custom", 1, x=2) == (
            "custom", (1,), {"x": 2})
    finally:
        factory._REGISTRY.pop("Custom")


def test_executor_pass_equals_train_pass(data, caplog):
    files, jfeed, pfeed = data
    jparams = jax_trainer(jfeed).params
    exe = factory.Executor()
    args, kwargs = port_args(pfeed, jparams)
    t = exe.init_for_dataset("MultiTrainer", *args, **kwargs)
    ref = port_trainer(pfeed, jparams)
    t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    out = []
    for tr, run in ((t, lambda ds: exe.train_from_dataset(t, ds,
                                                          debug=True)),
                    (ref, ref.train_pass)):
        ds = BoxDataset(pfeed)
        ds.set_filelist(files)
        res = run(ds)
        preds = (exe.infer_from_dataset(tr, ds) if tr is t
                 else tr.predict_batches(ds))
        out.append((res, tr.metrics.get_metric_msg("auc")["auc"], preds,
                    params_to_numpy(tr.model)))
    (r1, a1, p1, w1), (r2, a2, p2, w2) = out
    assert r1 == r2 and a1 == a2
    for x, y in zip(p1, p2):
        np.testing.assert_array_equal(x, y)
    for k in w1:
        np.testing.assert_array_equal(w1[k], w2[k])
    exe.close()
    assert t.dump_writer is None and t._stage_pool == (0, None)
    ref.close()
