"""The port's train step and train_pass against the JAX BoxTrainer.

Same synthetic files, same carried DeepFM weights and the same per-step
creation seeds go through both packages on the CPU. The JAX reference runs
with ``use_pallas_push`` (the Pallas adagrad kernel, interpreted on the
CPU), whose semantics the port follows. Tolerances:

  * integer-valued slab columns (slot, show, click, unseen_days, mf_size)
    and freshly created embedx: exact — they are sums of small integers or
    a pure integer hash;
  * loss, preds and dense params after one step: rtol 1e-5 — float32
    matmuls and reductions taken in another order by XLA and ATen;
  * per-pass loss rtol 1e-4 and AUC 1e-4 absolute after two passes, where
    those last-bit differences have fed back through the embeddings.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.config import flags as jflags
from paddlebox_tpu.config.configs import (SparseOptimizerConfig as JSparse,
                                          TableConfig as JTable,
                                          TrainerConfig as JTrainerCfg)
from paddlebox_tpu.data.dataset import BoxDataset as JDataset
from paddlebox_tpu.data.generator import write_synthetic_ctr_files
from paddlebox_tpu.models.base import ModelSpec as JSpec
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.train.trainer import BoxTrainer as JTrainer

from paddlebox_tpu_torch.config.configs import (DataFeedConfig, SlotConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.config.flags import PushFlags
from paddlebox_tpu_torch.convert import params_from_jax, params_to_numpy
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.device import resolve_device
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.embedding.pass_table import PassTable
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.train import flagship
from paddlebox_tpu_torch.train.trainer import BoxTrainer

D = 8
NUM_SLOTS = 4
BATCH = 32
MAX_LEN = 3
HIDDEN = (16, 8)
CAP = 1024
LR = 5e-3
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
INT_COLS = [acc.SLOT, acc.SHOW, acc.CLICK, acc.UNSEEN_DAYS, acc.MF_SIZE]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_train_data")
    files, feed = write_synthetic_ctr_files(
        str(out), num_files=2, lines_per_file=96, num_slots=NUM_SLOTS,
        vocab_per_slot=60, max_len=MAX_LEN, seed=7)
    jfeed = type(feed)(slots=feed.slots, batch_size=BATCH)
    pfeed = DataFeedConfig(
        slots=tuple(SlotConfig(s.name, s.type, is_used=s.is_used,
                               max_len=s.max_len)
                    for s in feed.slots), batch_size=BATCH)
    return files, jfeed, pfeed


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX trainer with use_pallas_push, its kernel interpreted on the
    CPU (as tests/test_pallas_push.py wires it)."""
    import paddlebox_tpu.embedding.pallas_push as pp
    jflags.set_flag("use_pallas_push", True)
    monkeypatch.setattr(pp, "pallas_apply_push",
                        functools.partial(pp.pallas_apply_push,
                                          interpret=True))


def _jax_trainer(jfeed, seed=0):
    table = JTable(embedx_dim=D, pass_capacity=CAP, optimizer=JSparse(**OPT))
    model = JDeepFM(JSpec(num_slots=NUM_SLOTS, slot_dim=3 + D), hidden=HIDDEN)
    return JTrainer(model, table, jfeed, JTrainerCfg(dense_lr=LR), seed=seed)


def _port_trainer(pfeed, jparams, push_write="scatter", seed=0):
    table = TableConfig(embedx_dim=D, pass_capacity=CAP,
                        optimizer=SparseOptimizerConfig(**OPT))
    model = DeepFM(ModelSpec(num_slots=NUM_SLOTS, slot_dim=3 + D),
                   hidden=HIDDEN)
    model.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}))
    return BoxTrainer(model, table, pfeed, TrainerConfig(dense_lr=LR),
                      seed=seed, flags=PushFlags(push_write, 64),
                      device="cpu")


def _jax_step_seed(prng):
    """The seed the JAX step hands the Pallas kernel (trainer.py:725,
    optimizers.py:238), and the carried key."""
    prng, sub = jax.random.split(prng)
    return int(jax.random.randint(sub, (), 0, jnp.int32(2**31 - 1))), prng


def _jax_pass_seeds(table_key, n_steps):
    """(seeds of one train_pass, next table key): next_prng, then one split
    per step."""
    table_key, prng = jax.random.split(table_key)
    seeds = []
    for _ in range(n_steps):
        s, prng = _jax_step_seed(prng)
        seeds.append(s)
    return seeds, table_key


def _assert_rows(got, want, rtol):
    np.testing.assert_array_equal(got[:, INT_COLS], want[:, INT_COLS])
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7)


def test_one_step_matches_jax(data, pallas_interpret):
    files, jfeed, pfeed = data
    jt = _jax_trainer(jfeed)
    pt = _port_trainer(pfeed, jt.params)
    jds = JDataset(jfeed, read_threads=1, columnar=False)
    pds = BoxDataset(pfeed)
    jds.set_filelist(files[:1])
    pds.set_filelist(files[:1])
    for t, ds in ((jt, jds), (pt, pds)):
        t.table.begin_feed_pass()
        ds.load_into_memory(add_keys_fn=t.table.add_keys)
        t.table.end_feed_pass()
        t.table.begin_pass()
    jb = jds.split_batches(1)[0]
    pb = pds.split_batches(1)[0]
    prng = jax.random.PRNGKey(3)
    n = pt.table.pass_size
    # step 1 creates every touched key's embedx; step 2 updates them
    for step in range(2):
        seed, prng_next = _jax_step_seed(prng)
        batch = jt.device_batch(jb[step], jt.table.lookup_ids(jb[step].keys,
                                                              jb[step].valid))
        slab, jt.params, jt.opt_state, jloss, jpreds, _ = jt.fns.step(
            jt.table.slab, jt.params, jt.opt_state, batch, prng)
        jt.table.set_slab(slab)
        prng = prng_next
        pt.seed_fn = lambda s=seed: s
        ploss, ppreds = pt.train_batch(pb[step])
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(ppreds.numpy(),
                                   np.asarray(jpreds["ctr"]), rtol=1e-5,
                                   atol=1e-7)
        pparams = params_to_numpy(pt.model)
        for k, v in jt.params.items():
            np.testing.assert_allclose(pparams[k], np.asarray(v), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        jslab = np.asarray(jt.table.slab)[:n]
        pslab = pt.table.slab.numpy()[:n]
        if step == 0:
            # created embedx comes from the integer hash alone: exact
            xw = pt.table.layout.embedx_w
            created = pslab[:, acc.MF_SIZE] == D
            assert created.any()
            np.testing.assert_array_equal(pslab[created, xw:xw + D],
                                          jslab[created, xw:xw + D])
        _assert_rows(pslab, jslab, rtol=1e-5)


def _run_two_passes(trainer, dataset, seeds_per_pass=None):
    out = []
    for p in range(2):
        if seeds_per_pass is not None:
            trainer.seed_fn = iter(seeds_per_pass[p]).__next__
        res = trainer.train_pass(dataset)
        out.append((res["loss"], trainer.metrics.get_metric_msg("auc")["auc"]))
    return out


def test_two_passes_match_jax(data, pallas_interpret):
    files, jfeed, pfeed = data
    jt = _jax_trainer(jfeed, seed=0)
    pt = _port_trainer(pfeed, jt.params, seed=0)
    jds = JDataset(jfeed, read_threads=1, columnar=False)
    pds = BoxDataset(pfeed)
    for t, ds in ((jt, jds), (pt, pds)):
        t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
        ds.set_filelist(files)
    n_steps = (2 * 96 + BATCH - 1) // BATCH
    key = jax.random.PRNGKey(0)
    seeds = []
    for _ in range(2):
        s, key = _jax_pass_seeds(key, n_steps)
        seeds.append(s)
    want = _run_two_passes(jt, jds)
    got = _run_two_passes(pt, pds, seeds)
    # both trainers shuffled with RandomState(seed + 1) draws: the last
    # pass's batches (the records' shuffled order) are the same
    for a, b in zip(jds.split_batches(1)[0], pds.split_batches(1)[0],
                    strict=True):
        for f in ("keys", "segments", "valid", "labels", "ins_valid"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for (gl, ga), (wl, wa) in zip(got, want):
        np.testing.assert_allclose(gl, wl, rtol=1e-4)
        assert abs(ga - wa) <= 1e-4, (ga, wa)
    assert 0.0 < got[-1][1] <= 1.0
    keys = pt.table.pass_keys
    _assert_rows(pt.table.store.lookup(keys), jt.table.store.lookup(keys),
                 rtol=1e-4)


def test_blocked_matches_scatter_bitwise(data):
    files, _, pfeed = data
    jparams = _jax_trainer(data[1]).params
    rows = {}
    for mode in ("scatter", "blocked"):
        t = _port_trainer(pfeed, jparams, push_write=mode)
        ds = BoxDataset(pfeed)
        ds.set_filelist(files)
        for _ in range(2):
            t.train_pass(ds)
        rows[mode] = t.table.store.lookup(t.table.pass_keys)
    np.testing.assert_array_equal(rows["blocked"].view(np.uint32),
                                  rows["scatter"].view(np.uint32))


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """With no GPU, an entry point called without device= raises rather
    than quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    table = TableConfig(embedx_dim=D, pass_capacity=CAP)
    feed = DataFeedConfig(slots=(SlotConfig("s0"),), batch_size=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PassTable(table)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BoxTrainer(DeepFM(ModelSpec(1, 3 + D), hidden=(4,)), table, feed)
    assert resolve_device("cpu").type == "cpu"


def test_flagship_builder_trains_a_small_replace(tmp_path):
    """train/flagship.py, which chip_smoke.py and profile_pass.py both
    build from, at a narrow replace of FLAGSHIP on the CPU: the files, feed
    and trainer follow the configuration, and a pass trains."""
    cfg = dataclasses.replace(
        flagship.FLAGSHIP, num_slots=NUM_SLOTS, batch=BATCH, max_len=MAX_LEN,
        hidden=HIDDEN, capacity=CAP, num_files=1, lines_per_file=80,
        vocab_per_slot=60, data_seed=7)
    files, feed = flagship.write_files(str(tmp_path), cfg)
    assert len(files) == 1 and feed.batch_size == BATCH
    assert len(feed.used_sparse_slots()) == NUM_SLOTS
    trainer, ds = flagship.build_trainer(files, feed, cfg, "blocked", "cpu")
    assert trainer.push_write == "blocked"
    assert trainer.table.capacity == CAP
    res = trainer.train_pass(ds)
    assert res["batches"] == 3 and res["instances"] == 80
    assert np.isfinite(res["loss"])
    assert 0.0 <= trainer.metrics.get_metric_msg("auc")["auc"] <= 1.0
    assert list(trainer.pass_times) == ["feed", "build", "steps", "end"]
