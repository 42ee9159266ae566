"""The journal under the trainers, against the JAX package, and the port's
RecoverableRunner.

The same synthetic files go through the JAX trainer (use_pallas_push, its
kernel interpreted, ckpt_journal on, the push seeds drawn as it draws
them) and the port's on the CPU, through run_day and through each
package's RecoverableRunner. Tolerances, as in tests/test_torch_day.py:

  * the journal's records: the same kinds and events in the same order,
    the same keys in each ROWS record, exactly; their rows rtol 1e-4 with
    the integer columns exact (float32 sums taken in another order by XLA
    and ATen); loss rtol 1e-4;
  * both journal the SSD tier's day tick (EV_TICK_SPILL_AGE) at
    end_day(age=False); the port, without a tier, replays it as a no-op;
  * the port alone: a resumed runner equals an uninterrupted one, each
    per-pass snapshot loads to the store its save saw, and the journal
    changes no training result, bit for bit.
"""

import functools
import os
import pickle
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.config import flags as jflags
from paddlebox_tpu.config.configs import (CheckpointConfig as JCkptCfg,
                                          SparseOptimizerConfig as JSparse,
                                          TableConfig as JTable,
                                          TrainerConfig as JTrainerCfg)
from paddlebox_tpu.data.dataset import BoxDataset as JDataset
from paddlebox_tpu.data.generator import write_synthetic_ctr_files
from paddlebox_tpu.models.base import ModelSpec as JSpec
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.train import checkpoint as jckpt
from paddlebox_tpu.train.recovery import (RecoverableRunner as
                                          JRecoverableRunner)
from paddlebox_tpu.train.trainer import BoxTrainer as JTrainer

from paddlebox_tpu_torch.config.configs import (CheckpointConfig,
                                                DataFeedConfig, SlotConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.config.flags import CkptFlags, PushFlags
from paddlebox_tpu_torch.convert import (adam_state_from_optax,
                                         params_from_jax)
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.embedding import ckpt_store as cks
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.train import checkpoint as pckpt
from paddlebox_tpu_torch.train.recovery import RecoverableRunner
from paddlebox_tpu_torch.train.trainer import BoxTrainer
from paddlebox_tpu_torch.utils import journal_format as jf

D = 4
CAP = 1 << 10
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
INT_COLS = [acc.SLOT, acc.SHOW, acc.CLICK, acc.UNSEEN_DAYS, acc.MF_SIZE]
HIDDEN = (16, 8)
LR = 5e-3
DAY_TABLE = dict(delete_threshold=1.2)
STEPS = (2 * 64 + 31) // 32


def sorted_items(store):
    keys, rows = store.state_items()
    order = np.argsort(keys)
    return keys[order], rows[order]


def assert_stores_equal(a, b):
    (ka, va), (kb, vb) = a, b
    np.testing.assert_array_equal(ka, kb)
    assert va.shape == vb.shape
    np.testing.assert_array_equal(np.ascontiguousarray(va).view(np.uint32),
                                  np.ascontiguousarray(vb).view(np.uint32))


def assert_rows_close(got, want, rtol=1e-4):
    np.testing.assert_array_equal(got[:, INT_COLS], want[:, INT_COLS])
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Six files; three passes over [0, 1], [2, 3], [4, 5]."""
    out = tmp_path_factory.mktemp("torch_recovery_data")
    files, feed = write_synthetic_ctr_files(
        str(out), num_files=6, lines_per_file=64, num_slots=4,
        vocab_per_slot=50, max_len=3, seed=23)
    jfeed = type(feed)(slots=feed.slots, batch_size=32)
    pfeed = DataFeedConfig(
        slots=tuple(SlotConfig(s.name, s.type, s.is_used, s.max_len)
                    for s in feed.slots), batch_size=32)
    return [files[2 * p:2 * p + 2] for p in range(3)], jfeed, pfeed


@pytest.fixture
def jax_journal_flags(monkeypatch):
    """The JAX trainer with use_pallas_push (its kernel interpreted on the
    CPU) and the journal on."""
    import paddlebox_tpu.embedding.pallas_push as pp
    jflags.set_flag("use_pallas_push", True)
    jflags.set_flag("ckpt_journal", True)
    monkeypatch.setattr(pp, "pallas_apply_push",
                        functools.partial(pp.pallas_apply_push,
                                          interpret=True))


def _jax_seeds(key, n_steps):
    """(one train_pass's per-step push seeds, the next table key), as the
    JAX trainer draws them (trainer.py:725, optimizers.py:238)."""
    key, prng = jax.random.split(key)
    seeds = []
    for _ in range(n_steps):
        prng, sub = jax.random.split(prng)
        seeds.append(int(jax.random.randint(sub, (), 0,
                                            jnp.int32(2**31 - 1))))
    return seeds, key


def _trainers(jfeed, pfeed):
    """A JAX trainer and a port trainer from the same weights, the port's
    push seeds those the JAX trainer draws over three passes."""
    jt = JTrainer(JDeepFM(JSpec(num_slots=4, slot_dim=3 + D),
                          hidden=HIDDEN),
                  JTable(embedx_dim=D, pass_capacity=CAP,
                         optimizer=JSparse(**OPT), **DAY_TABLE),
                  jfeed, JTrainerCfg(dense_lr=LR), seed=0)
    model = DeepFM(ModelSpec(num_slots=4, slot_dim=3 + D), hidden=HIDDEN)
    model.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in jt.params.items()}))
    pt = BoxTrainer(model, _table_cfg(), pfeed, TrainerConfig(dense_lr=LR),
                    seed=0, flags=PushFlags("scatter", 64), device="cpu")
    key = jax.random.PRNGKey(0)
    seeds = []
    for _ in range(3):
        s, key = _jax_seeds(key, STEPS)
        seeds += s
    pt.seed_fn = iter(seeds).__next__
    for t in (jt, pt):
        t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    return jt, pt


def _table_cfg():
    return TableConfig(embedx_dim=D, pass_capacity=CAP,
                       optimizer=SparseOptimizerConfig(**OPT), **DAY_TABLE)


def _datasets(windows, jfeed=None, pfeed=None):
    out = []
    for files in windows:
        if jfeed is not None:
            d = JDataset(jfeed, read_threads=1, columnar=True)
        else:
            d = BoxDataset(pfeed)
        d.set_filelist(files)
        out.append(d)
    return out


def _spy(journal):
    """Record every (kind, payload) the journal appends, in order."""
    seen = []
    real = journal._append_locked

    def spy(kind, payload):
        seen.append((kind, payload))
        real(kind, payload)

    journal._append_locked = spy
    return seen


def _assert_records_match(port, ref):
    """The port's records against the reference's, the SSD tier's day tick
    included."""
    tick = (jf.KIND_EVENT, struct.pack("<I", jf.EV_TICK_SPILL_AGE))
    assert (tick in port) == (tick in ref)
    assert [k for k, _ in port] == [k for k, _ in ref]
    assert jf.KIND_ROWS in [k for k, _ in port]
    for (kind, pp), (_, jp) in zip(port, ref):
        if kind == jf.KIND_ROWS:
            pk, pv = jf.decode_rows_payload(pp)
            jk, jv = jf.decode_rows_payload(jp)
            np.testing.assert_array_equal(pk, jk)
            assert_rows_close(pv, jv)
        else:
            assert pp == jp


def _segment_records(batch_dir):
    doc = cks.read_manifest(os.path.join(batch_dir, "sparse.xman"))
    assert doc["mode"] == "journal"
    return [r for n in doc["segments"]
            for r in jf.iter_segment(os.path.join(batch_dir, n))
            if r[0] != jf.KIND_HEADER]


def test_run_day_journal_matches_jax(data, jax_journal_flags, tmp_path):
    windows, jfeed, pfeed = data
    jt, pt = _trainers(jfeed, pfeed)
    jcm = jckpt.CheckpointManager(
        JCkptCfg(batch_model_dir=str(tmp_path / "j" / "batch"),
                 xbox_model_dir=str(tmp_path / "j" / "xbox")), jt.table)
    pcm = pckpt.CheckpointManager(
        CheckpointConfig(batch_model_dir=str(tmp_path / "p" / "batch"),
                         xbox_model_dir=str(tmp_path / "p" / "xbox")),
        pt.table)
    assert jcm.journal is not None and pcm.journal is not None
    jseen, pseen = _spy(jcm.journal), _spy(pcm.journal)
    jstats, _ = jckpt.run_day(jt, _datasets(windows, jfeed=jfeed), jcm,
                              "d0")
    pstats, _ = pckpt.run_day(pt, _datasets(windows, pfeed=pfeed), pcm,
                              "d0")
    for p, j in zip(pstats, jstats):
        np.testing.assert_allclose(p["loss"], j["loss"], rtol=1e-4)
    _assert_records_match(pseen, jseen)
    # three passes of a full build and a write-back (each delta save drops
    # the residency), every save's events, end_day(age=False)'s tier tick,
    # the shrink
    events = [struct.unpack("<I", p)[0] for k, p in pseen
              if k == jf.KIND_EVENT]
    assert [k for k, _ in pseen].count(jf.KIND_ROWS) == 6
    assert events == [jf.EV_STAT_SAVE_DELTA] * 3 + [
        jf.EV_STAT_SAVE_DELTA, jf.EV_STAT_SAVE_AGE, jf.EV_TICK_SPILL_AGE,
        jf.EV_SHRINK]


def test_runner_journal_matches_jax(data, jax_journal_flags, tmp_path):
    """Both packages' RecoverableRunner over three passes: pass-0 a full
    base, pass-1 and pass-2 journal-mode snapshots; the same records as
    they are appended and in pass-2's snapshot; losses within tolerance;
    the reference's pass-2 snapshot loads through the port to the
    reference's own store, bit for bit."""
    windows, jfeed, pfeed = data
    jt, pt = _trainers(jfeed, pfeed)
    jflags.set_flag("flatten_dense_opt", False)
    roots = {k: str(tmp_path / k) for k in ("j", "p")}
    jcm = jckpt.CheckpointManager(
        JCkptCfg(batch_model_dir=roots["j"] + "/batch",
                 xbox_model_dir=roots["j"] + "/xbox"), jt.table)
    pcm = pckpt.CheckpointManager(
        CheckpointConfig(batch_model_dir=roots["p"] + "/batch",
                         xbox_model_dir=roots["p"] + "/xbox"), pt.table)
    jseen, pseen = _spy(jcm.journal), _spy(pcm.journal)
    jstats = JRecoverableRunner(jt, jcm, "day", keep_last=3).run(
        _datasets(windows, jfeed=jfeed))
    pstats = RecoverableRunner(pt, pcm, "day", keep_last=3).run(
        _datasets(windows, pfeed=pfeed))
    for p, j in zip(pstats, jstats):
        np.testing.assert_allclose(p["loss"], j["loss"], rtol=1e-4)
    _assert_records_match(pseen, jseen)
    modes = []
    for i in range(3):
        d = os.path.join(roots["p"], "batch", "day", "pass-%d" % i)
        modes.append(cks.read_manifest(os.path.join(d, "sparse.xman"))[
            "mode"])
    assert modes == ["full", "journal", "journal"]
    _assert_records_match(
        _segment_records(os.path.join(roots["p"], "batch", "day", "pass-2")),
        _segment_records(os.path.join(roots["j"], "batch", "day",
                                      "pass-2")))
    # the reference runner's pass-2 snapshot loads through the port, its
    # store bit-equal to the reference's own load; its dense.pkl pickles
    # jax arrays and optax states, so it is first rewritten as numpy in
    # the port's names, as a user moving the model would
    jdir = os.path.join(roots["j"], "batch", "day", "pass-2")
    with open(os.path.join(jdir, "dense.pkl"), "rb") as f:
        dense = pickle.load(f)
    params = {k: np.asarray(v) for k, v in dense["params"].items()}
    with open(os.path.join(jdir, "dense.pkl"), "wb") as f:
        pickle.dump({"params": params,
                     "opt_state": adam_state_from_optax(dense["opt_state"],
                                                        params),
                     "extra": {"completed_passes":
                               int(dense["extra"]["completed_passes"])},
                     "flags": dense["flags"]}, f)
    jt2 = JTrainer(JDeepFM(JSpec(num_slots=4, slot_dim=3 + D),
                           hidden=HIDDEN),
                   JTable(embedx_dim=D, pass_capacity=CAP,
                          optimizer=JSparse(**OPT), **DAY_TABLE),
                   jfeed, JTrainerCfg(dense_lr=LR), seed=0)
    jckpt.CheckpointManager(jcm.cfg, jt2.table).load_base("day/pass-2")
    fresh = _port_trainer(pfeed, seed=1)
    _, opt, got_extra = pckpt.CheckpointManager(
        CheckpointConfig(batch_model_dir=roots["j"] + "/batch",
                         xbox_model_dir=roots["j"] + "/xbox"),
        fresh.table, CkptFlags(ckpt_journal=False)).load_base("day/pass-2")
    assert got_extra["completed_passes"] == 3
    fresh.restore_dense(params, opt)
    assert_stores_equal(sorted_items(fresh.table.store),
                        sorted_items(jt2.table.store))


def _port_trainer(pfeed, seed=0):
    t = BoxTrainer(DeepFM(ModelSpec(num_slots=4, slot_dim=3 + D),
                          hidden=HIDDEN,
                          generator=torch.Generator().manual_seed(seed)),
                   _table_cfg(), pfeed, TrainerConfig(dense_lr=LR),
                   seed=seed, device="cpu")
    t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    return t


def _run(root, pfeed, windows, flags=None, keep_last=3, snaps=None):
    """A fresh trainer (seed 0) and runner over ``windows`` at ``root``:
    (trainer, manager, stats with each pass's AUC). ``snaps`` collects the
    store each save_base snapshots."""
    t = _port_trainer(pfeed)
    cm = pckpt.CheckpointManager(
        CheckpointConfig(batch_model_dir=os.path.join(root, "batch"),
                         xbox_model_dir=os.path.join(root, "xbox")),
        t.table, flags)
    real_pass, real_save = t.train_pass, cm.save_base

    def train_pass(ds):
        t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
        res = real_pass(ds)
        return dict(res, auc=t.metrics.get_metric_msg("auc")["auc"])

    def save_base(params, opt_state, day, **kw):
        if snaps is not None:
            snaps[day] = sorted_items(t.table.store)
        return real_save(params, opt_state, day, **kw)

    t.train_pass, cm.save_base = train_pass, save_base
    stats = RecoverableRunner(t, cm, "day", keep_last=keep_last).run(
        _datasets(windows, pfeed=pfeed))
    return t, cm, stats


def test_resumed_runner_equals_uninterrupted(data, tmp_path):
    """Two passes, then a fresh trainer and runner over all three windows:
    it resumes at pass 2, and its loss, AUC and store equal the
    uninterrupted run's bit for bit; each pass's snapshot loads to the
    store its save saw; the journal off changes nothing."""
    windows, _, pfeed = data
    snaps = {}
    ta, cma, sa = _run(str(tmp_path / "a"), pfeed, windows, snaps=snaps)
    assert [cks.read_manifest(os.path.join(
        cma.cfg.batch_model_dir, "day", "pass-%d" % i, "sparse.xman"))[
        "mode"] for i in range(3)] == ["full", "journal", "journal"]
    for i in range(3):
        fresh = _port_trainer(pfeed, seed=1)
        pckpt.CheckpointManager(cma.cfg, fresh.table).load_base(
            "day/pass-%d" % i)
        assert_stores_equal(sorted_items(fresh.table.store),
                            snaps["day/pass-%d" % i])
    _run(str(tmp_path / "i"), pfeed, windows[:2])
    tb, _, sb = _run(str(tmp_path / "i"), pfeed, windows)
    assert len(sb) == 1
    assert (sb[0]["loss"], sb[0]["auc"]) == (sa[2]["loss"], sa[2]["auc"])
    assert_stores_equal(sorted_items(tb.table.store),
                        sorted_items(ta.table.store))
    for name, v in ta.params.items():
        np.testing.assert_array_equal(tb.params[name], v)
    tc, cmc, sc = _run(str(tmp_path / "c"), pfeed, windows,
                       flags=CkptFlags(ckpt_journal=False))
    assert cmc.journal is None
    assert [(s["loss"], s["auc"]) for s in sc] == [
        (s["loss"], s["auc"]) for s in sa]
    assert_stores_equal(sorted_items(tc.table.store),
                        sorted_items(ta.table.store))
    assert cks.read_manifest(os.path.join(
        cmc.cfg.batch_model_dir, "day", "pass-2", "sparse.xman"))[
        "mode"] == "full"


def test_keep_last_prunes_the_anchor_and_later_snapshots_load(data,
                                                              tmp_path):
    """keep_last=1 prunes pass-0 (the full base the journal anchored on)
    and pass-1: pass-2's snapshot, its own links, still loads, and a
    resume from it trains on."""
    windows, _, pfeed = data
    snaps = {}
    t, cm, _ = _run(str(tmp_path / "k"), pfeed, windows[:3], keep_last=1,
                    snaps=snaps)
    day = os.path.join(cm.cfg.batch_model_dir, "day")
    assert sorted(os.listdir(day)) == ["pass-2"]
    fresh = _port_trainer(pfeed, seed=1)
    fcm = pckpt.CheckpointManager(cm.cfg, fresh.table)
    _, _, extra = fcm.load_base("day/pass-2")
    assert extra["completed_passes"] == 3
    assert_stores_equal(sorted_items(fresh.table.store),
                        snaps["day/pass-2"])
    fcm.replay_base_rewrite()
    assert_stores_equal(sorted_items(fresh.table.store),
                        sorted_items(t.table.store))


def test_resume_refuses_another_models_checkpoint(data, tmp_path):
    windows, _, pfeed = data
    _, cm, _ = _run(str(tmp_path / "r"), pfeed, windows[:1])
    other = BoxTrainer(DeepFM(ModelSpec(num_slots=4, slot_dim=3 + D),
                              hidden=(8,)), _table_cfg(), pfeed,
                       device="cpu")
    runner = RecoverableRunner(
        other, pckpt.CheckpointManager(cm.cfg, other.table), "day")
    assert runner.completed_passes() == 1
    with pytest.raises(ValueError, match="dense state"):
        runner.resume()
