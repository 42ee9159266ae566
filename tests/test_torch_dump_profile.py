"""The trainer's outputs against the JAX package: the dump writer, the
profiled pass, the profiler's reports and trace.

The same files, carried DeepFM weights and replayed push seeds go through
both packages on the CPU (the reference's push through its Pallas kernel,
interpreted, as tests/test_torch_train.py wires it). Tolerances:

  * dump: ins_ids and labels exact; preds rtol 1e-4 after ``%g`` parsing,
    compared by ins_id as sets (writer threads interleave lines); the
    port's dumped pass equals its undumped pass bit for bit (losses, AUC,
    store rows);
  * profiled pass against the reference's: loss rtol 1e-4, AUC 1e-4
    absolute, integer store columns exact, the rest rtol 1e-4 atol 1e-7;
    against the port's own train_pass at scan_chunk=1: bit for bit;
  * timer_report: the reference's text for the same timer values, exact.
"""

import dataclasses
import functools
import json
import os

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
from paddlebox_tpu.models.base import ModelSpec as JSpec
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.train.trainer import BoxTrainer as JTrainer
from paddlebox_tpu.utils import profiler as jprofiler
from paddlebox_tpu.utils.timer import Timer as JTimer

from paddlebox_tpu_torch.config.configs import (DataFeedConfig, SlotConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.config.flags import ObsFlags, PushFlags
from paddlebox_tpu_torch.convert import params_from_jax, params_to_numpy
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.obs import tracer
from paddlebox_tpu_torch.train.trainer import BoxTrainer
from paddlebox_tpu_torch.utils import profiler
from paddlebox_tpu_torch.utils.timer import Timer

D = 8
NUM_SLOTS = 4
BATCH = 32
HIDDEN = (16, 8)
CAP = 1024
LR = 5e-3
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
INT_COLS = [acc.SLOT, acc.SHOW, acc.CLICK, acc.UNSEEN_DAYS, acc.MF_SIZE]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """96 instances in two files, each line led by its ins_id."""
    out = tmp_path_factory.mktemp("dump_profile")
    files, feed = write_synthetic_ctr_files(
        str(out), num_files=2, lines_per_file=48, num_slots=NUM_SLOTS,
        vocab_per_slot=40, max_len=3, seed=13)
    ins_files = []
    for k, f in enumerate(files):
        with open(f) as src:
            lines = src.read().splitlines()
        path = f + ".ins"
        with open(path, "w") as dst:
            dst.write("".join("ins-%d-%d %s\n" % (k, i, line)
                              for i, line in enumerate(lines)))
        ins_files.append(path)
    jfeed = JFeed(slots=feed.slots, batch_size=BATCH)
    pfeed = DataFeedConfig(
        slots=tuple(SlotConfig(s.name, s.type, s.is_used, s.max_len)
                    for s in feed.slots), batch_size=BATCH)
    return files, ins_files, jfeed, pfeed


@pytest.fixture
def pallas_interpret(monkeypatch):
    import paddlebox_tpu.embedding.pallas_push as pp
    jflags.set_flag("use_pallas_push", True)
    monkeypatch.setattr(pp, "pallas_apply_push",
                        functools.partial(pp.pallas_apply_push,
                                          interpret=True))
    yield
    jflags.set_flag("use_pallas_push", False)


def jax_trainer(jfeed, **cfg):
    t = JTrainer(JDeepFM(JSpec(num_slots=NUM_SLOTS, slot_dim=3 + D),
                         hidden=HIDDEN),
                 JTable(embedx_dim=D, pass_capacity=CAP,
                        optimizer=JSparse(**OPT)),
                 jfeed, JTrainerCfg(dense_lr=LR, **cfg), seed=0)
    t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    return t


def port_trainer(pfeed, jparams, host_flags=None, obs_flags=None,
                 metrics=True, **cfg):
    model = DeepFM(ModelSpec(num_slots=NUM_SLOTS, slot_dim=3 + D),
                   hidden=HIDDEN)
    model.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}))
    t = BoxTrainer(model, TableConfig(embedx_dim=D, pass_capacity=CAP,
                                      optimizer=SparseOptimizerConfig(**OPT)),
                   pfeed, TrainerConfig(dense_lr=LR, **cfg), seed=0,
                   flags=PushFlags("scatter"), device="cpu",
                   host_flags=host_flags, obs_flags=obs_flags)
    if metrics:
        t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    return t


def split_seeds(key, n):
    """(n seeds drawn one split of ``key`` each, as the reference's
    next_prng draws them, next key)."""
    seeds = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        seeds.append(int(jax.random.randint(sub, (), 0,
                                            jnp.int32(2**31 - 1))))
    return seeds, key


def train_pass_seeds(table, n):
    """A reference train_pass's seeds: next_prng, then a split a step."""
    _, prng = jax.random.split(table._prng)
    return split_seeds(prng, n)[0]


def store_rows(t):
    return t.table.store.lookup(t.table.pass_keys)


def read_dump(path):
    rows = {}
    names = sorted(os.listdir(path))
    for name in names:
        with open(os.path.join(path, name)) as f:
            for line in f:
                ins, *fields = line.rstrip("\n").split("\t")
                assert ins not in rows
                rows[ins] = {k: v for k, v in (x.split(":") for x in fields)}
    return rows, names


def test_dumped_pass_matches_the_reference(data, tmp_path, monkeypatch,
                                           pallas_interpret):
    """A dumped pass of 3 batches (a chunk of 2 and a tail step) on the
    record path, two writer threads, files rotated at 600 bytes."""
    _, ins_files, jfeed, pfeed = data
    jfeed = dataclasses.replace(jfeed, parse_ins_id=True)
    pfeed = dataclasses.replace(pfeed, parse_ins_id=True)
    monkeypatch.setenv("PBTPU_DUMP_FILE_MAX_BYTES", "600")
    monkeypatch.setattr(jflags._REGISTRY["dump_file_max_bytes"], "value",
                        600)
    dump = dict(dump_fields=("label", "pred"), dump_thread_num=2)
    jt = jax_trainer(jfeed, scan_chunk=2,
                     dump_fields_path=str(tmp_path / "j"), **dump)
    # no metric and no plane reads the port's predictions: the dump
    # writer alone makes the chunk driver copy them
    quiet = dict(obs_flags=ObsFlags.off(), metrics=False, scan_chunk=2)
    pt = port_trainer(pfeed, jt.params,
                      dump_fields_path=str(tmp_path / "p"), **dump, **quiet)
    plain = port_trainer(pfeed, jt.params, **quiet)
    assert pt.dump_writer.max_bytes == 600 and plain.dump_writer is None
    assert pt._preds_consumed() and not plain._preds_consumed()
    seeds = train_pass_seeds(jt.table, 3)
    out = {}
    for name, t in (("jax", jt), ("port", pt), ("plain", plain)):
        if name != "jax":
            t.seed_fn = iter(seeds).__next__
        ds = (JDataset(jfeed, read_threads=1) if name == "jax"
              else BoxDataset(pfeed))
        ds.set_filelist(ins_files)
        out[name] = t.train_pass(ds)["loss"]
    for t in (jt, pt):
        t.close()
    got, got_files = read_dump(str(tmp_path / "p"))
    want, want_files = read_dump(str(tmp_path / "j"))
    assert len(got_files) > 2 and len(want_files) > 2
    assert sorted(got) == sorted(want) and len(got) == 96
    for ins, row in got.items():
        assert row["label"] == want[ins]["label"]
        np.testing.assert_allclose(float(row["pred"]),
                                   float(want[ins]["pred"]), rtol=1e-4)
    np.testing.assert_allclose(out["port"], out["jax"], rtol=1e-4)
    # the dump changes no digit of the pass
    assert out["port"] == out["plain"]
    np.testing.assert_array_equal(store_rows(pt), store_rows(plain))
    for name, p in params_to_numpy(pt.model).items():
        np.testing.assert_array_equal(p, params_to_numpy(plain.model)[name])


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_dump_writer_lines_and_param_dump(tmp_path, pkg):
    """The same calls through either package's writer give the same
    lines in the same rotated files."""
    if pkg == "port":
        from paddlebox_tpu_torch.train import dump
    else:
        from paddlebox_tpu.train import dump
    w = dump.DumpWriter(str(tmp_path), thread_num=1, max_bytes=20)
    t = dump.build_dump_tensors(("label", "pred_ctr", "nope"),
                                np.array([1, 0, 1]),
                                {"ctr": np.array([0.5, 0.25, 0.125])}, "ctr")
    assert sorted(t) == ["label", "pred_ctr"]
    w.dump_batch(t, ins_ids=["a", "b", "c"], mask=np.array([1, 0, 1], bool))
    w.dump_batch({"v": np.array([[1.0, 2.5]])})
    w.dump_param({"w": np.arange(3, dtype=np.float32)}, step=7)
    w.close()
    assert [os.path.basename(f) for f in w.files] == [
        "dump-rank0-t0-%05d.txt" % i for i in range(3)]
    assert [open(f).read() for f in w.files] == [
        "a\tlabel:1\tpred_ctr:0.5\nc\tlabel:1\tpred_ctr:0.125\n",
        "0\tv:1,2.5\n", "param_step:7\nw:0,1,2\n"]


def test_profiled_pass_matches_the_reference_and_train_pass(
        data, pallas_interpret):
    """Two passes of train_pass_profiled against the reference's (replayed
    seeds), and against the port's train_pass at scan_chunk=1."""
    files, _, jfeed, pfeed = data
    jt = jax_trainer(jfeed, scan_chunk=1)
    pt = port_trainer(pfeed, jt.params, scan_chunk=1)
    ref = port_trainer(pfeed, jt.params, scan_chunk=1)
    key = jt.table._prng
    got, want, plain = [], [], []
    for _ in range(2):
        seeds, key = split_seeds(key, 3)
        pt.seed_fn = iter(seeds).__next__
        ref.seed_fn = iter(seeds).__next__
        for t, out, fn in ((jt, want, "train_pass_profiled"),
                           (pt, got, "train_pass_profiled"),
                           (ref, plain, "train_pass")):
            ds = (JDataset(jfeed, read_threads=1, columnar=False)
                  if t is jt else BoxDataset(pfeed))
            ds.set_filelist(files)
            res = getattr(t, fn)(ds)
            assert res["batches"] == 3
            out.append((res["loss"], t.metrics.get_metric_msg("auc")["auc"]))
    assert got == plain
    np.testing.assert_array_equal(store_rows(pt), store_rows(ref))
    assert torch.equal(pt.table.resident_slab, ref.table.resident_slab)
    for name, p in params_to_numpy(pt.model).items():
        np.testing.assert_array_equal(p, params_to_numpy(ref.model)[name])
    for (gl, ga), (wl, wa) in zip(got, want):
        np.testing.assert_allclose(gl, wl, rtol=1e-4)
        assert abs(ga - wa) <= 1e-4
    p_rows, j_rows = store_rows(pt), jt.table.store.lookup(pt.table.pass_keys)
    np.testing.assert_array_equal(p_rows[:, INT_COLS], j_rows[:, INT_COLS])
    np.testing.assert_allclose(p_rows, j_rows, rtol=1e-4, atol=1e-7)
    assert set(pt.stage_timers) == {"host_stage", "pull", "fwd_bwd",
                                    "dense_opt", "push"}
    assert all(t.count == 3 for t in pt.stage_timers.values())
    for t in (jt, pt, ref):
        t.close()


def test_profile_per_op_routes_train_pass(data, monkeypatch):
    files, _, jfeed, pfeed = data
    monkeypatch.setenv("PBTPU_PROFILE_PER_OP", "1")
    t = port_trainer(pfeed, jax_trainer(jfeed).params, profile=True)
    assert t.host_flags.profile_per_op
    ds = BoxDataset(pfeed)
    ds.set_filelist(files)
    assert t.train_pass(ds)["batches"] == 3
    assert t.stage_timers["push"].count == 3
    t.close()


def test_timer_report_and_stats_report_match_the_reference():
    ours, theirs = {}, {}
    for name, secs, n in (("push", 0.25, 4), ("pull", 0.5, 2),
                          ("idle", 0.0, 0)):
        for d, cls in ((ours, Timer), (theirs, JTimer)):
            t = d[name] = cls()
            t._elapsed, t._count = secs, n
    assert profiler.timer_report(ours, "stage.") == \
        jprofiler.timer_report(theirs, "stage.")
    assert "stage.push" in profiler.timer_report(ours, "stage.")
    from paddlebox_tpu_torch.utils.stats import stat_add
    stat_add("profiler_test_counter", 3)
    assert any(line.split() == ["profiler_test_counter", "3"]
               for line in profiler.stats_report().splitlines())


def test_trace_writes_a_chrome_trace_with_the_spans(tmp_path):
    with profiler.trace(str(tmp_path)):
        with tracer.span("profiled_region"):
            torch.ones(8).sum()
        with profiler.annotate("annotated_region"):
            torch.ones(8).sum()
    assert tracer._ANNOTATE is None
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"profiled_region", "annotated_region"} <= names
