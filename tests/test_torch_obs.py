"""The port's host planes (utils/stats.py, obs/, metrics/quality.py,
metrics/drift.py, ObsFlags and their wiring into the trainer) against the
JAX package's on the same seeded numpy inputs, on the CPU.

Tolerances:
  * the stat registry, the histogram percentiles, TaggedQuality's report
    and state, SlotDriftMonitor's windows and rolled records (bar the wall
    clock ``ts``), the StepReporter's records over the same registry
    operations, the stores' and the packers' counters: exact (the same
    numpy arithmetic on the same inputs);
  * a two-pass train_pass of the port against the JAX trainer
    (use_pallas_push, its kernel interpreted, on its columnar dataset with
    one reader): the pass_end record's counter deltas exact for every name
    both packages write (the reference's device plane, ROADMAP A14, is
    listed as excluded); the drift windows' key-side fields exact; the
    quality 'all' AUC within 1e-4, its COPC and CTRs within rtol 1e-4 and
    the pred histograms within an L1 of 2 counts, since predictions differ
    at float tolerance across the packages and one on a bucket edge can
    land a bucket over;
  * the port with every plane on against every plane off: losses, AUC and
    the host store bit-identical.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.config import flags as jflags
from paddlebox_tpu.config.configs import (DataFeedConfig as JFeed,
                                          SlotConfig as JSlot,
                                          SparseOptimizerConfig as JSparse,
                                          TableConfig as JTable,
                                          TrainerConfig as JTrainerCfg)
from paddlebox_tpu.data.columnar import ColumnarBlock as JBlock
from paddlebox_tpu.data.columnar import pack_columnar as jax_pack_columnar
from paddlebox_tpu.data.dataset import BoxDataset as JDataset
from paddlebox_tpu.data.native_parser import \
    NativeMultiSlotParser as JNativeParser
from paddlebox_tpu.data.packer import BatchPacker as JPacker
from paddlebox_tpu.data.parser import MultiSlotParser as JParser
from paddlebox_tpu.embedding.accessor import ValueLayout as JLayout
from paddlebox_tpu.embedding.host_store import \
    HostEmbeddingStore as JHostStore
from paddlebox_tpu.embedding.native_store import \
    NativeHostEmbeddingStore as JNativeStore
from paddlebox_tpu.metrics import drift as jdrift
from paddlebox_tpu.metrics import quality as jquality
from paddlebox_tpu.models.base import ModelSpec as JSpec
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.obs import report as jreport
from paddlebox_tpu.obs import tracer as jtracer
from paddlebox_tpu.train.trainer import BoxTrainer as JTrainer
from paddlebox_tpu.utils import stats as jstats

from paddlebox_tpu_torch.config.configs import (CheckpointConfig,
                                                DataFeedConfig, SlotConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.config.flags import CkptFlags, ObsFlags
from paddlebox_tpu_torch.convert import params_from_jax
from paddlebox_tpu_torch.data.columnar import ColumnarBlock, pack_columnar
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.data.generator import write_synthetic_ctr_files
from paddlebox_tpu_torch.data.native_parser import NativeMultiSlotParser
from paddlebox_tpu_torch.data.packer import BatchPacker
from paddlebox_tpu_torch.data.parser import MultiSlotParser
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.embedding.accessor import ValueLayout
from paddlebox_tpu_torch.embedding.host_store import HostEmbeddingStore
from paddlebox_tpu_torch.embedding.native_store import \
    NativeHostEmbeddingStore
from paddlebox_tpu_torch.embedding.pass_table import COUNTERS, PassTable
from paddlebox_tpu_torch.metrics import drift, quality
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.obs import (ListSink, export_chrome_trace,
                                     make_step_reporter, report, tracer)
from paddlebox_tpu_torch.train.checkpoint import CheckpointManager
from paddlebox_tpu_torch.train.preload import run_preloaded_passes
from paddlebox_tpu_torch.train.trainer import BoxTrainer
from paddlebox_tpu_torch.utils import stats
from paddlebox_tpu_torch.utils.timer import Timer

NUM_SLOTS = 4
BATCH = 32
D = 8
CAP = 1024
LR = 5e-3
HIDDEN = (16, 8)
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
T = 4096
# the reference's device plane (obs/device.py: transfer bytes, compiles,
# donation audit, leak detector), which the port's obs/device.py writes
# under the same names where its own sites see the event
DEVICE_PLANE = ("device_transfer_bytes_h2d", "device_transfer_bytes_d2h",
                "device_recompiles", "donation_miss", "device_leak_suspect",
                "device_compiles")
# the transfer counters: the write-back's D2H is the reference's; the H2D
# is the port's own leaves (tests/test_torch_obs_tiers.py holds each site
# against the reference's)
TRANSFER_STATS = ("device_transfer_bytes_h2d", "device_transfer_bytes_d2h")
# gauges of the device plane (the HBM ledger: the port's owners' tensors,
# the reference's jax.live_arrays) and of the depth of the reference's
# parallel reader's channel (ROADMAP A2a)
DEVICE_GAUGES = ("device_", "chan_dataset_blocks_depth")
# the chunk driver's, the tail's, the table's and the ingest spans
TRAINER_SPANS = {"host_stage", "scan_dispatch", "chunk_drain", "pass_begin",
                 "pass_end", "ingest_parse", "ingest_merge",
                 "ingest_shuffle", "ingest_quality"}


@pytest.fixture(autouse=True)
def _port_planes():
    """Each test starts from an empty port registry, the tracer on at its
    default capacity and no active quality or drift object, and leaves
    them so."""
    stats.stat_reset()
    tracer.configure(True, 4096)
    yield
    stats.stat_reset()
    tracer.configure(True, 4096)
    tracer.set_annotation(None)
    quality.set_active(None)
    drift.set_active(None)


@pytest.fixture
def jax_registry():
    """The reference's registry emptied, restored afterwards."""
    reg = jstats.StatRegistry.instance()
    saved = reg.snapshot_all()
    reg.reset()
    yield reg
    reg.reset()
    for k, v in saved["counters"].items():
        reg.set(k, v)
    for k, v in saved["gauges"].items():
        reg.set_gauge(k, v)


def _jax_feed(pfeed):
    return JFeed(slots=tuple(JSlot(s.name, s.type, is_used=s.is_used,
                                   max_len=s.max_len) for s in pfeed.slots),
                 batch_size=pfeed.batch_size)


def _with_max_len(feed, max_len, batch=BATCH):
    return DataFeedConfig(slots=tuple(
        SlotConfig(s.name, s.type, is_used=s.is_used,
                   max_len=max_len if s.type == "uint64" else s.max_len)
        for s in feed.slots), batch_size=batch)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(two small files, feed) of the trainer cases."""
    out = tmp_path_factory.mktemp("torch_obs_data")
    paths, feed = write_synthetic_ctr_files(
        str(out), num_files=2, lines_per_file=96, num_slots=NUM_SLOTS,
        vocab_per_slot=60, max_len=3, seed=7)
    return paths, DataFeedConfig(slots=feed.slots, batch_size=BATCH)


@pytest.fixture(scope="module")
def big_files(tmp_path_factory):
    """(three files of 2,000 lines, more than the drift sample, feed)."""
    out = tmp_path_factory.mktemp("torch_obs_big")
    paths, feed = write_synthetic_ctr_files(
        str(out), num_files=3, lines_per_file=2000, num_slots=NUM_SLOTS,
        vocab_per_slot=500, max_len=3, seed=11)
    return paths, DataFeedConfig(slots=feed.slots, batch_size=BATCH)


# ------------------------------------------------------------ stat registry

@pytest.mark.parametrize("q", [0.0, 0.5, 0.9, 0.99, 1.0])
def test_hist_bounds_and_percentiles_match_reference(q):
    assert tuple(stats.HIST_BOUNDS) == tuple(jstats.HIST_BOUNDS)
    assert stats.new_hist_counts() == jstats.new_hist_counts()
    rng = np.random.RandomState(int(q * 100))
    cases = [rng.randint(0, 50, size=len(stats.HIST_BOUNDS) + 1).tolist(),
             [0] * 26 + [7],                       # overflow bucket only
             [0] * 27, [3] + [0] * 26]
    for counts in cases:
        assert stats.hist_percentile(counts, q) == \
            jstats.hist_percentile(counts, q)


def test_stat_registry_ops_match_reference():
    regs = (stats.StatRegistry(), jstats.StatRegistry())
    for reg in regs:
        r = np.random.RandomState(2)
        for i in range(40):
            reg.add("c%d" % (i % 5), int(r.randint(0, 1000)))
            reg.observe("h%d" % (i % 3), float(r.rand() * 2 ** r.randint(30)))
            reg.set_gauge("g%d" % (i % 4), float(r.rand()))
        reg.set("c0", 5)
        reg.reset("c1")
        reg.reset("h1")
        assert reg.peek("c2") == reg.get("c2")
    a, b = (reg.snapshot_all() for reg in regs)
    assert a == b and regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].hist_counts("h0") == regs[1].hist_counts("h0")


# ------------------------------------------------------------ quality plane

def _data(n, seed):
    rng = np.random.RandomState(seed)
    pred = rng.rand(n)
    label = (rng.rand(n) < pred * 0.4).astype(np.int64)
    return pred, label


def _feed_quality(mod, case):
    """The same adds of ``case`` into a fresh TaggedQuality of ``mod``."""
    q = mod.TaggedQuality(table_size=T)
    pred, label = _data(6000, seed=len(case))
    if case == "add":
        q.add(pred, label)
    elif case == "masked":
        q.add(pred, label, mask=np.arange(6000) % 3 == 0)
        q.add(pred[:10], np.ones(10, np.int64), tag="ones")
    elif case == "tagged":
        q.add_tagged(pred, label, np.arange(6000) % 3, prefix="cmatch:")
        q.add_tagged(pred, label, np.arange(6000) % 2)
    elif case == "add_batch":
        cmatch = (np.arange(6000, dtype=np.uint64) % 3) << np.uint64(32)
        q.add_batch({"pred": pred, "label": label,
                     "mask": np.arange(6000) % 5 != 0,
                     "cmatch_rank": cmatch, "pred_ctcvr": pred[::-1],
                     "label_ctcvr": label})
    elif case == "slot_batch":
        rng = np.random.RandomState(5)
        for _ in range(3):
            seg = np.sort(rng.randint(0, 64 * NUM_SLOTS, size=400))
            q.add_slot_batch(pred[:64], label[:64], seg % NUM_SLOTS, seg,
                             rng.rand(400) < 0.9, NUM_SLOTS)
        q.add(pred[:64], label[:64])
    elif case == "dirty":
        lab = label.copy()
        lab[::7] = 2
        p = pred.copy()
        p[::11] = np.nan
        q.add_batch({"pred": p, "label": lab})
    elif case == "bucket_fold":
        fine = mod.TaggedQuality(table_size=4 * T)
        fine.add(pred, label)
        q.add_bucket_table(fine._tables["all"], *fine._scalars["all"])
    return q


@pytest.mark.parametrize("case", ["add", "masked", "tagged", "add_batch",
                                  "slot_batch", "dirty", "bucket_fold"])
def test_tagged_quality_bit_equal_to_reference(case, jax_registry):
    got = _feed_quality(quality, case)
    want = _feed_quality(jquality, case)
    assert got.report() == want.report()
    assert got.state() == want.state()
    for tag in list(want.report()["tags"]) + ["never_fed"]:
        assert got.compute(tag) == want.compute(tag)
    for t, tab in want._tables.items():
        np.testing.assert_array_equal(got._tables[t], tab)
    assert quality.table_auc(got._tables.get("all", np.zeros((2, 4)))) == \
        jquality.table_auc(want._tables.get("all", np.zeros((2, 4))))
    # the dropped rows are counted under the reference's names
    assert stats.StatRegistry.instance().snapshot() == jax_registry.snapshot()


def test_merged_report_of_two_states_matches_reference():
    pred, label = _data(10000, seed=13)
    seg = np.array([0, 1, 2, 5, 7, 8])
    out = {}
    for name, mod in (("port", quality), ("jax", jquality)):
        whole = mod.TaggedQuality(table_size=T)
        whole.add(pred, label)
        whole.add_slot_batch(pred[:6], label[:6], seg % 3, seg,
                             np.ones(6, bool), 3)
        r0, r1 = (mod.TaggedQuality(table_size=T) for _ in range(2))
        r0.add(pred[:4000], label[:4000])
        r1.add(pred[4000:], label[4000:])
        r0.add_slot_batch(pred[:6], label[:6], seg % 3, seg,
                          np.ones(6, bool), 3)
        states = [json.loads(json.dumps(r.state())) for r in (r0, r1)]
        bad = mod.TaggedQuality(table_size=128)
        bad.add(pred[:100], label[:100])
        merged = mod.merged_report(states + [bad.state(), {}])
        assert merged["tags"]["all"] == whole.report()["tags"]["all"]
        out[name] = (merged, states)
    assert out["port"] == out["jax"]
    assert quality.merged_report([]) is None


def test_quality_range_check_and_gauges(jax_registry):
    q = quality.TaggedQuality(table_size=64)
    with pytest.raises(ValueError):
        q.add(np.array([0.5, 1.5]), np.array([0, 1]))
    for _ in range(2):
        q.add_batch({"pred": np.array([0.5, 1.5]), "label": np.array([0, 1])})
    assert stats.stat_get("quality_batch_skipped") == 2
    assert stats.stat_get("log_warning_lines") == 1   # one warning only
    q.add(np.array([0.25, 0.75]), np.array([0, 1]))
    q.publish_gauges()
    assert stats.gauge_get("quality_auc") == 1.0
    assert stats.gauge_get("quality_copc") == 1.0
    assert quality.make_from_flags(ObsFlags(quality_metrics=False)) is None
    assert quality.active() is None
    made = quality.make_from_flags(ObsFlags(quality_table_size=256))
    assert quality.active() is made and made.table_size == 256


# ---------------------------------------------------------- drift monitor

def _both_blocks(paths, feed):
    """The port's and the reference's merged ColumnarBlock of ``paths``,
    parsed by each package's native parser."""
    pp = NativeMultiSlotParser(feed)
    jp = JNativeParser(_jax_feed(feed))
    return (ColumnarBlock.concat([pp.parse_file_columnar(p) for p in paths]),
            JBlock.concat([jp.parse_file_columnar(p) for p in paths]))


def _assert_windows_equal(got, want):
    assert len(got._ref) == len(want._ref)
    for a, b in zip(got._ref, want._ref):
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("n_files", [1, 3], ids=["whole", "sampled"])
def test_drift_observe_block_bit_equal_to_reference(big_files, n_files,
                                                    jax_registry):
    paths, feed = big_files
    block, jblock = _both_blocks(paths[:n_files], feed)
    assert (block.n_recs > drift.SAMPLE_RECS) == (n_files == 3)
    assert drift.SKETCH_BITS == jdrift.SKETCH_BITS
    assert drift.PRED_BINS == jdrift.PRED_BINS
    assert drift.SAMPLE_RECS == jdrift.SAMPLE_RECS
    keys = np.random.RandomState(1).randint(0, 2**63, 1000, dtype=np.int64)
    np.testing.assert_array_equal(drift._hash_u64(keys.astype(np.uint64)),
                                  jdrift._hash_u64(keys.astype(np.uint64)))
    monitors = (drift.SlotDriftMonitor(drift_warn=0.5),
                jdrift.SlotDriftMonitor(drift_warn=0.5))
    rolls = ([], [])
    rng = np.random.RandomState(4)
    preds = [rng.rand(700) ** (w + 1) for w in range(3)]
    for w in range(3):
        half = block.n_recs // 2
        # a window: two sub-blocks (a window may see several) and preds
        for m, blk, out in zip(monitors, (block, jblock), rolls):
            m.observe_block(blk.select(np.arange(half, dtype=np.int64)
                                       if w == 1 else
                                       np.arange(blk.n_recs)))
            m.observe_preds(preds[w], mask=np.arange(700) % 4 != 0)
            out.append(m.roll())
    for a, b in zip(*rolls):
        assert a.pop("ts") and b.pop("ts")
        assert a == b
    _assert_windows_equal(*monitors)
    assert rolls[0][1]["drift"]["score"] > 0.0
    assert stats.gauge_get("data_drift_score") == \
        jax_registry.get_gauge("data_drift_score")


def _drop_block(mod, drop_slot=None, seed=1, n_recs=300, n_slots=4):
    rng = np.random.RandomState(seed)
    keys, slots, recs = [], [], []
    for i in range(n_recs):
        for s in range(n_slots):
            if s == drop_slot:
                continue
            k = rng.randint(1, 2000, size=2)
            keys.extend(k.tolist())
            slots.extend([s] * 2)
            recs.extend([i] * 2)
    return mod.from_key_rec(
        np.array(keys, np.uint64), np.array(slots, np.int32),
        np.array(recs, np.int64),
        (rng.rand(n_recs) < 0.2).astype(np.int32))


def test_drift_flags_injected_slot_drop_within_one_window(jax_registry):
    out = []
    for mod, blk in ((drift, ColumnarBlock), (jdrift, JBlock)):
        m = mod.SlotDriftMonitor(drift_warn=0.5)
        recs = []
        for seed, drop in ((1, None), (2, None), (3, 2)):
            m.observe_block(_drop_block(blk, drop, seed))
            recs.append(m.roll())
        assert recs[0]["drift"]["score"] == 0.0   # the first window
        assert recs[1]["drift"]["score"] < 0.5
        assert recs[2]["drift"]["score"] >= 0.5
        assert recs[2]["drift"]["dropped_slots"] == [2]
        assert m.roll() is None                   # an empty window
        for r in recs:
            r.pop("ts")
        out.append(recs)
    assert out[0] == out[1]
    assert stats.gauge_get("data_dropped_slots") == 1.0
    assert stats.stat_get("log_warning_lines") == 1   # the drift warning


def test_ingest_hook_feeds_the_active_monitor_only(files):
    paths, feed = files
    ds = BoxDataset(feed)
    ds.set_filelist(paths)
    ds.load_into_memory()                 # no active monitor: nothing fed
    m = drift.make_from_flags(ObsFlags())
    assert drift.active() is m
    ds.load_into_memory()
    assert m._cur.n_recs == len(ds) == 192
    drift.set_active(None)
    ds.load_into_memory()
    assert m._cur.n_recs == 192
    assert drift.make_from_flags(ObsFlags(data_quality=False)) is None
    assert drift.roll_gauges(None) is None

    class Broken:
        def observe_block(self, block):
            raise RuntimeError("monitor fault")

        def roll(self):
            raise RuntimeError("monitor fault")

    drift.set_active(Broken())
    ds.load_into_memory()                 # a fault never fails the load
    assert len(ds) == 192
    assert drift.roll_gauges(Broken()) is None
    assert stats.stat_get("log_warning_lines") == 2


# ----------------------------------------------------------------- tracer

def test_tracer_off_is_a_shared_noop():
    tracer.configure(False, 4096)
    t = tracer.get_tracer()
    t.clear()
    s = tracer.span("x")
    assert s is tracer.span("y") is t.span("z")
    with s:
        pass
    tracer.record_span("w", 0.0, 1.0)
    assert t.all_spans() == []
    tracer.configure(True, 4096)
    with tracer.span("on"):
        pass
    assert [x[0] for x in t.all_spans()] == ["on"]


def test_tracer_ring_wraps_at_capacity_and_annotates():
    tracer.configure(True, 8)
    t = tracer.get_tracer()
    assert t.capacity == 8 and t.all_spans() == []
    for i in range(20):
        tracer.record_span("s%d" % i, float(i), float(i) + 0.5)
    names = [s[0] for s in t.all_spans()]
    assert names == ["s%d" % i for i in range(12, 20)]
    entered = []

    class Ann:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False

    tracer.set_annotation(Ann)
    with tracer.span("annotated"):
        pass
    tracer.set_annotation(None)
    with tracer.span("plain"):
        pass
    assert entered == ["annotated"]
    assert [s[0] for s in t.all_spans()[-2:]] == ["annotated", "plain"]


def test_trace_ids_and_chrome_export_match_reference(tmp_path):
    assert tracer.step_trace_id(3, 77) == jtracer.step_trace_id(3, 77)
    docs = []
    for mod in (tracer, jtracer):
        t = mod.SpanTracer(capacity=16)
        with mod.trace_ctx(mod.step_trace_id(1, 5)):
            with mod.trace_ctx(7):
                t.record_span("inner", mod._EPOCH + 1.0, mod._EPOCH + 1.5)
            assert mod.current_trace() == mod.step_trace_id(1, 5)
            t.record_span("outer", mod._EPOCH + 0.5, mod._EPOCH + 2.0)
        t.record_span("none", mod._EPOCH + 3.0, mod._EPOCH + 3.25)
        assert mod.current_trace() is None
        docs.append(t.export_chrome(pid=2, meta={"run": "x"}))
    got, want = docs
    assert got.keys() == want.keys()
    assert got["metadata"].keys() == want["metadata"].keys()
    assert got["traceEvents"] == want["traceEvents"]
    path = tmp_path / "trace.json"
    doc = export_chrome_trace(str(path))
    assert json.loads(path.read_text()) == doc


# --------------------------------------------------------------- reporter

class _FakeTimer:
    def __init__(self):
        self.ms = 0.0
        self.count = 0

    def elapsed_ms(self):
        return self.ms


@pytest.mark.parametrize("every", [3, 0, -1])
def test_step_reporter_matches_reference(every, jax_registry):
    """The same registry operations, examples, timers and clock through
    both packages' reporters: the same records (bar the wall clock and the
    reference's device-plane gauges)."""
    clocks = [iter(np.arange(0.0, 100.0, 0.25)).__next__ for _ in range(2)]
    timers = {"step": _FakeTimer()}
    sinks = (ListSink(), jreport.ListSink())
    reps = (report.StepReporter(every=every, sink=sinks[0], timers=timers,
                                clock=clocks[0]),
            jreport.StepReporter(every=every, sink=sinks[1], timers=timers,
                                 clock=clocks[1]))
    rng = np.random.RandomState(9)
    for step in range(1, 10):
        adds = rng.randint(0, 100, size=3)
        lat = rng.rand(4) * 2 ** 12
        timers["step"].ms += 1.5
        timers["step"].count += 1
        for st, rep in ((stats, reps[0]), (jstats, reps[1])):
            for i, a in enumerate(adds):
                st.stat_add("c%d" % i, int(a))
            for v in lat:
                st.hist_observe("lat_us", float(v))
            st.gauge_set("depth", float(step))
            rep.note_examples(32)
            rep.maybe_report(step)
            if step == 5:
                rep.maybe_report(step, extra={"event": "pass_end"},
                                 force=True)
    got, want = sinks[0].records, sinks[1].records
    assert len(got) == len(want) == (3 if every == 3 else 0)
    for a, b in zip(got, want):
        a.pop("ts"), b.pop("ts")
        b["gauges"] = {k: v for k, v in b["gauges"].items()
                       if k in a["gauges"]}
        assert a == b
    if got:
        assert [r["step"] for r in got] == [3, 5, 8]
        assert reps[0].last_report == got[-1]
    else:
        assert reps[0].last_report is None


def test_sinks_and_reporter_factory(tmp_path, capsys):
    assert isinstance(report.make_sink(""), report.NullSink)
    assert isinstance(report.make_sink("stderr"), report.StderrSink)
    path = tmp_path / "r.jsonl"
    flags = ObsFlags(obs_report_every=2, obs_report_path=str(path),
                     obs_trace=False, obs_trace_capacity=64)
    t = Timer()
    t.start()
    t.pause()
    rep = make_step_reporter(timers={"step": t}, flags=flags)
    assert not tracer.get_tracer().enabled
    assert tracer.get_tracer().capacity == 64
    assert isinstance(rep.sink, report.JsonlSink)
    stats.stat_add("n", 3)
    rep.maybe_report(2)
    rep.maybe_report(3)
    rep.maybe_report(3, force=True, extra={"event": "pass_end"})
    rep.close()
    rep.close()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["step"] for r in lines] == [2, 3]
    assert lines[0]["stats"] == {"n": 3} and lines[1]["stats"] == {}
    assert lines[0]["timers"]["step"]["calls"] == 1
    report.StderrSink().emit({"a": 1})
    assert json.loads(capsys.readouterr().err) == {"a": 1}


def test_obs_flags_defaults_match_reference():
    import dataclasses
    for f in dataclasses.fields(ObsFlags):
        assert getattr(ObsFlags(), f.name) == jflags.get_flag(f.name), f.name
    off = ObsFlags.off()
    assert not (off.obs_trace or off.quality_metrics or off.data_quality)
    assert off.obs_report_every <= 0
    with pytest.raises(dataclasses.FrozenInstanceError):
        ObsFlags().obs_trace = False


# ------------------------------------------------- stores, packers, saves

@pytest.mark.parametrize("tier", ["native", "python"])
def test_store_counters_match_reference(tier, jax_registry):
    table = TableConfig(embedx_dim=D, pass_capacity=CAP,
                        optimizer=SparseOptimizerConfig(**OPT))
    jtable = JTable(embedx_dim=D, pass_capacity=CAP, optimizer=JSparse(**OPT))
    if tier == "native":
        port = NativeHostEmbeddingStore(ValueLayout(D), table, 3)
        ref = JNativeStore(JLayout(D, "adagrad"), jtable, 3)
    else:
        port = HostEmbeddingStore(ValueLayout(D), table, 3)
        ref = JHostStore(JLayout(D, "adagrad"), jtable, 3)
    for store in (port, ref):
        r = np.random.RandomState(6)
        for _ in range(3):
            keys = np.unique(r.randint(1, 400, size=150).astype(np.uint64))
            store.lookup_or_create(keys)
        keys, vals = store.state_items()
        order = np.argsort(keys)
        keys, vals = keys[order], vals[order]
        vals[1::2, acc.SHOW] = 10.0   # the others (show 0) die at shrink
        store.write_back(keys, vals)
        assert 0 < store.shrink() < keys.size
        store.age_unseen_days()
    assert stats.StatRegistry.instance().snapshot_all() == \
        jax_registry.snapshot_all()


@pytest.mark.parametrize("columnar", [True, False])
def test_packer_counters_match_reference(files, columnar, jax_registry):
    paths, feed = files
    feed = _with_max_len(feed, 1, batch=16)
    jfeed = _jax_feed(feed)
    if columnar:
        block = NativeMultiSlotParser(feed).parse_file_columnar(paths[0])
        jblock = JNativeParser(jfeed).parse_file_columnar(paths[0])
        packer = BatchPacker(feed)
        ml = np.array([s.max_len for s in packer.sparse_slots], np.int64)
        for lo in range(0, 48, 16):
            idx = np.arange(lo, lo + 16, dtype=np.int64)
            pack_columnar(block, idx, feed, 24, NUM_SLOTS, ml)
            jax_pack_columnar(jblock, idx, jfeed, 24, NUM_SLOTS, ml)
    else:
        recs = list(MultiSlotParser(feed).parse_file(paths[0]))[:48]
        jrecs = list(JParser(jfeed).parse_file(paths[0]))[:48]
        for lo in range(0, 48, 16):
            BatchPacker(feed).pack(recs[lo:lo + 16])
            JPacker(jfeed).pack(jrecs[lo:lo + 16])
    got = stats.StatRegistry.instance().snapshot()
    assert got == jax_registry.snapshot()
    assert got["ingest_ins_packed"] == 48 and got["packer_keys_dropped"] > 0


def test_touched_save_fallback_is_counted(tmp_path):
    table = PassTable(TableConfig(embedx_dim=4, pass_capacity=64),
                      device="cpu")
    table.store.lookup_or_create(np.arange(1, 20, dtype=np.uint64))
    cm = CheckpointManager(
        CheckpointConfig(str(tmp_path / "b"), str(tmp_path / "x"),
                         async_save=False),
        table, CkptFlags(ckpt_journal=False))
    cm.save_base({}, {}, "d0", mode="touched")
    assert stats.stat_get("ckpt_touched_fallback_full") == 1


# ---------------------------------------------------------------- trainer

def _port_trainer(pfeed, jparams=None, obs_flags=None, seed=0, chunk=4):
    model = DeepFM(ModelSpec(num_slots=NUM_SLOTS, slot_dim=3 + D),
                   hidden=HIDDEN,
                   generator=torch.Generator().manual_seed(seed))
    if jparams is not None:
        model.load_state_dict(params_from_jax(
            {k: np.asarray(v) for k, v in jparams.items()}))
    t = BoxTrainer(model, TableConfig(embedx_dim=D, pass_capacity=CAP,
                                      optimizer=SparseOptimizerConfig(**OPT)),
                   pfeed, TrainerConfig(dense_lr=LR, scan_chunk=chunk),
                   seed=seed, device="cpu", obs_flags=obs_flags)
    t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    return t


def _jax_seeds(key, n):
    key, prng = jax.random.split(key)
    seeds = []
    for _ in range(n):
        prng, sub = jax.random.split(prng)
        seeds.append(int(jax.random.randint(sub, (), 0,
                                            jnp.int32(2**31 - 1))))
    return seeds, key


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX trainer with use_pallas_push, its kernel interpreted on the
    CPU (as tests/test_torch_train.py wires it)."""
    import paddlebox_tpu.embedding.pallas_push as pp
    jflags.set_flag("use_pallas_push", True)
    monkeypatch.setattr(pp, "pallas_apply_push",
                        functools.partial(pp.pallas_apply_push,
                                          interpret=True))


def _pass_ends(sink):
    return [r for r in sink.records if r.get("event") == "pass_end"]


def test_trainer_pass_end_matches_jax(files, pallas_interpret, jax_registry):
    """Two passes of 6 batches (a chunk of 4 and a tail of 2) through the
    JAX trainer and the port, both with the reference's default planes, on
    columnar datasets with one reader."""
    paths, pfeed = files
    jfeed = _jax_feed(pfeed)
    jt = JTrainer(JDeepFM(JSpec(num_slots=NUM_SLOTS, slot_dim=3 + D),
                          hidden=HIDDEN),
                  JTable(embedx_dim=D, pass_capacity=CAP,
                         optimizer=JSparse(**OPT)),
                  jfeed, JTrainerCfg(dense_lr=LR, scan_chunk=4), seed=0)
    pt = _port_trainer(pfeed, jt.params)
    jt.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    jt.reporter.sink = jreport.ListSink()
    pt.reporter.sink = ListSink()
    assert pt.quality is quality.active() and pt.drift is drift.active()
    jds = JDataset(jfeed, read_threads=1, columnar=True)
    pds = BoxDataset(pfeed)
    for ds in (jds, pds):
        ds.set_filelist(paths)
    key = jax.random.PRNGKey(0)
    # the stats each package wrote before its first pass: JAX's jit
    # compiles and the construction's creations are in its first window
    jax_registry.reset()
    stats.stat_reset()
    for _ in range(2):
        seeds, key = _jax_seeds(key, 6)
        pt.seed_fn = iter(seeds).__next__
        assert jt.train_pass(jds)["batches"] == pt.train_pass(pds)[
            "batches"] == 6
    got, want = _pass_ends(pt.reporter.sink), _pass_ends(jt.reporter.sink)
    assert len(got) == len(want) == 2
    jmon = jdrift.active()
    for p, (g, w) in enumerate(zip(got, want)):
        assert g["step"] == w["step"] == 6 * (p + 1)
        assert g["examples"] == w["examples"] == 6 * BATCH
        only_jax = set(w["stats"]) - set(g["stats"])
        assert only_jax <= set(DEVICE_PLANE), only_jax
        assert set(g["stats"]) <= set(w["stats"])
        assert g["stats"]["device_transfer_bytes_d2h"] == \
            w["stats"]["device_transfer_bytes_d2h"]
        same = {k: v for k, v in g["stats"].items()
                if k not in TRANSFER_STATS}
        assert {k: w["stats"][k] for k in same} == same
        assert set(COUNTERS) & set(g["stats"])
        assert g["timers"].keys() == w["timers"].keys() == {"step", "pass"}
        assert g["timers"]["step"]["calls"] == w["timers"]["step"]["calls"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        assert g["auc"].keys() == w["auc"].keys()
        assert abs(g["auc"]["auc"] - w["auc"]["auc"]) <= 1e-4
        ga, wa = g["quality"]["tags"]["all"], w["quality"]["tags"]["all"]
        assert ga["size"] == wa["size"] == 192 * (p + 1)
        assert abs(ga["auc"] - wa["auc"]) <= 1e-4
        for k in ("copc", "actual_ctr", "predicted_ctr"):
            np.testing.assert_allclose(ga[k], wa[k], rtol=1e-4, err_msg=k)
        gs, ws = g["quality"]["slots"], w["quality"]["slots"]
        assert gs.keys() == ws.keys()
        for s in ws:
            assert gs[s]["n"] == ws[s]["n"]
            assert gs[s]["actual_ctr"] == ws[s]["actual_ctr"]
            np.testing.assert_allclose(gs[s]["predicted_ctr"],
                                       ws[s]["predicted_ctr"], rtol=1e-4)
        gd, wd = g["data_quality"], w["data_quality"]
        for k in ("window", "n_recs", "n_slots", "label_rate"):
            assert gd[k] == wd[k], k
        for k in ("dropped_slots", "worst_slot", "label_drift"):
            assert gd["drift"][k] == wd["drift"][k], k
        assert abs(gd["drift"]["pred_drift"]
                   - wd["drift"]["pred_drift"]) <= 2.0 / 192
        only_jax = set(w["gauges"]) - set(g["gauges"])
        assert all(k.startswith(DEVICE_GAUGES) for k in only_jax), only_jax
        for k, v in g["gauges"].items():
            if k.startswith(DEVICE_GAUGES):
                continue    # the HBM ledger: its owners differ by package
            if k in ("quality_auc", "data_drift_score"):
                assert abs(v - w["gauges"][k]) <= 2.0 / 192, k
            elif k == "quality_copc":
                np.testing.assert_allclose(v, w["gauges"][k], rtol=1e-4)
            else:
                assert v == w["gauges"][k], k
    assert len(pt.drift._ref) == len(jmon._ref) == 2
    for a, b in zip(pt.drift._ref, jmon._ref):
        for k in ("coverage", "keys_per_rec", "cardinality"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["n_recs"] == b["n_recs"] and a["label_rate"] == \
            b["label_rate"]
        # 192 predictions a window: the normalized histograms as counts
        assert np.abs(a["pred_hist"] - b["pred_hist"]).sum() * 192 <= 2.0
    json.dumps(got)
    pt.close()
    jt.close()


def _two_passes(t, ds, seeds=(11, 12)):
    out = []
    for s in seeds:
        t.seed_fn = iter(range(s, s + 100)).__next__
        res = t.train_pass(ds)
        out.append((res["loss"], t.metrics.get_metric_msg("auc")["auc"]))
    keys, rows = t.table.store.state_items()
    order = np.argsort(keys)
    return out, keys[order], rows[order]


def test_planes_on_and_off_train_bit_identically(files):
    paths, pfeed = files
    runs = {}
    for name, flags in (("on", ObsFlags()), ("off", ObsFlags.off())):
        tracer.get_tracer().clear()
        t = _port_trainer(pfeed, obs_flags=flags)
        t.reporter.sink = sink = ListSink()
        ds = BoxDataset(pfeed)
        ds.set_filelist(paths)
        runs[name] = _two_passes(t, ds)
        spans = {s[0] for s in tracer.get_tracer().all_spans()}
        if name == "off":
            assert t.quality is t.drift is None
            assert quality.active() is drift.active() is None
            assert sink.records == [] and spans == set()
        else:
            assert len(_pass_ends(sink)) == 2
            assert TRAINER_SPANS <= spans, TRAINER_SPANS - spans
        t.close()
    (lo, ko, vo), (lf, kf, vf) = runs["on"], runs["off"]
    assert lo == lf
    np.testing.assert_array_equal(ko, kf)
    np.testing.assert_array_equal(vo.view(np.uint32), vf.view(np.uint32))


def test_report_windows_sum_to_the_table_counters(files, tmp_path):
    """A report every 4 steps over two chunked passes of 6 batches: the
    windows' counter deltas add up to the table's counters, the records
    land in the JSONL file, and a second trainer feeds its own monitor."""
    paths, pfeed = files
    path = tmp_path / "reports.jsonl"
    first = _port_trainer(pfeed)
    t = _port_trainer(pfeed, obs_flags=ObsFlags(obs_report_every=4,
                                                obs_report_path=str(path)))
    assert drift.active() is t.drift is not first.drift
    ds = BoxDataset(pfeed)
    ds.set_filelist(paths)
    _two_passes(t, ds)
    t.close()
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["step"] for r in recs] == [4, 6, 10, 12]
    assert [r.get("event") for r in recs].count("pass_end") == 2
    total = {k: sum(r["stats"].get(k, 0) for r in recs) for k in COUNTERS}
    assert total == t.table.counters
    assert sum(r["examples"] for r in recs) == 12 * BATCH
    assert sum(r["timers"]["pass"]["calls"] for r in recs
               if "pass" in r["timers"]) == 2
    assert first.drift._cur.n_recs == 0 and first.drift.windows == 0
    assert t.drift.windows == 2
    first.close()


def test_preloaded_passes_record_the_preload_spans(files):
    paths, pfeed = files
    t = _port_trainer(pfeed)
    t.reporter.sink = sink = ListSink()
    tracer.get_tracer().clear()
    datasets = []
    for _ in range(2):
        ds = BoxDataset(pfeed)
        ds.set_filelist(paths)
        datasets.append(ds)
    run_preloaded_passes(t, datasets)
    spans = {s[0] for s in tracer.get_tracer().all_spans()}
    assert {"ingest_wait_preload", "ingest_feed_pass"} <= spans
    ends = _pass_ends(sink)
    # the next pass's block is merged while this pass trains, so it lands
    # in this pass's window (as in the reference's preload)
    assert [r["data_quality"]["n_recs"] for r in ends] == [384, 0]
    t.close()
