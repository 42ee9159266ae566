"""The port's single-process obs tiers (obs/device.py, obs/flight.py,
obs/watchdog.py, obs/exporter.py, obs/watermark.py, the new ObsFlags and
StreamFlags fields, profile_pass's span annotation) against the JAX
package.

The same registry operations, inputs and passes go through both packages
on the CPU. Tolerances: every counter, gauge, histogram and rendered line
compared is exact; the transfer ledger's write-back bytes equal the
reference's, its full build the reference's less the zero tail the port
does not copy, its staging bytes profile_pass.count_h2d_bytes of the same
pass (the port's leaves differ by wire; the reference's are its own
staging); training with every tier on and with every tier off is bit for
bit the same.
"""

import dataclasses
import functools
import io
import json
import os
import socket
import time
import urllib.request

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
from paddlebox_tpu.obs import device as jdevice
from paddlebox_tpu.obs import exporter as jexporter
from paddlebox_tpu.obs import flight as jflight
from paddlebox_tpu.obs import report as jreport
from paddlebox_tpu.obs import watermark as jwatermark
from paddlebox_tpu.train.trainer import BoxTrainer as JTrainer
from paddlebox_tpu.utils import stats as jstats

from paddlebox_tpu_torch.config.configs import (DataFeedConfig, SlotConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.config.flags import (ObsFlags, PushFlags,
                                              StreamFlags)
from paddlebox_tpu_torch.convert import params_from_jax
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.metrics import drift, quality
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.obs import (device, exporter, flight, report,
                                     tracer, watchdog, watermark)
from paddlebox_tpu_torch.profile_pass import annotated_spans, count_h2d_bytes
from paddlebox_tpu_torch.train.trainer import BoxTrainer
from paddlebox_tpu_torch.utils import stats

NUM_SLOTS = 4
BATCH = 32
D = 8
CAP = 1024
LR = 5e-3
HIDDEN = (16, 8)
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
NEW_OBS_FIELDS = ("obs_watchdog_secs", "obs_watchdog_action",
                  "obs_flight_dir", "obs_flight_segment_bytes",
                  "obs_flight_segments", "obs_http_port", "device_obs",
                  "device_recompile_warmup", "device_donation_min_bytes",
                  "device_leak_windows", "device_leak_min_bytes",
                  "obs_watermark", "freshness_slo_secs",
                  "tier_hit_rate_warn")


@pytest.fixture(autouse=True)
def _clean_planes():
    """Each test starts and ends with empty registries in both packages,
    the device monitors reset, the port's device plane at its defaults and
    no active flight recorder, watchdog, exporter, quality or drift
    object."""
    def clean():
        stats.stat_reset()
        jstats.StatRegistry.instance().reset()
        device.monitor().reset()
        jdevice.monitor().reset()
        device.configure(ObsFlags())
        tracer.configure(True, 4096)
        tracer.set_annotation(None)
        w = watchdog.set_active(None)
        if w is not None:
            w.stop()
        fr = flight.set_active(None)
        if fr is not None:
            fr.close()
        exporter.close_active()
        quality.set_active(None)
        drift.set_active(None)
    clean()
    yield
    clean()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_obs_tiers")
    paths, feed = write_synthetic_ctr_files(
        str(out), num_files=2, lines_per_file=96, num_slots=NUM_SLOTS,
        vocab_per_slot=60, max_len=3, seed=7)
    pfeed = DataFeedConfig(
        slots=tuple(SlotConfig(s.name, s.type, is_used=s.is_used,
                               max_len=s.max_len)
                    for s in feed.slots), batch_size=BATCH)
    return paths, dataclasses.replace(feed, batch_size=BATCH), pfeed


def _port_trainer(pfeed, obs_flags=None, jparams=None, scan_chunk=4):
    torch.manual_seed(0)
    model = DeepFM(ModelSpec(num_slots=NUM_SLOTS, slot_dim=3 + D),
                   hidden=HIDDEN)
    if jparams is not None:
        model.load_state_dict(params_from_jax(
            {k: np.asarray(v) for k, v in jparams.items()}))
    t = BoxTrainer(model, TableConfig(embedx_dim=D, pass_capacity=CAP,
                                      optimizer=SparseOptimizerConfig(**OPT)),
                   pfeed, TrainerConfig(dense_lr=LR, scan_chunk=scan_chunk),
                   seed=0, flags=PushFlags("scatter", 64), device="cpu",
                   obs_flags=obs_flags)
    t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    return t


def _sorted_items(store):
    keys, rows = store.state_items()
    order = np.argsort(keys)
    return keys[order], rows[order]


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


# ------------------------------------------------------------------ flags

def test_new_flags_match_reference_defaults_and_env(monkeypatch):
    """The new ObsFlags fields and StreamFlags have the reference's names
    and defaults; PBTPU_<NAME> overrides them as the reference's registry
    parses it; off() turns every new tier off."""
    for name in NEW_OBS_FIELDS:
        assert getattr(ObsFlags(), name) == jflags.get_flag(name), name
    for f in dataclasses.fields(StreamFlags):
        assert getattr(StreamFlags(), f.name) == jflags.get_flag(f.name)
    monkeypatch.setenv("PBTPU_DEVICE_OBS", "off")
    monkeypatch.setenv("PBTPU_OBS_HTTP_PORT", "9100")
    monkeypatch.setenv("PBTPU_STREAMING_POLL_SECS", "0.05")
    assert ObsFlags().device_obs is False
    assert ObsFlags().obs_http_port == 9100
    assert StreamFlags().streaming_poll_secs == 0.05
    monkeypatch.setenv("PBTPU_STREAMING_BASE_EVERY", "x")
    with pytest.raises(ValueError, match="PBTPU_STREAMING_BASE_EVERY"):
        StreamFlags()
    monkeypatch.delenv("PBTPU_STREAMING_BASE_EVERY")
    off = ObsFlags.off()
    assert not (off.device_obs or off.obs_watermark or off.obs_http_port
                or off.obs_flight_dir or off.obs_watchdog_secs > 0)
    with pytest.raises(ValueError):
        ObsFlags(obs_watchdog_action="kill")


# -------------------------------------------------------------- watermark

def test_watermark_plane_matches_reference():
    """The same freshness samples, tier counters and lag gauges through
    both packages' watermark functions: the same histogram, gauges, burns,
    ladder and snapshot."""
    reg = stats.StatRegistry.instance()
    jreg = jstats.StatRegistry.instance()
    now = 1_000_000.0
    for lag in (0.004, 0.2, 1.5, 7.0, 45.0, 0.0):
        got = watermark.observe_freshness(now - lag, now=now)
        want = jwatermark.observe_freshness(now - lag, now=now)
        assert got == want
    assert watermark.observe_freshness(0.0) is jwatermark.observe_freshness(
        0.0) is None
    assert reg.hist_counts("freshness_e2e_ms") == \
        jreg.hist_counts("freshness_e2e_ms")
    counts = reg.hist_counts("freshness_e2e_ms")
    assert watermark.freshness_burn(counts) == jwatermark.freshness_burn(
        counts)
    assert watermark.freshness_burn([0] * len(counts)) is None
    assert watermark.freshness_burn(counts, slo_secs=0) is None
    for rate in (0.5, 0.05, 0.01, 0.0):
        assert watermark.tier_hit_burn(rate) == jwatermark.tier_hit_burn(
            rate)
    for mod in (stats, jstats):
        mod.stat_add("sparse_keys_resident_hit", 70)
        mod.stat_add("sparse_keys_faulted_in", 20)
        mod.stat_add("sparse_keys_created", 10)
        mod.gauge_set("tier_hit_rate", 0.7)
        mod.gauge_set("streaming_ingest_lag_secs", 1.25)
        mod.gauge_set("streaming_publish_lag_secs", 2.5)
        mod.hist_observe("ssd_promote_us", 300.0)
    assert watermark.tier_ladder() == jwatermark.tier_ladder()
    assert watermark.freshness_snapshot() == jwatermark.freshness_snapshot()
    assert watermark.enabled() and not watermark.enabled(ObsFlags.off())


# ----------------------------------------------------------- device plane

def test_signature_sentinel_counts_past_warmup_as_reference():
    """Signatures (4,), (5,), (6,), (7,), then (4,) again, at warmup 2:
    both planes count 4 new signatures, 2 past the warmup, and warn once;
    host ints ride by type, not value; the entries' fields match."""
    def fn(x, n):
        return x * 2 + n

    p = device.instrument_step(fn, "f", recompile_warmup=2)
    j = jdevice.instrument_jit(lambda x: x * 2 + 1, "f", recompile_warmup=2)
    for n in (4, 5, 6, 7, 4):
        np.testing.assert_array_equal(p(torch.ones(n), n).numpy(),
                                      np.asarray(j(jnp.ones(n))) + n - 1)
    assert stats.stat_get("device_recompiles") == \
        jstats.stat_get("device_recompiles") == 2
    assert stats.stat_get("log_warning_lines") == \
        jstats.stat_get("log_warning_lines") == 1
    got = device.snapshot()["entries"]["f"]
    want = jdevice.snapshot()["entries"]["f"]
    want.pop("analysis")   # the XLA cost analysis: no counterpart
    assert got.keys() == want.keys()
    for k in ("compiles", "signatures", "steady_recompiles",
              "recompile_flagged"):
        assert got[k] == want[k], k
    assert device.instrument_step(fn, "g", flags=ObsFlags.off()) is fn


class _Holder:
    def __init__(self, n):
        self.slab = torch.zeros(n)


def test_donation_audit_debounced_and_floored():
    """A step that hands the table a copy of its slab: the first miss of a
    streak is not counted, the second is; an in-place call breaks the
    streak; a slab under device_donation_min_bytes is not audited."""
    big = _Holder(1 << 15)        # 128 KiB
    small = _Holder(1 << 10)      # 4 KiB

    def step(slab, copy):
        if copy:
            h = big if slab.numel() == big.slab.numel() else small
            h.slab = slab.clone()
        else:
            slab.add_(1.0)

    fb = device.instrument_step(step, "big", slab_of=lambda: big.slab)
    fs = device.instrument_step(step, "small", slab_of=lambda: small.slab)
    for copy in (True, True, False, True, True, True):
        fb(big.slab, copy)
    for _ in range(3):
        fs(small.slab, True)
    snap = device.snapshot()
    b, s = snap["entries"]["big"], snap["entries"]["small"]
    assert b["donation"]["checks"] == 6 and b["donation"]["misses"] == 3
    assert b["donation"]["donated_bytes"] == 4 << 15
    assert s["donation"]["checks"] == 0
    assert snap["donation_miss"] == stats.stat_get("donation_miss") == 3
    assert stats.stat_get("log_warning_lines") == 1


def test_leak_detector_and_owner_ledger_as_reference(files):
    """The same totals through both leak detectors fire at the same
    samples; the port's owners' ledger after a pass: the slab, the dense
    parameters and Adam's state by their tensors' bytes, other 0 on the
    CPU, and the step entry points audited in place."""
    jflags.set_flag("device_leak_windows", 2)
    jflags.set_flag("device_leak_min_bytes", 100)
    device.configure(ObsFlags(device_leak_windows=2,
                              device_leak_min_bytes=100))
    fired = []
    for total in (1000, 1050, 1200, 1300, 1301, 1000, 1100, 1300, 1500):
        a, b = {}, {}
        device.monitor()._leak_check(total, a)
        jdevice.monitor()._leak_check(total, b)
        assert a == b
        fired.append(bool(a))
    assert fired == [False, False, True, False, True, False, False, True,
                     False]
    assert stats.stat_get("device_leak_suspect") == \
        jstats.stat_get("device_leak_suspect") == 3
    device.configure(ObsFlags())
    paths, jfeed, pfeed = files
    t = _port_trainer(pfeed)
    ds = BoxDataset(pfeed)
    ds.set_filelist(paths)
    t.train_pass(ds)
    led = device.sample_ledger()
    width = t.table.layout.device_width
    assert led["owners"]["slab"] == CAP * width * 4
    assert led["owners"]["dense_params"] == sum(
        p.numel() * 4 for p in t.model.parameters())
    assert led["owners"]["opt_state"] == sum(
        v.numel() * v.element_size() for st in t.dense_opt.state.values()
        for v in st.values())
    assert led["owners"]["other"] == 0
    assert led["total_bytes"] == sum(led["owners"].values())
    assert stats.gauge_get("device_live_bytes_slab") == CAP * width * 4
    ent = device.snapshot()["entries"]
    assert ent["scan_steps"]["donation"]["checks"] == 1
    assert ent["train_step"]["donation"]["checks"] == 2
    assert stats.stat_get("donation_miss") == 0
    t.close()


@pytest.fixture
def pallas_interpret(monkeypatch):
    import paddlebox_tpu.embedding.pallas_push as pp
    jflags.set_flag("use_pallas_push", True)
    monkeypatch.setattr(pp, "pallas_apply_push",
                        functools.partial(pp.pallas_apply_push,
                                          interpret=True))


def _jax_seeds(key, n):
    key, prng = jax.random.split(key)
    seeds = []
    for _ in range(n):
        prng, sub = jax.random.split(prng)
        seeds.append(int(jax.random.randint(sub, (), 0,
                                            jnp.int32(2**31 - 1))))
    return seeds, key


def test_transfer_ledger_against_reference(files, pallas_interpret):
    """Two passes of 6 batches (a chunk of 4 and a tail of 2) through the
    JAX trainer and the port. A pass's write-back D2H equals the
    reference's; the port's full build copies the reference's build less
    its zero tail ((capacity - n) rows); the port's staging H2D is
    count_h2d_bytes of the same pass; the promote moves an int32 source
    row a kept key; the counters are the sums of the sites."""
    paths, jfeed, pfeed = files
    jt = JTrainer(JDeepFM(JSpec(num_slots=NUM_SLOTS, slot_dim=3 + D),
                          hidden=HIDDEN),
                  JTable(embedx_dim=D, pass_capacity=CAP,
                         optimizer=JSparse(**OPT)),
                  jfeed, JTrainerCfg(dense_lr=LR, scan_chunk=4), seed=0)
    pt = _port_trainer(pfeed, jparams=jt.params)
    jds = JDataset(jfeed, read_threads=1, columnar=True)
    pds = BoxDataset(pfeed)
    for ds in (jds, pds):
        ds.set_filelist(paths)
    key = jax.random.PRNGKey(0)
    width = pt.table.layout.device_width
    jreg = jstats.StatRegistry.instance()
    for p in range(2):
        device.monitor().reset()
        stats.stat_reset()
        jreg.reset()
        seeds, key = _jax_seeds(key, 6)
        pt.seed_fn = iter(seeds).__next__
        jt.train_pass(jds)
        with count_h2d_bytes(pt) as counted:
            pt.train_pass(pds)
        kinds = device.transfer_kinds()
        n = pt.table._pass_keys.size
        assert stats.stat_get("device_transfer_bytes_d2h") == \
            jstats.stat_get("device_transfer_bytes_d2h") == \
            kinds["d2h"]["writeback"] == n * width * 4
        assert kinds["h2d"]["staging"] == sum(counted.bytes.values())
        assert kinds["h2d"]["writeback_ids"] == n * 4
        if p == 0:
            assert kinds["h2d"]["build"] == n * width * 4 == \
                CAP * width * 4 - (CAP - n) * width * 4
            assert "promote" not in kinds["h2d"]
        else:
            assert "build" not in kinds["h2d"]
            assert kinds["h2d"]["promote"] == n * 4  # every key kept
        assert stats.stat_get("device_transfer_bytes_h2d") == sum(
            kinds["h2d"].values())
        assert sum(stats.StatRegistry.instance().hist_counts(
            "device_h2d_bytes")) > 0
    # the reference's full build of the same first pass: the whole slab
    jreg.reset()
    jt2 = JTrainer(JDeepFM(JSpec(num_slots=NUM_SLOTS, slot_dim=3 + D),
                           hidden=HIDDEN),
                   JTable(embedx_dim=D, pass_capacity=CAP,
                          optimizer=JSparse(**OPT)),
                   jfeed, JTrainerCfg(dense_lr=LR, scan_chunk=4), seed=0)
    jt2.table.begin_feed_pass()
    jds.load_into_memory(add_keys_fn=jt2.table.add_keys)
    jt2.table.end_feed_pass()
    jt2.table.begin_pass()
    assert jstats.stat_get("device_transfer_bytes_h2d") == CAP * width * 4
    jt2.table.end_pass()
    pt.close()
    jt.close()
    jt2.close()


def test_planes_on_equal_planes_off(files, tmp_path):
    """Two passes with every tier on (device plane, flight recorder,
    watchdog, exporter, reports each step) and with ObsFlags.off(): losses,
    AUC, the store and the slab bit for bit."""
    paths, jfeed, pfeed = files
    on = ObsFlags(obs_report_every=1, obs_flight_dir=str(tmp_path / "fl"),
                  obs_watchdog_secs=30.0)
    out = []
    for flags in (on, ObsFlags.off()):
        t = _port_trainer(pfeed, obs_flags=flags)
        if flags is on:
            exporter.set_active(exporter.ObsExporter(0).bind(t.reporter))
            assert watchdog.active() is not None
            assert flight.active() is not None
        ds = BoxDataset(pfeed)
        ds.set_filelist(paths)
        res = []
        for s in (11, 12):
            t.seed_fn = iter(range(s, s + 100)).__next__
            r = t.train_pass(ds)
            res.append((r["loss"], t.metrics.get_metric_msg("auc")["auc"]))
        out.append((res, _sorted_items(t.table.store),
                    t.table.resident_slab.numpy().copy()))
        if flags is on:
            assert stats.stat_get("device_transfer_bytes_h2d") > 0
            assert watchdog.active()._beat[1] == "scan_chunk"
            assert t.reporter.last_report["gauges"]["beat_age_s"] >= 0.0
            segs = flight.active().segments()
            recs = [json.loads(ln) for ln in open(segs[-1])]
            assert {"header", "report", "spans"} <= {r["type"]
                                                     for r in recs}
            exporter.close_active()
            watchdog.set_active(None).stop()
            flight.set_active(None).close()
            stats.stat_reset()
        else:
            assert stats.stat_get("device_transfer_bytes_h2d") == 0
            assert t.step_fn.__class__.__name__ == "function"
        t.close()
    (ra, sa, la), (rb, sb, lb) = out
    assert ra == rb
    np.testing.assert_array_equal(sa[0], sb[0])
    np.testing.assert_array_equal(_bits(sa[1]), _bits(sb[1]))
    np.testing.assert_array_equal(_bits(la), _bits(lb))


# ------------------------------------------------ flight and the watchdog

def test_flight_rotation_and_seal_manifest_as_reference(tmp_path):
    """Segments rotate at the byte bound, at most max_segments stay, each
    opens with a header; log lines and beats are recorded; seal writes the
    manifest with the reference's fields (the device snapshot among them)
    and numbered siblings."""
    fr = flight.FlightRecorder(str(tmp_path / "p"), segment_bytes=4000,
                               max_segments=2, beat_secs=0.0)
    jfr = jflight.FlightRecorder(str(tmp_path / "j"), segment_bytes=4000,
                                 max_segments=2, beat_secs=0.0)
    flight.set_active(fr)
    for i in range(60):
        for r in (fr, jfr):
            r.record("probe", i=i, pad="x" * 100)
    from paddlebox_tpu_torch.obs import log as obs_log
    obs_log.warning("flight probe warning", k=1)
    watchdog.beat("scan_chunk")
    segs = fr.segments()
    assert len(segs) == len(jfr.segments()) == 2
    kept = sorted(os.listdir(str(tmp_path / "p")))
    assert [k for k in kept if k.startswith("flight_")] == \
        [os.path.basename(p) for p in segs]
    assert segs[-1].endswith("_%04d.jsonl" % fr._seg_idx) and \
        fr._seg_idx >= 2
    for p in segs:
        assert json.loads(open(p).readline())["type"] == "header"
    last = [json.loads(ln) for ln in open(segs[-1])]
    assert {"log", "beat"} <= {r["type"] for r in last}
    path = fr.seal("probe", exc=ValueError("boom"))
    jpath = jfr.seal("probe", exc=ValueError("boom"))
    got, want = json.load(open(path)), json.load(open(jpath))
    assert got.keys() == want.keys()
    assert got["header"].keys() == want["header"].keys()
    assert got["device"]["type"] == "device_plane"
    assert "boom" in got["exception"]
    assert os.path.basename(fr.seal("again")) == "SEALED_r0.2.json"
    flight.set_active(None)
    fr.close()
    jfr.close()


def test_watchdog_fires_once_on_a_stall_and_names_the_beat(tmp_path):
    """An injected stall past the threshold: one dump naming the last
    beat, the spans and the last report, the flight recorder sealed with
    it; beats clear the silence window."""
    fr = flight.FlightRecorder(str(tmp_path))
    flight.set_active(fr)
    buf = io.StringIO()
    with tracer.span("probe_span"):
        pass
    w = watchdog.StallWatchdog(0.5, tracer=tracer.get_tracer(),
                               report_fn=lambda: {"step": 7}, stream=buf,
                               poll_interval=0.05)
    watchdog.set_active(w)
    w.start()
    watchdog.beat("scan_chunk")
    time.sleep(1.5)            # the stall
    assert w.fires == 1
    text = buf.getvalue()
    assert "last beat: 'scan_chunk'" in text
    assert "probe_span" in text and '{"step": 7}' in text
    sealed = json.load(open(os.path.join(str(tmp_path), "SEALED_r0.json")))
    assert sealed["reason"] == "watchdog_stall:scan_chunk"
    for _ in range(4):
        watchdog.beat("scan_chunk")
        time.sleep(0.05)
    assert w.fires == 1
    w.stop()
    with pytest.raises(ValueError):
        watchdog.StallWatchdog(1.0, action="kill")


# --------------------------------------------------------------- exporter

def _get(port, path):
    with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                timeout=10) as r:
        return r.headers.get("Content-Type"), r.read().decode()


def test_exporter_endpoints_and_schemas_as_reference(files, tmp_path):
    """Both endpoints bound on port 0 after a pass and a micro-pass:
    /metrics renders the port's registry as the reference's renderer does
    (the streaming, watermark and device series under the reference's
    names); /device, /report, /health, /quality and /flight answer with
    the reference's fields; an unbindable port warns and disables."""
    from paddlebox_tpu_torch.data.streaming import StreamingDataset
    from paddlebox_tpu_torch.train.streaming_runner import StreamingRunner
    paths, jfeed, pfeed = files
    t = _port_trainer(pfeed)
    watch = str(tmp_path / "watch")
    os.makedirs(watch)
    for i, p in enumerate(paths):
        os.link(p, os.path.join(watch, "drop-%d.txt" % i))
    sf = StreamFlags(streaming_poll_secs=0.02)
    s = StreamingDataset(pfeed, watch, ledger_dir=str(tmp_path),
                         micro_pass_instances=192, flags=sf)
    assert StreamingRunner(t, s, flags=sf).run(
        idle_timeout=0.5)["admitted"] == 1
    watermark.observe_freshness(time.time() - 2.0)
    exp = exporter.ObsExporter(0).bind(t.reporter)
    exporter.set_active(exp)
    jexp = jexporter.ObsExporter(0)
    jrep = jreport.StepReporter(every=1, sink=jreport.ListSink())
    jrep.note_examples(3)
    jrep.maybe_report(1, force=True)
    jexp.bind(reporter=jrep)
    j = jdevice.instrument_jit(lambda x: x + 1, "train_step",
                               donate_argnums=(0,))
    j(jnp.ones(3))
    jdevice.register_owner("slab", lambda: jnp.ones(4))
    jdevice.sample_ledger()
    try:
        ctype, text = _get(exp.port, "/metrics")
        assert ctype == exporter.PROM_CONTENT_TYPE == \
            jexporter.PROM_CONTENT_TYPE
        for name in ("pbtpu_streaming_micro_passes",
                     "pbtpu_streaming_ingest_lag_secs",
                     "pbtpu_streaming_examples_per_sec",
                     "pbtpu_streaming_window_instances",
                     "pbtpu_freshness_e2e_secs_p99",
                     'pbtpu_freshness_e2e_ms_bucket{le="4096"}',
                     "pbtpu_device_transfer_bytes_h2d",
                     "pbtpu_device_transfer_bytes_d2h",
                     'pbtpu_device_h2d_bytes_bucket{le="+Inf"}',
                     "pbtpu_device_live_bytes_slab",
                     "pbtpu_device_live_bytes_dense_params",
                     "pbtpu_quality_auc{tag=", "pbtpu_data_drift_score"):
            assert ("\n" + name) in text, name
        snap = stats.StatRegistry.instance().snapshot_all()
        q, dm = quality.active().report(), drift.active().snapshot()
        body = lambda txt: txt.split("\n", 1)[1]  # noqa: E731 (no ts line)
        assert body(exporter.render_prometheus(snap, 0, q, dm)) == body(
            jexporter.render_prometheus(snap, 0, q, dm))
        for path in ("/device", "/report", "/health", "/quality", "/flight",
                     "/"):
            got = json.loads(_get(exp.port, path)[1])
            want = json.loads(_get(jexp.port, path)[1])
            assert got.keys() == want.keys(), path
            if path == "/device":
                ge, we = got["entries"]["train_step"], \
                    want["entries"]["train_step"]
                we.pop("analysis")
                assert ge.keys() == we.keys()
                assert got["transfers"].keys() == want["transfers"].keys()
                assert got["ledger"].keys() == want["ledger"].keys()
                assert got["ledger"]["owners"]["slab"] == \
                    CAP * t.table.layout.device_width * 4
            if path == "/report":
                assert got["report"].keys() - {"event", "window",
                                               "admitted", "instances",
                                               "drift_score"} == \
                    want["report"].keys()
                assert got["report"]["event"] == "micro_pass"
            if path == "/health":
                assert got["last_report_step"] == t._step_count
        assert "== MainThread/" in _get(exp.port, "/stacks")[1]
    finally:
        jexp.close()
        t.close()
    held = socket.socket()
    held.bind(("127.0.0.1", 0))
    held.listen(1)
    try:
        port = held.getsockname()[1]
        assert exporter.ensure_from_flags(flags=ObsFlags(obs_http_port=port)) \
            is None
        assert stats.stat_get("log_warning_lines") >= 1
    finally:
        held.close()


def test_profile_annotation_lands_spans_in_the_profiler(files):
    """profile_pass's annotated_spans: the trainer's spans open
    torch.profiler.record_function ranges of their names (the CPU
    profiler sees them), and the annotation is off afterwards."""
    from torch.profiler import ProfilerActivity, profile
    paths, jfeed, pfeed = files
    t = _port_trainer(pfeed)
    ds = BoxDataset(pfeed)
    ds.set_filelist(paths)
    with annotated_spans(), profile(activities=[ProfilerActivity.CPU]) as pr:
        t.train_pass(ds)
    names = {e.name for e in pr.events()}
    assert {"host_stage", "scan_dispatch", "chunk_drain"} <= names
    assert tracer._ANNOTATE is None
    t.close()
