"""The port's streaming runner (train/streaming_runner.py, data/streaming.py,
the admission half of metrics/drift.py, the journal's publish) against the
JAX package and against the port's own sequential passes.

Same inputs, made from a seed with numpy, go through both packages on the
CPU (the port's kernels run their plain versions on CPU tensors, the JAX
trainer's Pallas push is interpreted). Tolerances:

  * the drift gate's preview and admit, the watcher's and the socket feed's
    window cuts, the admit/refuse sequence and the drift scores: exact;
  * micro-passes against the JAX StreamingRunner: loss rtol 1e-4, AUC 1e-4
    absolute, store rows rtol 1e-4 with the integer columns exact (float32
    sums taken in another order by XLA and ATen, as in
    tests/test_torch_incremental.py);
  * micro-passes against the port's own train_pass(preloaded=True) one
    window at a time, a refused window against the state before it, the
    published segment against the reference's writer, a micro-checkpoint's
    replay and the reference tailer's overlay against the live store: bit
    for bit.
"""

import dataclasses
import functools
import os
import shutil
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.config import flags as jflags
from paddlebox_tpu.config.configs import (SparseOptimizerConfig as JSparse,
                                          TableConfig as JTable,
                                          TrainerConfig as JTrainerCfg)
from paddlebox_tpu.data.columnar import ColumnarBlock as JBlock
from paddlebox_tpu.data.generator import write_synthetic_ctr_files
from paddlebox_tpu.data.native_parser import \
    NativeMultiSlotParser as JNativeParser
from paddlebox_tpu.data.streaming import DirectoryWatcher as JWatcher
from paddlebox_tpu.data.streaming import FileLedger as JLedger
from paddlebox_tpu.data.streaming import StreamingDataset as JStream
from paddlebox_tpu.embedding.accessor import ValueLayout as JLayout
from paddlebox_tpu.metrics import drift as jdrift
from paddlebox_tpu.models.base import ModelSpec as JSpec
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.serving.refresh import JournalDeltaSource
from paddlebox_tpu.serving.store import MmapViewStack
from paddlebox_tpu.train import journal as jjr
from paddlebox_tpu.train.streaming_runner import \
    StreamingRunner as JRunner
from paddlebox_tpu.train.trainer import BoxTrainer as JTrainer

from paddlebox_tpu_torch.config.configs import (CheckpointConfig,
                                                DataFeedConfig, SlotConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.config.flags import (CkptFlags, PushFlags,
                                              StreamFlags)
from paddlebox_tpu_torch.convert import params_from_jax
from paddlebox_tpu_torch.data import StreamingDataset
from paddlebox_tpu_torch.data.columnar import ColumnarBlock
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.data.native_parser import NativeMultiSlotParser
from paddlebox_tpu_torch.data.streaming import DirectoryWatcher, FileLedger
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.embedding.accessor import ValueLayout
from paddlebox_tpu_torch.metrics import drift
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.train import StreamingRunner
from paddlebox_tpu_torch.train import checkpoint as pckpt
from paddlebox_tpu_torch.train import journal as jr
from paddlebox_tpu_torch.train.preload import PassPreloader
from paddlebox_tpu_torch.train.trainer import BoxTrainer
from paddlebox_tpu_torch.utils import journal_format as jf
from paddlebox_tpu_torch.utils import stats

NUM_SLOTS = 4
D = 8
CAP = 1 << 11
BATCH = 32
LINES = 200          # a file; a window is two files
WINDOW = 2 * LINES
LR = 5e-3
HIDDEN = (16, 8)
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
INT_COLS = [acc.SLOT, acc.SHOW, acc.CLICK, acc.UNSEEN_DAYS, acc.MF_SIZE]
POLL = 0.02
FLAGS = StreamFlags(streaming_poll_secs=POLL)
POISON_SLOT = 2


@pytest.fixture(autouse=True)
def _fast_polls():
    """Both packages poll every 20 ms; the port's registry starts empty;
    no drift monitor stays active."""
    jflags.set_flag("streaming_poll_secs", POLL)
    stats.stat_reset()
    yield
    drift.set_active(None)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(six files of 200 lines, a poisoned file of 400, JAX feed, port
    feed). The poisoned file is the first two files with every id of slot
    2 replaced by one new key (its cardinality collapses to 1)."""
    out = tmp_path_factory.mktemp("torch_streaming")
    files, feed = write_synthetic_ctr_files(
        str(out), num_files=6, lines_per_file=LINES, num_slots=NUM_SLOTS,
        vocab_per_slot=80, max_len=3, seed=13)
    poison = str(out / "poison.txt")
    with open(poison, "w") as fh:
        for f in files[:2]:
            for line in open(f):
                fh.write(_poison_line(line) + "\n")
    jfeed = dataclasses.replace(feed, batch_size=BATCH)
    pfeed = DataFeedConfig(
        slots=tuple(SlotConfig(s.name, s.type, is_used=s.is_used,
                               max_len=s.max_len)
                    for s in feed.slots), batch_size=BATCH)
    return files, poison, jfeed, pfeed


def _poison_line(line: str) -> str:
    """The line with every id of slot POISON_SLOT replaced by 999999."""
    tok = line.split()
    pos = 2   # the click slot: "1 <label>"
    for s in range(NUM_SLOTS):
        n = int(tok[pos])
        if s == POISON_SLOT:
            tok[pos + 1:pos + 1 + n] = ["999999"] * n
        pos += 1 + n
    return " ".join(tok)


def _drop(srcs, watch, names=None, t0=1.7e9):
    """Copy ``srcs`` into ``watch`` by write-temp-then-rename, with mtimes
    one second apart (the watcher orders by mtime, then name)."""
    os.makedirs(watch, exist_ok=True)
    out = []
    for i, f in enumerate(srcs):
        dst = os.path.join(watch, names[i] if names else "drop-%04d.txt" % i)
        shutil.copy(f, dst + ".tmp")
        os.replace(dst + ".tmp", dst)
        os.utime(dst, (t0 + i, t0 + i))
        out.append(dst)
    return out


def _sorted_items(store):
    keys, rows = store.state_items()
    order = np.argsort(keys)
    return keys[order], rows[order]


def _assert_bits(a, b):
    np.testing.assert_array_equal(np.ascontiguousarray(a).view(np.uint32),
                                  np.ascontiguousarray(b).view(np.uint32))


def _table_cfg():
    return TableConfig(embedx_dim=D, pass_capacity=CAP,
                       optimizer=SparseOptimizerConfig(**OPT))


def _port_trainer(pfeed, jparams=None):
    torch.manual_seed(0)   # the same weights in every port trainer
    model = DeepFM(ModelSpec(num_slots=NUM_SLOTS, slot_dim=3 + D),
                   hidden=HIDDEN)
    if jparams is not None:
        model.load_state_dict(params_from_jax(
            {k: np.asarray(v) for k, v in jparams.items()}))
    t = BoxTrainer(model, _table_cfg(), pfeed, TrainerConfig(dense_lr=LR),
                   seed=0, flags=PushFlags("scatter", 64), device="cpu")
    t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    return t


def _recording(trainer, log):
    """Wrap ``trainer.train_pass`` to log (loss, auc) after each pass."""
    inner = trainer.train_pass

    def train_pass(ds, preloaded=False):
        res = inner(ds, preloaded=preloaded)
        log.append((res["loss"],
                    trainer.metrics.get_metric_msg("auc")["auc"]))
        return res
    trainer.train_pass = train_pass
    return trainer


# ------------------------------------------------------------ drift gate

def _blocks(paths, feed, jfeed):
    pp, jp = NativeMultiSlotParser(feed), JNativeParser(jfeed)
    return (ColumnarBlock.concat([pp.parse_file_columnar(p) for p in paths]),
            JBlock.concat([jp.parse_file_columnar(p) for p in paths]))


def test_preview_and_admit_bit_equal_to_reference(data):
    """The gate's sequence (admit, admit, preview of a clean window and of
    the poisoned one, admit) on both packages' blocks of the same files:
    the same scores, reference windows and snapshots; a preview advances
    nothing."""
    files, poison, jfeed, pfeed = data
    mons = (drift.SlotDriftMonitor(), jdrift.SlotDriftMonitor())
    b = [_blocks(fs, pfeed, jfeed) for fs in
         (files[0:2], files[2:4], files[4:6], [poison])]
    assert mons[0].preview_block(b[0][0]) == \
        mons[1].preview_block(b[0][1]) == 0.0   # no reference yet
    for i in (0, 1):
        for m, blk in zip(mons, b[i]):
            m.admit_block(blk)
    scores = []
    for i in (2, 3, 2):
        got, want = (m.preview_block(blk) for m, blk in zip(mons, b[i]))
        assert got == want, (i, got, want)
        scores.append(got)
    assert scores[0] == scores[2] < 0.8 <= scores[1]
    for m, blk in zip(mons, b[2]):
        m.admit_block(blk)
    assert mons[0].windows == mons[1].windows == 3
    assert len(mons[0]._ref) == len(mons[1]._ref) == 3
    for a, w in zip(mons[0]._ref, mons[1]._ref):
        assert a.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(a[k], w[k], err_msg=k)
    got, want = mons[0].snapshot(), mons[1].snapshot()
    assert got.keys() == want.keys()
    assert got["last"]["drift"] == want["last"]["drift"]
    assert got["windows"] == want["windows"]


# --------------------------------------------------- watcher, socket feed

def test_watcher_rules_match_reference(tmp_path):
    """Both watchers polled over one directory through the same writes:
    scratch names never ready, a bare appender only after its size held,
    the rename publishes, a file yielded once, the ledger skips consumed
    files across a restart (and reads the other package's ledger)."""
    watch = tmp_path / "watch"
    watch.mkdir()
    led_p = FileLedger(str(tmp_path / "lp" / "consumed.json"))
    led_j = JLedger(str(tmp_path / "lj" / "consumed.json"))
    ws = (DirectoryWatcher(str(watch), led_p, stable_polls=2),
          JWatcher(str(watch), led_j, stable_polls=2))

    def poll():
        got, want = (w.poll() for w in ws)
        assert got == want
        return got

    (watch / "a.txt.tmp").write_text("1 1 1 5\n")
    (watch / ".hidden.txt").write_text("1 1 1 5\n")
    (watch / "_scratch.txt").write_text("1 1 1 5\n")
    for _ in range(3):
        assert poll() == []
    torn = watch / "b.txt"
    with open(torn, "w") as fh:
        fh.write("1 1 1 5\n")
        fh.flush()
        assert poll() == []
        fh.write("1 0 1 6\n")
        fh.flush()
        assert poll() == []            # the size moved
    assert poll() == [str(torn)]
    assert poll() == []
    os.replace(watch / "a.txt.tmp", watch / "a.txt")
    poll()
    assert poll() == [str(watch / "a.txt")]
    led_p.mark([str(torn)])
    led_j.mark([str(torn)])
    with open(led_p.path) as a, open(led_j.path) as b:
        assert a.read() == b.read()
    again = (DirectoryWatcher(str(watch), FileLedger(led_j.path),
                              stable_polls=2),
             JWatcher(str(watch), JLedger(led_p.path), stable_polls=2))
    for _ in range(2):
        got, want = (w.poll() for w in again)
        assert got == want
    assert got == [str(watch / "a.txt")]


def _windows(stream, n):
    out = []
    for _ in range(n):
        win = stream.next_window(deadline=time.time() + 20)
        assert win is not None
        out.append(([os.path.basename(f) for f in win.files],
                    win.instances))
    return out


def test_window_cuts_and_socket_feed_match_reference(data, tmp_path):
    """Files of 200, 400 (the poisoned one), 200, 200, 200 lines at a bound
    of 400, then lines pushed over each package's socket feed (bound on
    port 0): the same windows (file names, instances), the last one flushed
    partial."""
    files, poison, jfeed, pfeed = data
    srcs = [files[0], poison, files[1], files[2], files[3]]
    cuts = []
    for pkg in ("port", "jax"):
        watch = str(tmp_path / pkg / "watch")
        _drop(srcs, watch)
        if pkg == "port":
            s = StreamingDataset(pfeed, watch, ledger_dir=str(tmp_path / pkg),
                                 micro_pass_instances=WINDOW, socket_port=0,
                                 flush_after=0.3, flags=FLAGS)
        else:
            s = JStream(jfeed, watch, ledger_dir=str(tmp_path / pkg),
                        read_threads=1, micro_pass_instances=WINDOW,
                        socket_port=0, flush_after=0.3)
        try:
            got = _windows(s, 4)
            with open(files[4], "rb") as fh:
                payload = fh.read()
            with socket.create_connection(("127.0.0.1", s.socket_port),
                                          timeout=10) as conn:
                conn.sendall(payload[:-1])   # no final newline
            got += _windows(s, 1)
            win_ds = BoxDataset(pfeed) if pkg == "port" else None
            if win_ds is not None:
                win_ds.set_filelist([os.path.join(watch, got[-1][0][0])])
                win_ds.load_into_memory()
                assert len(win_ds) == LINES
        finally:
            s.stop()
        cuts.append(got)
    assert cuts[0] == cuts[1]
    assert [c[1] for c in cuts[0]] == [200, 400, 400, 200, 200]
    assert cuts[0][-1][0] == ["spool-00000001.txt"]


# ------------------------------------------------- the runner against JAX

@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX trainer with use_pallas_push, its kernel interpreted on the
    CPU (as tests/test_torch_train.py wires it)."""
    import paddlebox_tpu.embedding.pallas_push as pp
    jflags.set_flag("use_pallas_push", True)
    monkeypatch.setattr(pp, "pallas_apply_push",
                        functools.partial(pp.pallas_apply_push,
                                          interpret=True))


def _jax_seeds(key, n_passes, n_steps):
    """The JAX trainer's push seeds of ``n_passes`` passes of ``n_steps``
    steps, in order (trainer.py:725, optimizers.py:238)."""
    seeds = []
    for _ in range(n_passes):
        key, prng = jax.random.split(key)
        for _ in range(n_steps):
            prng, sub = jax.random.split(prng)
            seeds.append(int(jax.random.randint(sub, (), 0,
                                                jnp.int32(2**31 - 1))))
    return seeds


STREAM = ("drop-0000.txt", "drop-0001.txt", "drop-0002.txt",
          "drop-0003.txt", "poison.txt", "drop-0004.txt", "drop-0005.txt")


def _stream_srcs(files, poison):
    return [files[0], files[1], files[2], files[3], poison, files[4],
            files[5]]


def _boundary_spy(runner, trainer, out):
    """Record (admitted, store items, resident slab) at each boundary."""
    inner = runner._boundary

    def boundary(win, admitted):
        slab = trainer.table.resident_slab
        out.append((admitted, _sorted_items(trainer.table.store),
                    None if slab is None else slab.clone()))
        return inner(win, admitted)
    runner._boundary = boundary


def test_stream_matches_jax_runner(data, tmp_path, pallas_interpret):
    """Three clean windows and the poisoned one between them, written
    before run(), through the JAX StreamingRunner and the port's: the same
    admitted/refused sequence and drift scores, loss and AUC a pass, and
    the store; the refused window leaves the port's table and store bit for
    bit as they were."""
    files, poison, jfeed, pfeed = data
    srcs = _stream_srcs(files, poison)
    jt = JTrainer(JDeepFM(JSpec(num_slots=NUM_SLOTS, slot_dim=3 + D),
                          hidden=HIDDEN),
                  JTable(embedx_dim=D, pass_capacity=CAP,
                         optimizer=JSparse(**OPT)),
                  jfeed, JTrainerCfg(dense_lr=LR), seed=0)
    jt.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    pt = _port_trainer(pfeed, jt.params)
    n_steps = -(-WINDOW // BATCH)
    pt.seed_fn = iter(_jax_seeds(jax.random.PRNGKey(0), 3,
                                 n_steps)).__next__
    logs = ([], [])
    _recording(pt, logs[0])
    _recording(jt, logs[1])
    results, spy = [], []
    for pkg, t in (("port", pt), ("jax", jt)):
        watch = str(tmp_path / pkg / "watch")
        _drop(srcs, watch, names=STREAM)
        if pkg == "port":
            s = StreamingDataset(pfeed, watch, ledger_dir=str(tmp_path / pkg),
                                 micro_pass_instances=WINDOW, flags=FLAGS)
            r = StreamingRunner(t, s, flags=FLAGS)
            _boundary_spy(r, t, spy)
        else:
            s = JStream(jfeed, watch, ledger_dir=str(tmp_path / pkg),
                        read_threads=1, micro_pass_instances=WINDOW)
            r = JRunner(t, s)
        results.append(r.run(idle_timeout=1.0))
    got, want = results
    seq = [(p["window"], p["admitted"], p["instances"]) for p in got["passes"]]
    assert seq == [(p["window"], p["admitted"], p["instances"])
                   for p in want["passes"]]
    assert seq == [(0, True, 400), (1, True, 400), (2, False, 400),
                   (3, True, 400)]
    assert [p["drift_score"] for p in got["passes"]] == \
        [p["drift_score"] for p in want["passes"]]
    assert got["passes"][2]["drift_score"] >= 0.8
    assert stats.stat_get("streaming_windows_refused") == 1
    assert stats.stat_get("streaming_micro_passes") == 4
    assert len(logs[0]) == len(logs[1]) == 3
    for (gl, ga), (wl, wa) in zip(*logs):
        np.testing.assert_allclose(gl, wl, rtol=1e-4)
        assert abs(ga - wa) <= 1e-4
    (pk, pv), (jk, jv) = _sorted_items(pt.table.store), _sorted_items(
        jt.table.store)
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_array_equal(pv[:, INT_COLS], jv[:, INT_COLS])
    np.testing.assert_allclose(pv, jv, rtol=1e-4, atol=1e-7)
    # the refused window: the store and the resident slab at its boundary
    # are those at the boundary before it (999999 never created)
    (_, before, slab0), (admitted, at, slab1) = spy[1], spy[2]
    assert not admitted
    np.testing.assert_array_equal(at[0], before[0])
    _assert_bits(at[1], before[1])
    _assert_bits(slab1.numpy(), slab0.numpy())
    assert 999999 not in set(pk.tolist())
    pt.close()
    jt.close()


# ------------------------------------------- the runner against the port

def test_micro_passes_equal_sequential_preloaded_passes(data, tmp_path):
    """The stream's admitted windows against the same windows through
    PassPreloader + train_pass(preloaded=True) one at a time: losses, AUC,
    the store and the resident slab bit for bit."""
    files, poison, jfeed, pfeed = data
    watch = str(tmp_path / "watch")
    _drop(_stream_srcs(files, poison), watch, names=STREAM)
    a, b = _port_trainer(pfeed), _port_trainer(pfeed)
    logs = ([], [])
    _recording(a, logs[0])
    _recording(b, logs[1])
    s = StreamingDataset(pfeed, watch, ledger_dir=str(tmp_path),
                         micro_pass_instances=WINDOW, flags=FLAGS)
    res = StreamingRunner(a, s, flags=FLAGS).run(idle_timeout=1.0)
    assert [p["admitted"] for p in res["passes"]] == [True, True, False,
                                                      True]
    pre = PassPreloader(b.table)
    for fs in (files[0:2], files[2:4], files[4:6]):
        ds = BoxDataset(pfeed)
        ds.set_filelist(fs)
        pre.preload(ds)
        pre.wait(ds)
        b.train_pass(ds, preloaded=True)
    assert logs[0] == logs[1]
    for x, y in zip(_sorted_items(a.table.store),
                    _sorted_items(b.table.store)):
        _assert_bits(x, y)
    _assert_bits(a.table.resident_slab.numpy(),
                 b.table.resident_slab.numpy())
    assert a.table.counters == b.table.counters
    a.close()
    b.close()


# ---------------------------------------------------------------- journal

def test_publish_segment_byte_identical_to_reference(tmp_path, monkeypatch):
    """The same rows, then publish with a watermark, with a second publish
    over nothing, then rows and a publish without one, through both
    packages' journals with time.time pinned: the same sealed files, byte
    for byte; the replay skips the watermark."""
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    rng = np.random.RandomState(3)
    keys = np.unique(rng.randint(1, 1 << 40, 50).astype(np.uint64))
    rows = rng.randn(keys.size, ValueLayout(D).width).astype(np.float32)
    sealed = []
    for mod, layout, tcfg in (
            (jr, ValueLayout(D), _table_cfg()),
            (jjr, JLayout(D), JTable(embedx_dim=D, pass_capacity=CAP,
                                     optimizer=JSparse(**OPT)))):
        j = mod.TouchedRowJournal(str(tmp_path / mod.__name__), layout,
                                  tcfg)
        j.append_rows(keys, rows)
        first = j.publish(born_min=1000.25, born_max=1100.75,
                          trace=0xABC)
        assert j.publish(born_min=1.0) is None   # nothing pending
        j.append_rows(keys[:7], rows[:7] * 2)
        second = j.publish()
        sealed.append((first, second))
        j.close()
    for p, q in zip(*sealed):
        assert os.path.basename(p) == os.path.basename(q)
        with open(p, "rb") as a, open(q, "rb") as b:
            assert a.read() == b.read()
    kinds = [k for k, _ in jf.iter_segment(sealed[0][0])]
    assert kinds[-1] == jf.KIND_WATERMARK and kinds.count(
        jf.KIND_WATERMARK) == 1
    payload = [pl for k, pl in jf.iter_segment(sealed[0][0])
               if k == jf.KIND_WATERMARK][0]
    assert jf.unpack_watermark(payload) == (1000.25, 1100.75, 1234.5,
                                            0xABC)
    from paddlebox_tpu_torch.embedding.host_store import HostEmbeddingStore
    store = HostEmbeddingStore(ValueLayout(D), _table_cfg())
    jr.replay_segments(store, _table_cfg(), [p for p in sealed[0]])
    k2, v2 = _sorted_items(store)
    want = rows.copy()
    want[:7] *= 2
    np.testing.assert_array_equal(k2, keys)
    _assert_bits(v2, want)


def _cm(tmp_path, table, **flags):
    return pckpt.CheckpointManager(
        CheckpointConfig(batch_model_dir=str(tmp_path / "batch"),
                         xbox_model_dir=str(tmp_path / "xbox"),
                         async_save=False), table, CkptFlags(**flags))


def test_micro_checkpoint_replays_to_live_store(data, tmp_path):
    """base_every=3 over three admitted windows: a full base at the first,
    a journal-mode one at the third whose segments are the windows'
    publishes; load_base on a fresh table, with the save's stat rewrite
    replayed, is the live store bit for bit."""
    files, poison, jfeed, pfeed = data
    watch = str(tmp_path / "watch")
    _drop(_stream_srcs(files, poison), watch, names=STREAM)
    t = _port_trainer(pfeed)
    cm = _cm(tmp_path, t.table)
    s = StreamingDataset(pfeed, watch, ledger_dir=str(tmp_path / "batch"),
                         micro_pass_instances=WINDOW, flags=FLAGS)
    res = StreamingRunner(t, s, cm=cm, base_every=3,
                          flags=FLAGS).run(idle_timeout=1.0)
    assert res["admitted"] == 3 and res["refused"] == 1
    days = sorted(d for d in os.listdir(tmp_path / "batch")
                  if d.startswith("stream-"))
    assert days == ["stream-000000", "stream-000003"]
    import json
    man = json.load(open(tmp_path / "batch" / "stream-000003"
                         / "sparse.xman"))
    assert man["mode"] == "journal" and len(man["segments"]) >= 2
    loaded = _port_trainer(pfeed)
    lcm = pckpt.CheckpointManager(
        CheckpointConfig(batch_model_dir=str(tmp_path / "batch"),
                         xbox_model_dir=str(tmp_path / "xbox"),
                         async_save=False), loaded.table,
        CkptFlags(ckpt_journal=False))
    lcm.load_base("stream-000003")
    for param in (1, 3):
        jr.apply_stat_after_save(loaded.table.store, loaded.table.config,
                                 param)
    for x, y in zip(_sorted_items(loaded.table.store),
                    _sorted_items(t.table.store)):
        _assert_bits(x, y)
    t.close()
    loaded.close()


def test_reference_tailer_reads_the_published_stream(data, tmp_path):
    """serving/refresh.py's JournalDeltaSource tails the port's journal
    after a stream with no base saves: its overlay is the port's store's
    served columns bit for bit, and its applied watermark is the last
    admitted window's born_max (a watermark record a published window)."""
    files, poison, jfeed, pfeed = data
    watch = str(tmp_path / "watch")
    _drop(_stream_srcs(files, poison), watch, names=STREAM)
    t = _port_trainer(pfeed)
    cm = _cm(tmp_path, t.table)
    s = StreamingDataset(pfeed, watch, ledger_dir=str(tmp_path / "batch"),
                         micro_pass_instances=WINDOW, flags=FLAGS)
    res = StreamingRunner(t, s, cm=cm, base_every=0,
                          flags=FLAGS).run(idle_timeout=1.0)
    assert res["admitted"] == 3
    segs = sorted(os.path.join(cm.journal.dir, f)
                  for f in os.listdir(cm.journal.dir) if f.endswith(".jrnl"))
    marks = [jf.unpack_watermark(pl) for p in segs
             for k, pl in jf.iter_segment(p) if k == jf.KIND_WATERMARK]
    assert len(marks) == 3
    last = os.path.join(watch, STREAM[-1])
    assert marks[-1][1] == os.path.getmtime(last)
    src = JournalDeltaSource([cm.journal.dir])
    try:
        assert src.poll()
        assert src.applied_watermark() == os.path.getmtime(last)
        stack = MmapViewStack([], extra_files=(src.compile_overlay(),))
        sk, sv = _sorted_items(t.table.store)
        cols = jf.xbox_embed_cols(D, "adagrad")
        _assert_bits(stack.lookup(sk), sv[:, cols])
    finally:
        src.close()
    assert stats.gauge_get("streaming_publish_lag_secs") > 0.0
    t.close()
