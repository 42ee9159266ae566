"""The port's runtime lock-order validator (utils/lockwatch.py) against the
JAX package's.

The reference's tests/test_lockwatch.py cases run against the port (its
Channel case becomes the port's dump writer, the queue that has a watched
lock); a scripted AB/BA sequence through both packages' lockwatch gives
equal edges and inversions (exact); a port pass with the switch on records
no inversion and equals the pass with it off bit for bit (losses, AUC,
store rows).
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from paddlebox_tpu.config import flags as jflags
from paddlebox_tpu.utils import lockwatch as jlockwatch

from paddlebox_tpu_torch.config.configs import (DataFeedConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.config.flags import PushFlags
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.data.generator import write_synthetic_ctr_files
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.train.trainer import BoxTrainer
from paddlebox_tpu_torch.utils import lockwatch
from paddlebox_tpu_torch.utils.stats import (StatRegistry, stat_get,
                                             stat_reset)


@pytest.fixture
def watch_on():
    prev = lockwatch.set_enabled(True)
    lockwatch.reset()
    yield
    lockwatch.reset()
    lockwatch.set_enabled(prev)


def test_off_returns_plain_primitives():
    prev = lockwatch.set_enabled(False)
    try:
        assert type(lockwatch.make_lock("X._l")) is type(threading.Lock())
        assert type(lockwatch.make_rlock("X._r")) is type(threading.RLock())
    finally:
        lockwatch.set_enabled(prev)


def test_switch_defaults_from_the_environment():
    """PBTPU_DEBUG_LOCK_ORDER at the module's import sets the switch."""
    code = ("from paddlebox_tpu_torch.utils import lockwatch as w; "
            "print(w.enabled(), type(w.make_lock('A._l')).__name__)")
    for raw, want in (("1", "True _WatchedLock"), ("0", "False lock")):
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            env={**os.environ, "PBTPU_DEBUG_LOCK_ORDER": raw}, timeout=60)
        assert out.stdout.split() == want.split(), out.stderr


def _ab_ba(mod):
    la = mod.make_lock("Toy._a")
    lb = mod.make_lock("Toy._b")

    def ab():
        with la:
            with lb:
                pass

    def ba():
        with lb:
            with la:
                pass

    for fn in (ab, ba):
        t = threading.Thread(target=fn)
        t.start()
        t.join()


def test_seeded_ab_ba_inversion_detected(watch_on):
    stat_reset("lockwatch_inversions")
    _ab_ba(lockwatch)
    inv = lockwatch.inversions()
    assert len(inv) == 1
    assert set(inv[0]["pair"]) == {"Toy._a", "Toy._b"}
    assert stat_get("lockwatch_inversions") == 1
    with pytest.raises(AssertionError, match="Toy._"):
        lockwatch.assert_consistent()


def test_ab_ba_sequence_matches_the_reference(watch_on):
    """The same scripted sequence (AB, BA, AB again, a nested C) through
    both packages: equal edges, inversions and report."""
    jflags.set_flag("debug_lock_order", True)
    jlockwatch.reset()
    try:
        for mod in (lockwatch, jlockwatch):
            _ab_ba(mod)
            _ab_ba(mod)
            lc = mod.make_rlock("Toy._c")
            la = mod.make_lock("Toy._a")
            with lc:
                with lc:
                    with la:
                        pass
        assert lockwatch.edges() == jlockwatch.edges() == {
            ("Toy._a", "Toy._b"): 2, ("Toy._b", "Toy._a"): 2,
            ("Toy._c", "Toy._a"): 2}   # once per level of C held
        strip = [[(i["pair"], i["stack_names"]) for i in m.inversions()]
                 for m in (lockwatch, jlockwatch)]
        assert strip[0] == strip[1] and len(strip[0]) == 1
        assert lockwatch.order_report() == jlockwatch.order_report()
        assert lockwatch.order_cycles() == jlockwatch.order_cycles()
    finally:
        jlockwatch.reset()
        jflags.set_flag("debug_lock_order", False)


def test_consistent_global_order_stays_clean(watch_on):
    la = lockwatch.make_lock("C._a")
    lb = lockwatch.make_lock("C._b")
    for _ in range(3):
        with la:
            with lb:
                pass
    with la:
        pass
    lockwatch.assert_consistent()
    assert lockwatch.edges() == {("C._a", "C._b"): 3}
    assert "C._a -> C._b x3" in lockwatch.order_report()


def test_rlock_reentry_records_no_self_edge(watch_on):
    r = lockwatch.make_rlock("R._l")
    with r:
        with r:
            pass
    assert lockwatch.edges() == {}
    lockwatch.assert_consistent()


def test_hold_time_histogram_published(watch_on):
    lk = lockwatch.make_lock("H._l")
    with lk:
        pass
    counts = StatRegistry.instance().hist_counts("lock_hold_us_H__l")
    assert counts is not None and sum(counts) == 1


def test_condition_wait_rebalances_held_stack(watch_on):
    mutex = lockwatch.make_lock("Cond._m")
    cv = threading.Condition(mutex)
    entered = threading.Event()
    hit = []

    def waiter():
        with cv:
            entered.set()
            cv.wait(timeout=5)
            hit.append(lockwatch.current_held())

    t = threading.Thread(target=waiter)
    t.start()
    assert entered.wait(timeout=5)
    with cv:
        cv.notify()
    t.join(timeout=10)
    assert not t.is_alive()
    assert hit and hit[0] == ["Cond._m"]
    assert lockwatch.current_held() == []
    lockwatch.assert_consistent()


def test_dump_writer_under_watch_round_trip(watch_on, tmp_path):
    from paddlebox_tpu_torch.train.dump import DumpWriter
    w = DumpWriter(str(tmp_path), thread_num=2)
    assert type(w._files_lock).__name__ == "_WatchedLock"
    w.dump_batch({"label": np.array([1, 0])}, ins_ids=["a", "b"])
    w.close()
    assert len(w.files) == 1
    lockwatch.assert_consistent()


def test_foreign_release_counted_not_crashed(watch_on):
    stat_reset("lockwatch_foreign_release")
    lk = lockwatch.make_lock("F._l")
    lk.acquire()
    t = threading.Thread(target=lk.release)
    t.start()
    t.join()
    assert stat_get("lockwatch_foreign_release") == 1
    assert not lk.locked()
    lockwatch.assert_consistent()
    assert lockwatch.current_held() == ["F._l"]
    lockwatch.reset()
    assert lockwatch.current_held() == []


def test_three_lock_cycle_detected_by_assert(watch_on):
    la = lockwatch.make_lock("Cy._a")
    lb = lockwatch.make_lock("Cy._b")
    lc = lockwatch.make_lock("Cy._c")
    for outer, inner in ((la, lb), (lb, lc), (lc, la)):
        t = threading.Thread(target=lambda o=outer, i=inner: (
            o.acquire(), i.acquire(), i.release(), o.release()))
        t.start()
        t.join()
    assert lockwatch.inversions() == []
    assert lockwatch.order_cycles()
    with pytest.raises(AssertionError, match="cycle"):
        lockwatch.assert_consistent()


def test_condition_on_watched_rlock(watch_on):
    r = lockwatch.make_rlock("CR._l")
    cv = threading.Condition(r)
    entered = threading.Event()
    hit = []

    def waiter():
        with r:
            with cv:
                entered.set()
                cv.wait(timeout=5)
                hit.append(list(lockwatch.current_held()))

    t = threading.Thread(target=waiter)
    t.start()
    assert entered.wait(timeout=5)
    with cv:
        cv.notify()
    t.join(timeout=10)
    assert not t.is_alive()
    assert hit and hit[0] == ["CR._l", "CR._l"]
    assert lockwatch.current_held() == []
    lockwatch.assert_consistent()


def _pass_digits(files, feed, watched):
    prev = lockwatch.set_enabled(watched)
    try:
        torch.manual_seed(0)
        model = DeepFM(ModelSpec(num_slots=4, slot_dim=11), hidden=(16, 8))
        t = BoxTrainer(model, TableConfig(
            embedx_dim=8, pass_capacity=1024,
            optimizer=SparseOptimizerConfig(mf_create_thresholds=0.0,
                                            mf_initial_range=1e-3)),
            feed, TrainerConfig(dense_lr=5e-3, scan_chunk=2), seed=0,
            flags=PushFlags("scatter"), device="cpu")
    finally:
        lockwatch.set_enabled(prev)
    kinds = {type(t.table.store_lock).__name__,
             type(t.quality._lock).__name__}
    t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    ds = BoxDataset(feed)
    ds.set_filelist(files)
    out = []
    for _ in range(2):
        res = t.train_pass(ds)
        out.append((res["loss"], t.metrics.get_metric_msg("auc")["auc"]))
    rows = t.table.store.lookup(t.table.pass_keys)
    t.close()
    return out, rows, kinds


def test_watched_pass_has_no_inversion_and_equals_unwatched(tmp_path):
    files, gfeed = write_synthetic_ctr_files(
        str(tmp_path), num_files=2, lines_per_file=64, num_slots=4,
        vocab_per_slot=40, max_len=3, seed=19)
    feed = DataFeedConfig(slots=gfeed.slots, batch_size=32)
    lockwatch.reset()
    watched, w_rows, w_kinds = _pass_digits(files, feed, True)
    assert w_kinds == {"_WatchedLock"}
    edges = lockwatch.edges()
    lockwatch.assert_consistent()
    assert lockwatch.inversions() == []
    plain, p_rows, p_kinds = _pass_digits(files, feed, False)
    assert p_kinds == {"lock"}
    assert watched == plain
    np.testing.assert_array_equal(w_rows, p_rows)
    hist = StatRegistry.instance().hist_counts(
        "lock_hold_us_PassTable_store_lock")
    assert hist is not None and sum(hist) > 0
    lockwatch.reset()
    assert all(a != b for a, b in edges)
