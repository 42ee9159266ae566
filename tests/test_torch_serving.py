"""The port's serving store and cache (paddlebox_tpu_torch/serving/store.py,
cache.py, refresh.py's ViewManager and watcher) against the JAX package's.

Nothing here is float arithmetic, so nothing has a tolerance: rows are
compared bit for bit, files byte for byte, counters and masks exactly.
Both packages' MmapViewStack and XboxModelReader read the same view
directories; compile_view_dir's and ShardSpec's files are the same bytes
under the same names; a hot-key file written by one reads in the other;
one scripted key stream through both HotKeyCaches gives the same hits,
admissions, evictions and counters. The ViewManager's epoch guard and the
swap under load are the reference's own cases, run on the port.
"""

import os
import pickle
import shutil
import threading
import time
import weakref

import numpy as np
import pytest

from paddlebox_tpu.parallel import sharding as jsharding
from paddlebox_tpu.serving import cache as jcache
from paddlebox_tpu.serving import store as jstore
from paddlebox_tpu.train.checkpoint import XboxModelReader as JReader
from paddlebox_tpu.utils import stats as jstats

from paddlebox_tpu_torch.parallel import sharding
from paddlebox_tpu_torch.serving import (HotKeyCache, MmapViewStack,
                                         build_stack, make_manager)
from paddlebox_tpu_torch.serving import store
from paddlebox_tpu_torch.serving.refresh import (DeltaRefreshWatcher,
                                                 ViewManager)
from paddlebox_tpu_torch.train.checkpoint import XboxModelReader
from paddlebox_tpu_torch.utils import lockwatch
from paddlebox_tpu_torch.utils import stats

D = 4
CACHE_STATS = ("serving_cache_hit", "serving_cache_miss",
               "serving_cache_evict", "serving_cache_admit")


def write_view(root, day, sub=None, keys=(), rows=None, ts=None, seed=0):
    """One view directory (embedding.pkl and DONE) as the checkpoint
    writer lays it out; rows a seeded random matrix by default."""
    p = os.path.join(root, day) if sub is None else os.path.join(
        root, day, sub)
    os.makedirs(p, exist_ok=True)
    keys = np.asarray(sorted(set(int(k) for k in keys)), np.uint64)
    if rows is None:
        rows = np.random.RandomState(seed).randn(
            keys.size, D).astype(np.float32)
    with open(os.path.join(p, "embedding.pkl"), "wb") as f:
        pickle.dump({"keys": keys,
                     "embedding": np.asarray(rows, np.float32)}, f)
    with open(os.path.join(p, "DONE"), "w") as f:
        f.write(str(time.time() if ts is None else ts))
    return p


def probe_keys(rng, *key_sets, extra_misses=8):
    """Every key some view holds, misses, and half the keys again,
    shuffled."""
    pool = sorted(set().union(*[set(int(k) for k in ks)
                                for ks in key_sets]))
    misses = [max(pool, default=0) + 1 + i for i in range(extra_misses)]
    probe = np.array(pool + misses + pool[: len(pool) // 2], np.uint64)
    rng.shuffle(probe)
    return probe


def bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def file_bytes(path):
    with open(path, "rb") as f:
        return f.read()


# -------------------------------------------------------------------- stack

def _mid_day(root):
    """A base, two same-day deltas and a next-day delta (the mid-day
    consumer): the deltas overlap the base and each other."""
    rng = np.random.RandomState(0)
    k_base = rng.choice(1 << 20, 300, replace=False)
    k_d1 = rng.choice(k_base, 40, replace=False)
    k_d2 = np.concatenate([rng.choice(k_d1, 10, replace=False), [1 << 21]])
    k_next = np.concatenate([rng.choice(k_base, 25, replace=False),
                             [1 << 22]])
    write_view(root, "day0", "delta-1", k_d1, seed=1)
    write_view(root, "day0", "delta-2", k_d2, seed=2)
    write_view(root, "day0", None, k_base, seed=3)
    write_view(root, "day1", "delta-1", k_next, seed=4)
    return ["day0", "day1"], (k_base, k_d1, k_d2, k_next), 4


def _clock_skew(root):
    """DONE stamps inverted against the structural order: the base far in
    the future, a later day's deltas in the past and out of id order."""
    keys = np.arange(1, 64, dtype=np.uint64)
    write_view(root, "day0", None, keys, seed=6, ts=4e9)
    write_view(root, "day0", "delta-1", keys[:20], seed=7, ts=3e9)
    write_view(root, "day1", "delta-1", keys[10:30], seed=8, ts=10.0)
    write_view(root, "day1", "delta-2", keys[25:40], seed=9, ts=5.0)
    return ["day0", "day1"], (keys,), 4


def _empty_delta(root):
    """A delta save that nothing crossed: a zero-key view."""
    keys = np.arange(1, 40, dtype=np.uint64)
    write_view(root, "day0", None, keys, seed=20)
    write_view(root, "day0", "delta-1", [], rows=np.empty((0, D), np.float32))
    return ["day0"], (keys,), 2


@pytest.mark.parametrize("scenario", [_mid_day, _clock_skew, _empty_delta],
                         ids=["mid_day", "clock_skew", "empty_delta"])
def test_stack_matches_reference_stack_and_both_readers(tmp_path, scenario):
    """The port's MmapViewStack, the reference's and both packages'
    XboxModelReader answer one probe (hits, misses, duplicates) with the
    same bits, over views the two packages compile apart (two copies of
    one directory tree); the sources come out in the same order."""
    root = str(tmp_path / "port")
    days, key_sets, n_sources = scenario(root)
    jroot = str(tmp_path / "ref")
    shutil.copytree(root, jroot)
    probe = probe_keys(np.random.RandomState(21), *key_sets)

    stack, sources = build_stack(root, days)
    jstack, jsources = jstore.build_stack(jroot, days)
    assert len(sources) == n_sources
    assert ([(s.day_index, s.is_base, s.delta_id) for s in sources]
            == [(s.day_index, s.is_base, s.delta_id) for s in jsources])
    want = bits(JReader(jroot, *days).lookup(probe))
    assert np.array_equal(bits(XboxModelReader(root, *days).lookup(probe)),
                          want)
    assert np.array_equal(bits(jstack.lookup(probe)), want)
    assert np.array_equal(bits(stack.lookup(probe)), want)
    assert stack.dim == jstack.dim and \
        stack.total_rows == jstack.total_rows
    for s, js in zip(sources, jsources):
        assert file_bytes(os.path.join(s.path, store.VIEW_COLUMNAR_NAME)) \
            == file_bytes(os.path.join(js.path, jstore.VIEW_COLUMNAR_NAME))
    assert store.discover_days(root) == jstore.discover_days(jroot) == days
    stack.close()
    jstack.close()


def test_clock_skew_sources_follow_structure(tmp_path):
    root = str(tmp_path)
    _clock_skew(root)
    sources = store.discover_xbox_sources(root, ["day0", "day1"])
    assert [(s.day_index, s.is_base, s.delta_id) for s in sources] == [
        (0, 0, 1), (0, 1, 0), (1, 0, 1), (1, 0, 2)]


def test_mmap_store_ids_and_rows_match_the_reference(tmp_path):
    """MmapXboxStore of both packages over one file: the same row ids
    (-1 a miss, through rt_lookup_serve) and rows; an empty view maps
    nothing and misses every key."""
    rng = np.random.RandomState(3)
    keys = np.unique(rng.randint(1, 1 << 40, 500).astype(np.uint64))
    rows = rng.randn(keys.size, D).astype(np.float32)
    path = store.write_xbox_columnar(str(tmp_path / "v.xcol"), keys, rows)
    probe = np.concatenate([rng.choice(keys, 200),
                            rng.randint(1 << 41, 1 << 42, 30)]
                           ).astype(np.uint64)
    st, jst = store.MmapXboxStore(path), jstore.MmapXboxStore(path)
    assert len(st) == len(jst) == keys.size and st.dim == D
    assert np.array_equal(st.lookup_ids(probe), jst.lookup_ids(probe))
    assert np.array_equal(bits(st.lookup(probe)), bits(jst.lookup(probe)))
    assert (st.lookup_ids(probe)[200:] == -1).all()
    st.close()
    st.close()                       # idempotent
    jst.close()
    empty = store.write_xbox_columnar(str(tmp_path / "e.xcol"),
                                      np.empty(0, np.uint64),
                                      np.empty((0, D), np.float32))
    es = store.MmapXboxStore(empty)
    assert len(es) == 0 and es._index is None
    assert (es.lookup_ids(probe) == -1).all()
    assert not es.lookup(probe).any()


def test_from_files_stacks_newest_last(tmp_path):
    a = store.write_xbox_columnar(str(tmp_path / "a.xcol"),
                                  np.array([1, 2, 3], np.uint64),
                                  np.ones((3, D), np.float32))
    b = store.write_xbox_columnar(str(tmp_path / "b.xcol"),
                                  np.array([2], np.uint64),
                                  np.full((1, D), 7, np.float32))
    k = np.array([1, 2, 9], np.uint64)
    got = MmapViewStack.from_files([a, b]).lookup(k)
    assert np.array_equal(bits(got),
                          bits(jstore.MmapViewStack.from_files([a, b])
                               .lookup(k)))
    assert got[1, 0] == 7 and got[0, 0] == 1 and not got[2].any()
    with pytest.raises(ValueError, match="at least one"):
        MmapViewStack([])


# ------------------------------------------------------------- view compile

def test_compile_view_dir_byte_identical_and_idempotent(tmp_path):
    """The columnar twin of an embedding.pkl is the reference's byte for
    byte, written once (gated by mtime) and rewritten when the pickle
    changes; a view that is columnar already compiles to itself."""
    p = write_view(str(tmp_path / "port"), "day0", None, [3, 1, 2], seed=1)
    jp = write_view(str(tmp_path / "ref"), "day0", None, [3, 1, 2], seed=1)
    out = store.compile_view_dir(p)
    assert file_bytes(out) == file_bytes(jstore.compile_view_dir(jp))
    m1 = os.path.getmtime(out)
    assert store.compile_view_dir(p) == out
    assert os.path.getmtime(out) == m1
    time.sleep(0.02)
    write_view(str(tmp_path / "port"), "day0", None, [3, 1, 2, 4], seed=2)
    os.utime(os.path.join(p, "embedding.pkl"))
    store.compile_view_dir(p)
    st = store.MmapXboxStore(out)
    assert len(st) == 4
    st.close()
    col = str(tmp_path / "columnar")
    os.makedirs(col)
    shutil.copy(out, os.path.join(col, store.VIEW_COLUMNAR_NAME))
    assert store.compile_view_dir(col) == os.path.join(
        col, store.VIEW_COLUMNAR_NAME)
    with pytest.raises(FileNotFoundError):
        store.compile_view_dir(str(tmp_path))


def test_compile_view_dir_refuses_a_class_pickle(tmp_path):
    """safe_load reads numpy and builtin containers only: an embedding.pkl
    that holds another class raises before its module is imported (the
    reference unpickles it)."""
    import fractions
    p = str(tmp_path / "day0")
    os.makedirs(p)
    with open(os.path.join(p, "embedding.pkl"), "wb") as f:
        pickle.dump({"keys": np.array([1], np.uint64),
                     "embedding": np.ones((1, D), np.float32),
                     "note": fractions.Fraction(1, 3)}, f)
    with pytest.raises(pickle.UnpicklingError, match="fractions"):
        store.compile_view_dir(p)
    assert not os.path.exists(os.path.join(p, store.VIEW_COLUMNAR_NAME))
    dup = str(tmp_path / "dup")
    os.makedirs(dup)
    with open(os.path.join(dup, "embedding.pkl"), "wb") as f:
        pickle.dump({"keys": np.array([5, 5], np.uint64),
                     "embedding": np.ones((2, D), np.float32)}, f)
    with pytest.raises(ValueError, match="duplicate"):
        store.compile_view_dir(dup)


# ---------------------------------------------------------- fleet partition

POLICIES = {
    "key-mod": (lambda: sharding.KeyModPolicy(3),
                lambda: jsharding.KeyModPolicy(3)),
    "table-wise": (lambda: sharding.TableWisePolicy(3, 8, table_shift=36),
                   lambda: jsharding.TableWisePolicy(3, 8, table_shift=36)),
}


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_shard_spec_tag_and_filtered_file_match_the_reference(tmp_path,
                                                              policy):
    """One box's ShardSpec in either package: the same identity, mask,
    file name (the crc32 tag) and filtered bytes, so a port box reuses a
    reference box's filtered view (its mtime gate passes) and the filtered
    stack answers the box's keys as the full view does."""
    rng = np.random.RandomState(4)
    keys = np.unique(rng.randint(1, 1 << 40, 3000).astype(np.uint64))
    rows = rng.randn(keys.size, D).astype(np.float32)
    full = store.write_xbox_columnar(str(tmp_path / "v.xcol"), keys, rows)
    hot = np.sort(rng.choice(keys, 16, replace=False))
    make, jmake = POLICIES[policy]
    for index in range(3):
        for h in (None, hot):
            spec = store.ShardSpec(index, make(), hot_keys=h)
            jspec = jstore.ShardSpec(index, jmake(), hot_keys=h)
            assert spec.describe() == jspec.describe()
            assert spec._tag == jspec._tag
            assert np.array_equal(spec.mask(keys), jspec.mask(keys))
            jout = jspec.filter_view(full)
            data = file_bytes(jout)
            m = os.path.getmtime(jout)
            assert spec.filter_view(full) == jout     # reused as it is
            assert os.path.getmtime(jout) == m
            os.remove(jout)
            out = spec.filter_view(full)
            assert out == jout and file_bytes(out) == data
            served = keys[spec.mask(keys)]
            st = MmapViewStack([], shard_spec=spec, extra_files=(full,))
            whole = MmapViewStack.from_files([full])
            assert np.array_equal(bits(st.lookup(served)),
                                  bits(whole.lookup(served)))
    with pytest.raises(ValueError, match="outside"):
        store.ShardSpec(3, make())


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_hot_keys_file_reads_in_the_other_package(tmp_path, writer):
    path = str(tmp_path / "hot.keys")
    keys = np.array([9, 3, 3, 7, 1 << 63], np.uint64)
    w, r = ((store, jstore) if writer == "port" else (jstore, store))
    w.write_hot_keys(path, keys)
    assert np.array_equal(r.read_hot_keys(path),
                          np.array([3, 7, 9, 1 << 63], np.uint64))
    assert np.array_equal(store.read_hot_keys(path),
                          jstore.read_hot_keys(path))
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 8)
    with pytest.raises(ValueError, match="truncated"):
        store.read_hot_keys(path)
    with open(path, "r+b") as f:
        f.write(b"NOTHOTK!")
    with pytest.raises(ValueError, match="not a hot-key set"):
        store.read_hot_keys(path)


# -------------------------------------------------------------------- cache

def _cache_script(mod, reg_get, capacity=6, admit=2):
    """One scripted key stream (zipf-hot with a scan, capacity 6, admit 2,
    a small sketch so the halving runs): each step's miss mask, filled
    rows, admitted count and size; then the four counters' deltas."""
    cache = mod.HotKeyCache(capacity=capacity, dim=2, admit=admit,
                            sketch_cap=8)
    before = {n: reg_get(n) for n in CACHE_STATS}
    rng = np.random.RandomState(9)
    trace = []
    for step in range(40):
        if step % 10 == 9:           # a cold scan
            keys = np.arange(1000 + 20 * step, 1020 + 20 * step,
                             dtype=np.uint64)
        else:
            keys = (rng.zipf(1.5, 8) % 23).astype(np.uint64)
        out = np.zeros((keys.size, 2), np.float32)
        miss = cache.get_many(keys, out, epoch=cache.epoch)
        rows = np.tile(keys.astype(np.float32)[:, None], (1, 2))
        got = cache.admit_many(keys[miss], rows[miss], epoch=cache.epoch)
        trace.append((miss.tolist(), bits(out).tolist(), got, len(cache)))
    return trace, {n: reg_get(n) - before[n] for n in CACHE_STATS}


def test_cache_sequence_and_counters_match_the_reference():
    trace, counts = _cache_script(
        __import__("paddlebox_tpu_torch.serving.cache",
                   fromlist=["HotKeyCache"]), stats.stat_get)
    jtrace, jcounts = _cache_script(jcache, jstats.stat_get)
    assert trace == jtrace
    assert counts == jcounts
    assert all(counts[n] > 0 for n in CACHE_STATS), counts


def test_cache_admission_eviction_accounting():
    """Frequency-gated admission, CLOCK eviction, exact counters (the
    reference's case on the port)."""
    base = {n: stats.stat_get(n) for n in CACHE_STATS}

    def delta(n):
        return stats.stat_get(n) - base[n]

    cache = HotKeyCache(capacity=4, dim=2, admit=2)

    def rows_of(ks):
        return np.tile(np.asarray(ks, np.float32)[:, None], (1, 2))

    k = np.array([1, 2, 3], np.uint64)
    out = np.zeros((3, 2), np.float32)
    assert cache.get_many(k, out).all() and delta("serving_cache_miss") == 3
    assert cache.admit_many(k, rows_of(k), epoch=0) == 0
    assert cache.admit_many(k, rows_of(k), epoch=0) == 3
    assert not cache.get_many(k, out).any()
    assert np.array_equal(out, rows_of(k))
    assert delta("serving_cache_hit") == 3
    k4 = np.array([4], np.uint64)
    cache.admit_many(k4, rows_of(k4), epoch=0)
    cache.admit_many(k4, rows_of(k4), epoch=0)
    k5 = np.array([5], np.uint64)
    cache.admit_many(k5, rows_of(k5), epoch=0)
    cache.admit_many(k5, rows_of(k5), epoch=0)
    # 1..3 were hit (reference bits set): the victim is 4
    assert len(cache) == 4 and delta("serving_cache_evict") == 1
    out1 = np.zeros((1, 2), np.float32)
    assert not cache.get_many(np.array([5], np.uint64), out1).any()
    assert cache.get_many(np.array([4], np.uint64), out1).all()
    assert stats.gauge_get("serving_cache_fill") == 1.0


def test_cache_stale_epoch_insert_refused_and_probe_all_miss():
    cache = HotKeyCache(capacity=4, dim=2, admit=1)
    k = np.array([7], np.uint64)
    r = np.full((1, 2), 5.0, np.float32)
    assert cache.admit_many(k, r, epoch=0) == 1
    out = np.zeros((1, 2), np.float32)
    assert not cache.get_many(k, out, epoch=0).any()
    assert cache.clear() == 1 and len(cache) == 0
    assert cache.admit_many(k, r, epoch=0) == 0      # stale: dropped
    assert cache.admit_many(k, r, epoch=1) == 1
    out[:] = 0
    assert cache.get_many(k, out, epoch=0).all()     # stale: all-miss
    assert (out == 0).all()
    assert not cache.get_many(k, out, epoch=1).any()
    with pytest.raises(ValueError):
        HotKeyCache(capacity=0, dim=2)


# ------------------------------------------------------------------ refresh

def test_manager_lookup_caches_and_swap_invalidates(tmp_path):
    root = str(tmp_path)
    write_view(root, "day0", None, [1, 2, 3], rows=np.ones((3, D), np.float32))
    mgr, sources = make_manager(root, ["day0"], cache_rows=8, cache_admit=1)
    k = np.array([1, 2], np.uint64)
    out1, gen1 = mgr.lookup(k)
    out2, _ = mgr.lookup(k)
    assert np.array_equal(out1, out2) and len(mgr.cache) == 2
    write_view(root, "day1", "delta-1", [2],
               rows=np.full((1, D), 9, np.float32))
    w = DeltaRefreshWatcher(mgr, root, poll_secs=10.0, known_sources=sources)
    assert w.poll_once()
    assert not w.poll_once()                          # nothing new
    out3, gen3 = mgr.lookup(k)
    assert gen3 == gen1 + 1
    assert np.array_equal(out3[1], np.full(D, 9, np.float32))
    assert stats.gauge_get("serving_view_gen") == gen3
    mgr.close()


def test_manager_tracks_cache_epoch_not_gen(tmp_path):
    """A cache cleared before the manager was made (its epoch ahead of
    generation 0) still admits."""
    root = str(tmp_path)
    write_view(root, "day0", None, [1, 2], rows=np.ones((2, D), np.float32))
    stack, _ = build_stack(root, ["day0"])
    cache = HotKeyCache(capacity=4, dim=D, admit=1)
    cache.clear()
    cache.clear()
    mgr = ViewManager(stack, cache)
    mgr.lookup(np.array([1], np.uint64))
    assert len(cache) == 1
    mgr.close()


def test_swap_keeps_the_outgoing_stack_open_for_its_lookups(tmp_path):
    """swap drops the manager's reference only: a lookup that grabbed
    the old stack reads it after any number of swaps, and its stores free
    their indexes when it lets go."""
    root = str(tmp_path)
    write_view(root, "day0", None, [1, 2], rows=np.ones((2, D), np.float32))
    stack, _ = build_stack(root, ["day0"])
    mgr = ViewManager(stack)
    _gen, held, _epoch = mgr._grab()
    del stack
    for v in (2.0, 3.0):
        p = store.write_xbox_columnar(str(tmp_path / ("%d.xcol" % v)),
                                      np.array([1, 2], np.uint64),
                                      np.full((2, D), v, np.float32))
        mgr.swap(MmapViewStack.from_files([p]))
    assert held._views[0]._index is not None
    assert (held.lookup(np.array([1, 2], np.uint64)) == 1.0).all()
    assert (mgr.lookup(np.array([1], np.uint64))[0] == 3.0).all()
    # no cycle holds the stack: its stores go when the lookup lets go
    refs = [weakref.ref(v) for v in held._views]
    del held
    assert all(r() is None for r in refs)
    mgr.close()


def test_swap_under_load_no_drops(tmp_path):
    """Reader threads hammer lookups while deltas land and swap, under
    the port's lock-order watch: no lookup errs or reads a torn view
    (every value is one generation's), and each delta is served within
    5 s. The poll loop's own reads count toward the generations seen: on
    one core the hammer threads may get no timeslice after the last
    swap."""
    prev = lockwatch.set_enabled(True)
    lockwatch.reset()
    try:
        root = str(tmp_path)
        keys = np.arange(1, 33, dtype=np.uint64)
        write_view(root, "day0", None, keys,
                   rows=np.zeros((32, D), np.float32))
        mgr, sources = make_manager(root, ["day0"], cache_rows=16,
                                    cache_admit=1)
        watcher = DeltaRefreshWatcher(mgr, root, poll_secs=0.05,
                                      known_sources=sources).start()
        errors = []
        stop = threading.Event()
        seen_vals = set()

        def hammer():
            while not stop.is_set():
                try:
                    out, _gen = mgr.lookup(keys)
                    vals = set(np.unique(out).tolist())
                    if len(vals) != 1 or not vals <= {0.0, 1.0, 2.0, 3.0}:
                        errors.append(f"torn read: {sorted(vals)[:4]}")
                    seen_vals.update(vals)
                except Exception as e:  # noqa: BLE001 (no lookup may fail)
                    errors.append(repr(e))

        threads = [threading.Thread(target=hammer) for _ in range(3)]
        for t in threads:
            t.start()
        try:
            for i, v in enumerate((1.0, 2.0, 3.0), 1):
                write_view(root, "day1", f"delta-{i}", keys,
                           rows=np.full((32, D), v, np.float32))
                deadline = time.time() + 5.0
                while time.time() < deadline:
                    out, _ = mgr.lookup(keys[:1])
                    seen_vals.add(float(out[0, 0]))
                    if out[0, 0] == v:
                        break
                    time.sleep(0.01)
                else:
                    errors.append(f"delta {i} not served within 5s")
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10.0)
            watcher.stop()
            mgr.close()
        assert not errors, errors[:5]
        assert {1.0, 2.0, 3.0} <= seen_vals
        lockwatch.assert_consistent()
    finally:
        lockwatch.reset()
        lockwatch.set_enabled(prev)
