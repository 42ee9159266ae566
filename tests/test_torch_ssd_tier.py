"""The port's SSD spill tier, its stores' tier surface and the striped store
against the JAX package's, and the tiered pass cadence against the JAX
trainer and against the port's own untiered full rebuild.

Same inputs, made from a seed with numpy, go through both packages on the
CPU (the port's kernels run their plain versions on CPU tensors).
Tolerances:

  * the tier (spill, read by pop and by peek, batched fault-in, the stale
    block sweep, compaction, span decay across rebases, the lazy-age
    sweep), the Python, native and striped stores' spill, fault-in,
    limiter and checkpoint round trip, and their MOVE records: bit for
    bit against the reference (the same numpy arithmetic on the same
    floats; the MOVE records name the same keys in the same order);
  * the port's tiered passes against its untiered full rebuild: losses,
    AUC, predictions and the store (resident and tier rows at their
    effective values, sorted by key) bit-identical;
  * three tiered window passes against the JAX BoxTrainer: loss rtol 1e-4,
    AUC 1e-4 absolute, store rows rtol 1e-4 with the integer columns exact
    (tests/test_torch_incremental.py's tolerances).
"""

import dataclasses
import functools
import os

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
from paddlebox_tpu.embedding.accessor import ValueLayout as JLayout
from paddlebox_tpu.embedding.host_store import (
    HostEmbeddingStore as JHostStore)
from paddlebox_tpu.embedding.native_store import (
    NativeHostEmbeddingStore as JNativeStore)
from paddlebox_tpu.embedding.ssd_tier import SpillTier as JSpillTier
from paddlebox_tpu.embedding.ssd_tier import (
    sweep_stale_blocks as jsweep_stale_blocks)
from paddlebox_tpu.embedding.striped_store import (
    StripedHostStore as JStriped)
from paddlebox_tpu.embedding.striped_store import stripe_of as jstripe_of
from paddlebox_tpu.models.base import ModelSpec as JSpec
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.train.trainer import BoxTrainer as JTrainer

from paddlebox_tpu_torch import cadence_probe
from paddlebox_tpu_torch.config.configs import (CheckpointConfig,
                                                DataFeedConfig, SlotConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.config.flags import CkptFlags, PassFlags, PushFlags
from paddlebox_tpu_torch.convert import params_from_jax
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.embedding.accessor import ValueLayout
from paddlebox_tpu_torch.embedding.host_store import HostEmbeddingStore
from paddlebox_tpu_torch.embedding.native_store import (
    NativeHostEmbeddingStore)
from paddlebox_tpu_torch.embedding.pass_table import PassTable
from paddlebox_tpu_torch.embedding.ssd_tier import (SpillTier,
                                                    apply_missed_days,
                                                    sweep_stale_blocks)
from paddlebox_tpu_torch.embedding.striped_store import (StripedHostStore,
                                                         stripe_of)
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.train import checkpoint as pckpt
from paddlebox_tpu_torch.train import flagship
from paddlebox_tpu_torch.train.trainer import BoxTrainer
from paddlebox_tpu_torch.utils.stats import stat_get

D = 4
CAP = 1 << 10
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
INT_COLS = [acc.SLOT, acc.SHOW, acc.CLICK, acc.UNSEEN_DAYS, acc.MF_SIZE]
WIDTH = ValueLayout(D).width
STORES = {"python": (HostEmbeddingStore, JHostStore),
          "native": (NativeHostEmbeddingStore, JNativeStore)}


def table_cfg(d=D, cap=CAP, **kw):
    return TableConfig(embedx_dim=d, pass_capacity=cap,
                       optimizer=SparseOptimizerConfig(**OPT), **kw)


def jtable_cfg(d=D, cap=CAP, **kw):
    return JTable(embedx_dim=d, pass_capacity=cap, optimizer=JSparse(**OPT),
                  **kw)


def budget_mb(rows, width=WIDTH):
    """The ssd_threshold_mb that holds ``rows`` rows of ``width``."""
    return rows * width * 4 / float(1 << 20)


def bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def assert_bits_equal(a, b):
    np.testing.assert_array_equal(bits(a), bits(b))


def union(store):
    """(keys, rows) of the store's resident and tier rows (the tier's at
    their effective values), sorted by key."""
    k, v = store.state_items()
    sk, sv = store.spilled_snapshot()
    k, v = np.concatenate([k, sk]), np.vstack([v, sv])
    order = np.argsort(k)
    return k[order], v[order]


def assert_unions_equal(a, b):
    (ka, va), (kb, vb) = union(a), union(b)
    np.testing.assert_array_equal(ka, kb)
    assert_bits_equal(va, vb)


def rows_for(keys, stamp=1.0):
    vals = np.zeros((keys.size, WIDTH), np.float32)
    vals[:, acc.SHOW] = keys.astype(np.float32)
    vals[:, acc.CLICK] = stamp
    return vals


def both_tiers(tmp_path, on_disk=True, decay=0.98):
    """(port tier, reference tier), each in a directory of its own."""
    return (SpillTier(WIDTH, str(tmp_path / "p") if on_disk else None, "t0",
                      decay),
            JSpillTier(WIDTH, str(tmp_path / "j") if on_disk else None, "t0",
                       decay))


# ---------------------------------------------------------------- the tier

@pytest.mark.parametrize("on_disk", [False, True])
def test_tier_spill_read_pop_and_peek(tmp_path, on_disk):
    keys = np.arange(1, 101, dtype=np.uint64)
    got = []
    for tier in both_tiers(tmp_path, on_disk):
        tier.spill_rows(keys, rows_for(keys))
        assert len(tier) == 100 and tier.contains(keys).all()
        peek = tier.read(keys[10:20], pop=False)
        assert len(tier) == 100
        pop = tier.read(keys[:30], pop=True)
        assert len(tier) == 70 and not tier.contains(keys[:30]).any()
        with pytest.raises(KeyError):
            tier.read(keys[:1], pop=False)
        np.testing.assert_array_equal(peek[:, acc.SHOW], keys[10:20])
        got.append((peek, pop, np.sort(tier.live_keys())))
    for a, b in zip(*got):
        assert_bits_equal(a, b) if a.dtype == np.float32 else \
            np.testing.assert_array_equal(a, b)
    if on_disk:
        assert (len(os.listdir(tmp_path / "p"))
                == len(os.listdir(tmp_path / "j")) == 1)


def test_tier_batched_fault_in_groups_blocks(tmp_path):
    """One read spanning five blocks returns every row exactly, as the
    reference's does."""
    rng = np.random.RandomState(0)
    probe = rng.permutation(np.arange(1, 501, dtype=np.uint64))[:300]
    got = []
    for tier in both_tiers(tmp_path):
        for wave in range(5):
            keys = np.arange(wave * 100 + 1, wave * 100 + 101,
                             dtype=np.uint64)
            tier.spill_rows(keys, rows_for(keys, stamp=float(wave)))
        assert len(tier.block_files()) == 5
        got.append(tier.read(probe, pop=True))
        assert len(tier) == 200
    assert_bits_equal(*got)
    np.testing.assert_array_equal(got[0][:, acc.SHOW], probe)
    np.testing.assert_array_equal(got[0][:, acc.CLICK],
                                  ((probe - 1) // 100).astype(np.float32))


def test_stale_block_sweep_on_construction(tmp_path):
    """A reused ssd_dir sheds the blocks of a pid that no longer runs, and
    only those, as the reference's sweep does; a store's construction runs
    it."""
    dead = 0x3FFFFFFF     # beyond pid_max: no such process
    names = (f"spill_{dead:x}_ab_00000000.part", f"nspill_{dead:x}_ab_7.npy",
             f"spill_{dead:x}_ab_00000001.part.123.tmp",
             f"spill_{os.getpid():x}_cd_00000000.part", "unrelated.bin")
    left = {}
    for name, sweep in (("p", sweep_stale_blocks), ("j", jsweep_stale_blocks)):
        ssd = tmp_path / name
        ssd.mkdir()
        for n in names:
            (ssd / n).write_bytes(b"x")
        assert sweep(str(ssd)) == 3
        left[name] = sorted(os.listdir(ssd))
    assert left["p"] == left["j"] == sorted(names[3:])
    ssd = tmp_path / "p"
    (ssd / f"spill_{dead:x}_ab_00000002.part").write_bytes(b"x")
    HostEmbeddingStore(ValueLayout(D), table_cfg(ssd_dir=str(ssd)))
    assert not any(f"{dead:x}" in n for n in os.listdir(ssd))


def test_block_compaction_rewrites_and_gc(tmp_path):
    """A 5000-row block less than half alive is rewritten with its live
    rows (the raw bytes kept); an all-dead block is unlinked; the same
    file sizes and rows as the reference's."""
    keys = np.arange(1, 5001, dtype=np.uint64)
    sizes, reads = [], []
    for tier in both_tiers(tmp_path):
        tier.spill_rows(keys, rows_for(keys))
        first = tier.block_files()
        before = os.path.getsize(first[0])
        tier.read(keys[:3000], pop=True)        # 2000 of 5000 live
        second = tier.block_files()
        assert len(second) == 1 and second != first
        assert not os.path.exists(first[0])
        sizes.append((before, os.path.getsize(second[0])))
        reads.append(tier.read(keys[3000:], pop=False))
        tier.read(keys[3000:], pop=True)        # the block empties
        assert tier.block_files() == []
    assert sizes[0] == sizes[1] and sizes[0][1] < sizes[0][0] * 0.6
    assert_bits_equal(*reads)
    assert not os.listdir(tmp_path / "p")


def test_span_decay_applies_per_rebase_interval(tmp_path):
    """Missed days apply one span a rebase interval (in f32 decay**(a+b)
    is not decay**a * decay**b), in read and in snapshot, bit-equal to the
    reference."""
    keys = np.arange(1, 11, dtype=np.uint64)
    raw = rows_for(keys)
    raw[:, acc.SHOW] = 7.7
    raw[:, acc.CLICK] = 3.3
    expect = raw.copy()
    apply_missed_days(expect, np.float32(2.0), 0.98)
    apply_missed_days(expect, np.float32(3.0), 0.98)
    for tier in both_tiers(tmp_path, on_disk=False):
        tier.spill_rows(keys, raw.copy())
        tier.tick()
        tier.tick()
        tier.rebase()       # a full save's anchor
        for _ in range(3):
            tier.tick()
        assert_bits_equal(tier.read(keys, pop=False), expect)
        skeys, svals = tier.snapshot()
        assert_bits_equal(svals[np.argsort(skeys)], expect)


def test_sweep_kills_by_lazy_age_without_reading(tmp_path):
    keys = np.arange(1, 101, dtype=np.uint64)
    vals = rows_for(keys)
    vals[:40, acc.UNSEEN_DAYS] = 9.0
    for tier in both_tiers(tmp_path):
        tier.spill_rows(keys, vals)
        tier.tick()
        tier.tick()
        # dead iff unseen at spill + days slept > lifetime
        assert tier.sweep(10.0) == 40
        assert len(tier) == 60
        assert not tier.contains(keys[:40]).any()
        assert tier.contains(keys[40:]).all()


# --------------------------------------------------------------- the stores

def store_pair(kind, tmp_path, seed=3, **kw):
    port_cls, jax_cls = STORES[kind]
    return (port_cls(ValueLayout(D), table_cfg(
                ssd_dir=str(tmp_path / "p"), **kw), seed=seed),
            jax_cls(JLayout(D), jtable_cfg(
                ssd_dir=str(tmp_path / "j"), **kw), seed=seed))


def record_moves(store):
    moves = []
    store.set_journal_sink(lambda op, k: moves.append((op, np.array(k))))
    return moves


@pytest.mark.parametrize("kind", sorted(STORES))
def test_store_spill_and_fault_in_match_jax(kind, tmp_path):
    """The same calls on the port's store and the reference's of the same
    kind: spill by unseen days (ties among equal days), peek, prefetch
    fault-in, fault-in with creation, a second spill, the tier tick and
    the shrink sweep; the same rows, counters and MOVE records."""
    rng = np.random.RandomState(0)
    keys = np.unique(rng.randint(1, 1 << 40, 600).astype(np.uint64))
    unseen = rng.randint(0, 3, keys.size).astype(np.float32)
    shows = rng.randint(0, 20, keys.size).astype(np.float32)
    new = np.unique(np.concatenate([keys[::3], rng.randint(
        1 << 41, 1 << 42, 40).astype(np.uint64)]))
    out, moves = [], []
    for st in store_pair(kind, tmp_path):
        rows = st.lookup_or_create(keys)
        rows[:, acc.UNSEEN_DAYS] = unseen
        rows[:, acc.SHOW] = shows
        st.write_back(keys, rows)
        moves.append(record_moves(st))
        before = {n: stat_get(n) for n in (
            "sparse_keys_spilled", "sparse_keys_faulted_in",
            "sparse_keys_prefetch_faulted")}
        assert st.spill(250) == keys.size - 250
        assert len(st) == 250 and st.spilled_count() == keys.size - 250
        st.age_unseen_days()
        peek = st.lookup(keys[::7])
        assert st.spilled_count() == keys.size - 250
        sleeping = int(np.isin(keys[::5], st.spilled_keys()).sum())
        present, found = st.lookup_present(keys[::5])
        assert found.all() and sleeping > 0
        created = st.lookup_or_create(new)
        assert st.spill(300) > 0
        st.tick_spill_age()
        dead = st.shrink()
        out.append((peek, present, found, created, dead, union(st)))
        if isinstance(st, (HostEmbeddingStore, NativeHostEmbeddingStore)):
            got = {n: stat_get(n) - v for n, v in before.items()}
            assert got["sparse_keys_prefetch_faulted"] == sleeping
            for op, name in ((1, "sparse_keys_spilled"),
                             (2, "sparse_keys_faulted_in")):
                assert got[name] == sum(k.size for o, k in moves[0]
                                        if o == op)
    (pa, pb), (ja, jb) = out[0][5], out[1][5]
    np.testing.assert_array_equal(pa, ja)
    assert_bits_equal(pb, jb)
    for a, b in zip(out[0][:4], out[1][:4]):
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b)
        else:
            assert_bits_equal(a, b)
    assert out[0][4] == out[1][4]
    assert [op for op, _ in moves[0]] == [op for op, _ in moves[1]]
    for (_, a), (_, b) in zip(*moves):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", sorted(STORES))
def test_store_checkpoint_roundtrip_matches_jax(kind, tmp_path):
    """A save covers the tier's rows at their effective values (bit-equal
    to the reference's save); a load empties the tier."""
    keys = np.arange(1, 101, dtype=np.uint64)
    blobs = []
    for st in store_pair(kind, tmp_path):
        rows = st.lookup_or_create(keys)
        rows[:, acc.SHOW] = keys.astype(np.float32)
        rows[:30, acc.UNSEEN_DAYS] = 9.0
        st.write_back(keys, rows)
        assert st.spill(70) == 30
        st.tick_spill_age()
        path = str(tmp_path / ("ck-%s.pkl" % type(st).__module__))
        st.save(path)
        blobs.append(union(st))
        st.load(path)
        assert len(st) == 100 and st.spilled_count() == 0
        assert_unions_equal(st, st)
        k, v = union(st)
        np.testing.assert_array_equal(k, blobs[-1][0])
        assert_bits_equal(v, blobs[-1][1])
    np.testing.assert_array_equal(blobs[0][0], blobs[1][0])
    assert_bits_equal(blobs[0][1], blobs[1][1])
    # the 30 that slept a day came back with it
    assert (blobs[0][1][:30, acc.UNSEEN_DAYS] == 10.0).all()


@pytest.mark.parametrize("kind", sorted(STORES))
def test_store_spills_in_waves_then_loads_back(kind, tmp_path):
    """20,000 rows against a 6,000-row budget in four waves, then
    LoadSSD2Mem: every row reads back (peeked) and promotes, as in the
    reference."""
    pair = store_pair(kind, tmp_path)
    for st in pair:
        for wave in range(4):
            keys = np.arange(wave * 5000, (wave + 1) * 5000,
                             dtype=np.uint64) + np.uint64(1)
            rows = st.lookup_or_create(keys)
            rows[:, acc.SHOW] = keys.astype(np.float32)
            rows[:, acc.UNSEEN_DAYS] = float(10 - wave)
            st.write_back(keys, rows)
            st.spill(6000)
            assert len(st) <= 6000
        assert len(st) + st.spilled_count() == 20000
    probe = np.random.RandomState(0).randint(1, 20001, 500).astype(np.uint64)
    assert_bits_equal(pair[0].lookup(probe), pair[1].lookup(probe))
    assert_unions_equal(*pair)
    for st in pair:
        assert st.load_spilled() == 14000
        assert len(st) == 20000 and st.spilled_count() == 0
    assert_unions_equal(*pair)


def test_spill_needs_a_directory_and_a_budget(tmp_path):
    """No ssd_dir: spill moves nothing; ssd_dir without a budget: the pass
    table's limiter spills nothing (as the reference's)."""
    st = HostEmbeddingStore(ValueLayout(D), table_cfg())
    st.lookup_or_create(np.arange(1, 101, dtype=np.uint64))
    assert st.spill(10) == 0 and len(st) == 100
    for mb, want in ((0, None), (budget_mb(50), 50)):
        cfg = table_cfg(ssd_dir=str(tmp_path / "s"), ssd_threshold_mb=mb)
        jcfg = jtable_cfg(ssd_dir=str(tmp_path / "s"), ssd_threshold_mb=mb)
        assert cfg.ssd_max_resident_rows(WIDTH) == want
        assert jcfg.ssd_max_resident_rows(WIDTH) == want
    assert table_cfg(ssd_dir="x", ssd_threshold_mb=1e-3) \
        .ssd_max_resident_rows(WIDTH) == int(1e-3 * (1 << 20)) // (WIDTH * 4)


def _fed(t, keys):
    t.begin_feed_pass()
    t.add_keys(keys)
    t.end_feed_pass()


def test_pass_table_limiter_spills_and_rebuilds(tmp_path):
    """end_pass spills the store down to its budget and drops the
    residency, so the next pass builds in full and faults its rows back;
    the second pass's rows equal an untiered table's."""
    keys = np.arange(1, 2001, dtype=np.uint64) * 7
    tables = [PassTable(table_cfg(cap=4096, ssd_dir=str(tmp_path / "s"),
                                  ssd_threshold_mb=budget_mb(500)),
                        device="cpu"),
              PassTable(table_cfg(cap=4096), device="cpu")]
    for t in tables:
        _fed(t, keys)
        t.begin_pass()
        t.end_pass()
    tiered, plain = tables
    assert len(tiered.store) == 500
    assert tiered.store.spilled_count() == 1500
    assert tiered.resident_slab is None and plain.resident_slab is not None
    assert tiered.seconds["spill"] > 0
    before = stat_get("sparse_keys_faulted_in")
    for t in tables:
        _fed(t, keys[::2])
        t.begin_pass()
        assert_bits_equal(t.slab[:keys[::2].size].numpy(),
                          tables[1].slab[:keys[::2].size].numpy())
        t.end_pass()
    assert tiered.counters["pass_rows_promote_hit"] == 0
    assert plain.counters["pass_rows_promote_hit"] == 1000
    assert stat_get("sparse_keys_faulted_in") - before > 0
    assert_unions_equal(tiered.store, plain.store)
    # the day tick and the full warm-up
    for t in tables:
        t.end_day(age=False)
    assert tiered.load_ssd_to_mem() > 0 and plain.load_ssd_to_mem() == 0
    assert tiered.store.spilled_count() == 0


# ---------------------------------------------------------- striped store

def test_stripe_of_matches_jax():
    keys = np.random.RandomState(0).randint(0, 1 << 62, 5000).astype(
        np.uint64)
    for n in (1, 3, 4, 16):
        np.testing.assert_array_equal(stripe_of(keys, n), jstripe_of(keys, n))


def test_striped_store_matches_jax(tmp_path):
    """Four stripes over native stores (seed + stripe), the same calls on
    the port's and the reference's: the same rows, spill per stripe by
    budget, fault-in, save and load."""
    port = StripedHostStore(ValueLayout(D), table_cfg(
        ssd_dir=str(tmp_path / "p")), seed=5, stripes=4)
    ref = JStriped(JLayout(D), jtable_cfg(ssd_dir=str(tmp_path / "j")),
                   seed=5, stripes=4)
    assert all(isinstance(s, NativeHostEmbeddingStore) for s in port.stores)
    rng = np.random.RandomState(1)
    keys = np.unique(rng.randint(1, 1 << 40, 3000).astype(np.uint64))
    unseen = rng.randint(0, 4, keys.size).astype(np.float32)
    for st in (port, ref):
        rows = st.lookup_or_create(keys)
        rows[:, acc.UNSEEN_DAYS] = unseen
        st.write_back(keys, rows)
        assert st.spill(1001) == keys.size - 1001
        assert [len(s) for s in st.stores] == [251, 250, 250, 250]
        st.age_unseen_days()
    assert_bits_equal(port.lookup(keys[::3]), ref.lookup(keys[::3]))
    got = [st.lookup_present(keys[::4]) for st in (port, ref)]
    np.testing.assert_array_equal(got[0][1], got[1][1])
    assert_bits_equal(got[0][0], got[1][0])
    new = np.unique(np.concatenate([keys[::5], np.arange(
        7, 300, 7, dtype=np.uint64)]))
    assert_bits_equal(port.lookup_or_create(new), ref.lookup_or_create(new))
    for st in (port, ref):
        st.tick_spill_age()
        st.shrink()
    assert_unions_equal(port, ref)
    path = str(tmp_path / "ck")
    port.save(path)
    flat = NativeHostEmbeddingStore(ValueLayout(D), table_cfg(), seed=0)
    flat.load(path)
    assert_unions_equal(flat, ref)
    port.load(path)
    assert port.spilled_count() == 0
    assert_unions_equal(port, ref)
    port.close()


def test_pass_table_makes_the_striped_store(tmp_path):
    """PassFlags.host_store_stripes > 0 gives the table a striped store,
    whose random state a trainer saves and restores."""
    t = PassTable(table_cfg(), device="cpu",
                  flags=PassFlags(host_store_stripes=3))
    assert isinstance(t.store, StripedHostStore) and t.store.n_stripes == 3
    keys = np.arange(1, 300, dtype=np.uint64)
    state = t.store._rng.get_state()
    a = t.store.lookup_or_create(keys)
    t.store._rng.set_state(state)
    t.store.load_blob({"keys": keys[:0], "values": a[:0],
                       "embedx_dim": D, "optimizer": "adagrad"})
    assert_bits_equal(t.store.lookup_or_create(keys), a)
    t.store.close()


# ------------------------------------------- the journal and the checkpoint

def drive_pass(table, keys, scale=0.05):
    """One train pass over ``keys``: half of them looked up, their slab
    rows edited as a push would, then the touched write-back (and the
    limiter's spill)."""
    _fed(table, keys)
    table.begin_pass()
    sub = keys[:max(1, keys.size // 2)]
    ids = torch.from_numpy(np.unique(table.lookup_ids(sub)).astype(np.int64))
    with torch.no_grad():
        slab = table.slab
        slab[ids, acc.SHOW] += 1.0
        slab[ids, acc.CLICK] += (ids % 2).to(torch.float32)
        slab[ids, acc.DELTA_SCORE] += 0.5
        slab[ids, acc.EMBED_W] += scale
        slab[ids, acc.UNSEEN_DAYS] = 0.0
    table.end_pass()


def mk_cm(tmp_path, table, **flags):
    return pckpt.CheckpointManager(
        CheckpointConfig(batch_model_dir=str(tmp_path / "batch"),
                         xbox_model_dir=str(tmp_path / "xbox"),
                         async_save=False), table, CkptFlags(**flags))


@pytest.mark.parametrize("anchor", ["before_spill", "over_spilled_rows"])
def test_touched_save_bit_parity_across_spill_and_tick(tmp_path, anchor):
    """Full anchor, spills (the limiter's and by hand), day ticks, passes
    that fault rows back, a touched save: its replay over the base equals
    the live store, resident and tier rows, bit for bit, in the port and
    in the reference's load_base. With the anchor over spilled rows, the
    epoch opens with their MV_SPILL and the tier's span rebase."""
    over = anchor == "over_spilled_rows"
    t = PassTable(table_cfg(ssd_dir=str(tmp_path / "ssd"),
                            ssd_threshold_mb=budget_mb(300 if over else 900)),
                  seed=13, device="cpu")
    cm = mk_cm(tmp_path, t)
    keys = np.arange(1, 400, dtype=np.uint64) * 17
    drive_pass(t, keys)
    if over:
        with t.store_lock:
            t.store.spill(100)
        t.end_day(age=False)
    full = union(t.store)       # a base holds the store before its rewrite
    cm.save_base({}, {}, day="d0")
    assert (t.store.spilled_count() > 0) == over
    with t.store_lock:
        t.store.spill(60)
    t.end_day(age=False)
    drive_pass(t, keys[::3])
    t.end_day(age=True)
    drive_pass(t, keys[::5])
    assert cm.journal.snapshot_ready()
    live = union(t.store)
    assert t.store.spilled_count() > 0
    bdir, _ = cm.save_base({}, {}, day="d1", mode="touched")
    assert cks_mode(bdir) == "journal"
    t2 = PassTable(table_cfg(), seed=77, device="cpu")
    mk_cm(tmp_path, t2, ckpt_journal=False).load_base("d1")
    k, v = union(t2.store)
    np.testing.assert_array_equal(k, live[0])
    assert_bits_equal(v, live[1])
    # the full base too, and the reference reads the port's snapshot
    jflags.set_flag("ckpt_journal", False)
    jflags.set_flag("flatten_dense_opt", False)
    from paddlebox_tpu.config.configs import CheckpointConfig as JCkptCfg
    from paddlebox_tpu.embedding.pass_table import PassTable as JPassTable
    from paddlebox_tpu.train import checkpoint as jckpt
    for day, want in (("d0", full), ("d1", live)):
        jt = JPassTable(jtable_cfg(), seed=77)
        jckpt.CheckpointManager(JCkptCfg(
            batch_model_dir=str(tmp_path / "batch"),
            xbox_model_dir=str(tmp_path / "xbox"), async_save=False),
            jt).load_base(day)
        k, v = union(jt.store)
        np.testing.assert_array_equal(k, want[0])
        assert_bits_equal(v, want[1])


def cks_mode(batch_dir):
    from paddlebox_tpu_torch.embedding import ckpt_store as cks
    return cks.read_manifest(os.path.join(batch_dir,
                                          pckpt.SPARSE_MANIFEST)).get("mode")


def test_replay_scratch_never_touches_live_ssd_dir(tmp_path):
    """reconstruct_blob's scratch store keeps its tier in memory: a
    replayed MV_SPILL writes no block, and the live directory's blocks
    are untouched."""
    ssd = tmp_path / "ssd"
    t = PassTable(table_cfg(ssd_dir=str(ssd), ssd_threshold_mb=budget_mb(50)),
                  seed=1, device="cpu")
    cm = mk_cm(tmp_path, t)
    keys = np.arange(1, 200, dtype=np.uint64)
    drive_pass(t, keys)
    cm.save_base({}, {}, day="d0")
    drive_pass(t, keys[::2])
    blocks = sorted(os.listdir(ssd))
    assert blocks
    stamps = {n: os.path.getmtime(ssd / n) for n in blocks}
    live = union(t.store)
    cm.save_base({}, {}, day="d1", mode="touched")
    t2 = PassTable(table_cfg(), seed=2, device="cpu")
    mk_cm(tmp_path, t2, ckpt_journal=False).load_base("d1")
    assert sorted(os.listdir(ssd)) == blocks
    assert {n: os.path.getmtime(ssd / n) for n in blocks} == stamps
    k, v = union(t2.store)
    np.testing.assert_array_equal(k, live[0])
    assert_bits_equal(v, live[1])


# ------------------------------------------------------------- the trainer

@pytest.fixture(scope="module")
def cadence_files(tmp_path_factory):
    """write_cadence at a narrow replace of FLAGSHIP (as
    tests/test_torch_incremental.py writes it): three passes of about
    1,200 keys."""
    cfg = dataclasses.replace(
        flagship.FLAGSHIP, num_slots=4, batch=32, max_len=3, hidden=(16, 8),
        capacity=4096, num_files=4, lines_per_file=96, vocab_per_slot=400,
        data_seed=7)
    windows, feed = flagship.write_cadence(
        str(tmp_path_factory.mktemp("tier_cadence")), cfg)
    return cfg, windows, feed


TIER_STATS = ("sparse_keys_spilled", "sparse_keys_faulted_in",
              "sparse_keys_prefetch_faulted")


def _tier_run(cfg, windows, feed, mode):
    """One cadence run; each pass's record gains the store (resident and
    tier rows, sorted) and the tier's stat deltas."""
    last = {n: stat_get(n) for n in TIER_STATS}

    def on_pass(trainer, rec):
        rec["store"] = union(trainer.table.store)
        rec["stats"] = {n: stat_get(n) - last[n] for n in TIER_STATS}
        last.update({n: stat_get(n) for n in TIER_STATS})

    return cadence_probe.run_cadence(mode, windows, feed, cfg, "cpu",
                                     on_pass=on_pass)


@pytest.mark.parametrize("mode", ["a", "b"])
def test_tiered_cadence_equals_untiered_full_rebuild(cadence_files,
                                                     tmp_path, mode):
    """FLAGSHIP_SSD's shape in small: the cadence with a 300-row budget,
    sequential (b) and preloaded with the prefetcher (a), against the
    untiered full rebuild (c): losses, AUC and the store after every pass
    bit-identical; spills and fault-ins from pass 2 (prefetched ones in
    (a)); block files on disk. Then a test pass over the last window, the
    day tick and LoadSSD2Mem."""
    cfg, windows, feed = cadence_files
    tiered = dataclasses.replace(cfg, ssd_dir=str(tmp_path / "ssd"),
                                 ssd_threshold_mb=budget_mb(300, 17))
    t_tier, got = _tier_run(tiered, windows, feed, mode)
    t_full, want = _tier_run(cfg, windows, feed, "c")
    for i, (p, q) in enumerate(zip(got["passes"], want["passes"],
                                   strict=True)):
        assert (p["loss"], p["auc"]) == (q["loss"], q["auc"]), i
        np.testing.assert_array_equal(p["store"][0], q["store"][0])
        assert_bits_equal(p["store"][1], q["store"][1])
        assert p["stats"]["sparse_keys_spilled"] > 0
        assert (p["stats"]["sparse_keys_faulted_in"] > 0) == (i > 0)
        assert not any(q["stats"].values())
    # the prefetcher faults the next pass's sleeping rows in while a pass
    # trains
    assert (sum(p["stats"]["sparse_keys_prefetch_faulted"]
                for p in got["passes"]) > 0) == (mode == "a")
    assert len(t_tier.table.store) <= 300
    assert os.listdir(tmp_path / "ssd")
    # the test pass reads the tier's rows by peeking
    ds = [BoxDataset(feed) for _ in range(2)]
    preds = []
    for t, d in zip((t_tier, t_full), ds):
        d.set_filelist(windows[2])
        d.load_into_memory()
        preds.append(t.predict_batches(d))
    assert_bits_equal(preds[0][0], preds[1][0])
    spilled = t_tier.table.store.spilled_count()
    assert spilled > 0
    # the day tick: the tier's rows age lazily and come back at LoadSSD2Mem
    for t in (t_tier, t_full):
        t.table.end_day(age=True)
    assert t_tier.table.load_ssd_to_mem() > 0
    assert t_tier.table.store.spilled_count() == 0
    (tk, tv), (fk, fv) = union(t_tier.table.store), union(t_full.table.store)
    # every row the untiered day kept, bit for bit; the tier's sweep applies
    # only the unseen-days rule (the reference's), so spilled rows the
    # untiered shrink deleted by their score are back, decayed
    pos = np.searchsorted(tk, fk)
    np.testing.assert_array_equal(tk[pos], fk)
    assert_bits_equal(tv[pos], fv)
    extra = np.ones(tk.size, bool)
    extra[pos] = False
    score = ValueLayout(8).show_click_score(tv[extra, acc.SHOW],
                                            tv[extra, acc.CLICK],
                                            tiered.table().optimizer)
    assert (score < tiered.table().delete_threshold).all()
    assert extra.sum() <= spilled
    for t in (t_tier, t_full):
        t.close()


@pytest.fixture(scope="module")
def window_data(tmp_path_factory):
    """Four files; passes over files [0, 1], [1, 2] and [2, 3]."""
    out = tmp_path_factory.mktemp("tier_window_data")
    files, feed = write_synthetic_ctr_files(
        str(out), num_files=4, lines_per_file=96, num_slots=4,
        vocab_per_slot=60, max_len=3, seed=17)
    jfeed = type(feed)(slots=feed.slots, batch_size=32)
    pfeed = DataFeedConfig(
        slots=tuple(SlotConfig(s.name, s.type, s.is_used, s.max_len)
                    for s in feed.slots), batch_size=32)
    return [files[p:p + 2] for p in range(3)], jfeed, pfeed


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX trainer with use_pallas_push, its kernel interpreted on the
    CPU (as tests/test_torch_train.py wires it)."""
    import paddlebox_tpu.embedding.pallas_push as pp
    jflags.set_flag("use_pallas_push", True)
    monkeypatch.setattr(pp, "pallas_apply_push",
                        functools.partial(pp.pallas_apply_push,
                                          interpret=True))


def jax_pass_seeds(table_key, n_steps):
    """(one train_pass's per-step push seeds, the next table key), as the
    JAX trainer draws them (trainer.py:725, optimizers.py:238)."""
    table_key, prng = jax.random.split(table_key)
    seeds = []
    for _ in range(n_steps):
        prng, sub = jax.random.split(prng)
        seeds.append(int(jax.random.randint(sub, (), 0,
                                            jnp.int32(2**31 - 1))))
    return seeds, table_key


def test_tiered_window_passes_match_jax(window_data, pallas_interpret,
                                        tmp_path):
    """Three window passes of the port's BoxTrainer and the JAX one, each
    over a native store with the same 100-row budget: every end_pass
    spills, every begin_pass faults rows back."""
    windows, jfeed, pfeed = window_data
    mb = budget_mb(100, 17)
    jt = JTrainer(JDeepFM(JSpec(num_slots=4, slot_dim=3 + 8),
                          hidden=(16, 8)),
                  JTable(embedx_dim=8, pass_capacity=CAP,
                         optimizer=JSparse(**OPT),
                         ssd_dir=str(tmp_path / "j"), ssd_threshold_mb=mb),
                  jfeed, JTrainerCfg(dense_lr=5e-3), seed=0)
    model = DeepFM(ModelSpec(num_slots=4, slot_dim=3 + 8), hidden=(16, 8))
    model.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in jt.params.items()}))
    pt = BoxTrainer(model, table_cfg(d=8, ssd_dir=str(tmp_path / "p"),
                                     ssd_threshold_mb=mb),
                    pfeed, TrainerConfig(dense_lr=5e-3), seed=0,
                    flags=PushFlags("scatter", 64), device="cpu")
    for t in (jt, pt):
        t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    key = jax.random.PRNGKey(0)
    before = stat_get("sparse_keys_faulted_in")
    for p, files in enumerate(windows):
        jds = JDataset(jfeed, read_threads=1, columnar=False)
        pds = BoxDataset(pfeed)
        jds.set_filelist(files)
        pds.set_filelist(files)
        seeds, key = jax_pass_seeds(key, (2 * 96 + 31) // 32)
        pt.seed_fn = iter(seeds).__next__
        want, got = jt.train_pass(jds)["loss"], pt.train_pass(pds)["loss"]
        np.testing.assert_allclose(got, want, rtol=1e-4)
        ja = jt.metrics.get_metric_msg("auc")["auc"]
        pa = pt.metrics.get_metric_msg("auc")["auc"]
        assert abs(pa - ja) <= 1e-4, (p, pa, ja)
        assert len(pt.table.store) == len(jt.table.store) == 100
    assert stat_get("sparse_keys_faulted_in") > before
    assert pt.table.store.spilled_count() == jt.table.store.spilled_count()
    (pk, pv), (jk, jv) = union(pt.table.store), union(jt.table.store)
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_array_equal(pv[:, INT_COLS], jv[:, INT_COLS])
    np.testing.assert_allclose(pv, jv, rtol=1e-4, atol=1e-7)
    pt.close()
