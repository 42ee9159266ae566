"""The port's sharding policies against the JAX package's, unit by unit.

Each policy's routing (shard_of, table_of) and identity (describe) at
P = 1, 2, 4 and 8 on the same seeded keys; resolve_sharding_policy's
aliases, its automatic grid rows and its errors (the reference reading
its flag registry, the port ShardFlags); FreqSketch bit for bit (observe
past its cap, items, summed over parts in any order, hot_keys);
freeze_hot's per-shard local ids and its hot_cap error; partition_pull;
ReplicatedHotTier over stores of the same contents; the native router
(rt_bucketize_sharded) against its numpy twin under each policy; the
hot-filtered exchange_push_uids_p2p against the reference's at P = 2
and 4 (uids and wire bytes), with the real-id counts of the unfiltered
columns; and a checkpoint written under one policy loaded under another.
"""

import itertools

import numpy as np
import pytest

from paddlebox_tpu_torch.config.configs import (SparseOptimizerConfig,
                                                TableConfig)
from paddlebox_tpu_torch.config.flags import ShardFlags
from paddlebox_tpu_torch.embedding.accessor import ValueLayout
from paddlebox_tpu_torch.embedding.native_store import \
    NativeHostEmbeddingStore
from paddlebox_tpu_torch.parallel import sharding
from paddlebox_tpu_torch.parallel.sharded_table import (
    ShardedPassTable, bucketize_plain, exchange_push_uids_p2p)
from paddlebox_tpu_torch.utils import stats as pstats
from sharded_cluster import threaded_exchange

PS = [1, 2, 4, 8]


def grid_keys(seed, n=2048, tables=8, shift=48):
    """Feasigns with a table id in the high bits and random low bits."""
    rng = np.random.RandomState(seed)
    t = rng.randint(0, tables, n).astype(np.uint64)
    low = rng.randint(0, 1 << 30, n).astype(np.uint64)
    keys = np.unique((t << np.uint64(shift)) | low)
    keys[-1] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return np.unique(keys)


def both(P, kind, **kw):
    """(port policy, reference policy) of ``kind`` at P shards."""
    from paddlebox_tpu.parallel import sharding as jsharding
    if kind == "key-mod":
        return sharding.KeyModPolicy(P), jsharding.KeyModPolicy(P)
    if kind == "table-wise":
        return (sharding.TableWisePolicy(P, **kw),
                jsharding.TableWisePolicy(P, **kw))
    return (sharding.TwoDGridPolicy(P, **kw),
            jsharding.TwoDGridPolicy(P, **kw))


def grid_rows(P):
    return [r for r in range(1, P + 1) if P % r == 0]


POLICY_CASES = ([("key-mod", {})]
                + [("table-wise", dict(num_tables=t, table_shift=s))
                   for t, s in ((64, 48), (7, 0), (13, 3))]
                + [("2d-grid", dict(num_tables=t, rows=r, table_shift=s,
                                    hot_threshold=h, hot_cap=c))
                   for t, r, s, h, c in ((64, 1, 48, 0, 1024),
                                         (7, 2, 0, 3, 64),
                                         (16, 4, 2, 5, 9),
                                         (9, 8, 0, 1, 1))])


@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("kind,kw", POLICY_CASES,
                         ids=["%s-%d" % (k, i) for i, (k, _) in
                              enumerate(POLICY_CASES)])
def test_routing_and_identity_match_the_reference(P, kind, kw):
    if kind == "2d-grid" and P % kw["rows"]:
        kw = dict(kw, rows=grid_rows(P)[-1])
    keys = np.concatenate([grid_keys(P, shift=kw.get("table_shift", 48)),
                           np.arange(64, dtype=np.uint64)])
    port, ref = both(P, kind, **kw)
    got = port.shard_of(keys)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, ref.shard_of(keys))
    assert got.min() >= 0 and got.max() < P
    if kind != "key-mod":
        np.testing.assert_array_equal(port.table_of(keys),
                                      ref.table_of(keys))
    assert port.describe() == ref.describe()
    assert port.native_keymod == ref.native_keymod
    assert port.wants_observe == ref.wants_observe


# the ShardFlags fields that resolve_sharding_policy reads, by case
RESOLVE_CASES = [
    dict(sharding_policy=name, sharding_num_tables=t,
         sharding_table_shift=s, sharding_grid_rows=r,
         sharding_hot_threshold=h, sharding_hot_cap=c)
    for name, t, s, r, h, c in (
        ("key-mod", 64, 48, 0, 0, 1024), ("keymod", 5, 0, 0, 0, 1024),
        ("key_mod", 64, 48, 2, 0, 1024),
        ("table-wise", 64, 48, 0, 0, 1024), ("tablewise", 7, 0, 0, 0, 1024),
        ("Table_Wise", 3, 5, 0, 0, 1024),
        ("2d-grid", 64, 48, 0, 0, 1024), ("2d_grid", 7, 0, 0, 4, 77),
        ("2dgrid", 9, 3, 0, 2, 5), (" grid ", 11, 1, 0, 0, 1024))]


@pytest.mark.parametrize("P", [1, 2, 3, 4, 6, 8, 9, 12, 16])
@pytest.mark.parametrize("case", RESOLVE_CASES,
                         ids=[c["sharding_policy"].strip()
                              for c in RESOLVE_CASES])
def test_resolve_matches_the_reference(P, case):
    """Every alias, the automatic grid rows (the largest divisor of P not
    above sqrt(P)) and the flags' parameters: the same describe()."""
    from paddlebox_tpu.config import flags as jflags
    from paddlebox_tpu.parallel.sharding import \
        resolve_sharding_policy as jresolve
    old = {k: jflags.get_flag(k) for k in case}
    try:
        for k, v in case.items():
            jflags.set_flag(k, v)
        want = jresolve(P)
    finally:
        for k, v in old.items():
            jflags.set_flag(k, v)
    got = sharding.resolve_sharding_policy(P, flags=ShardFlags(**case))
    assert type(got).__name__ == type(want).__name__
    assert got.describe() == want.describe()
    if isinstance(got, sharding.TwoDGridPolicy):
        assert got.rows == want.rows == sharding.grid_rows_auto(P)
    # the name argument wins over the flags' policy
    assert sharding.resolve_sharding_policy(
        P, "key-mod", flags=ShardFlags(**case)).name == "key-mod"


def test_resolve_errors_match_the_reference():
    from paddlebox_tpu.parallel import sharding as jsharding
    with pytest.raises(ValueError, match="sharding_policy must be"):
        sharding.resolve_sharding_policy(4, "nope")
    with pytest.raises(ValueError, match="sharding_policy must be"):
        jsharding.resolve_sharding_policy(4, "nope")
    for mod in (sharding, jsharding):
        with pytest.raises(ValueError, match="divide"):
            mod.TwoDGridPolicy(8, 8, rows=3)
        with pytest.raises(ValueError, match="num_tables"):
            mod.TableWisePolicy(4, 0)
        with pytest.raises(ValueError, match="table_shift"):
            mod.TableWisePolicy(4, 4, table_shift=64)
        with pytest.raises(ValueError, match="num_shards"):
            mod.KeyModPolicy(0)
    with pytest.raises(ValueError, match="divide"):
        sharding.resolve_sharding_policy(
            8, "2d-grid", flags=ShardFlags(sharding_grid_rows=3))


# ------------------------------------------------------------ FreqSketch

def sketch_stream(seed, n_calls=12, vocab=600, size=300):
    rng = np.random.RandomState(seed)
    head = rng.randint(0, vocab, 8).astype(np.uint64)
    for _ in range(n_calls):
        tail = rng.randint(0, vocab, size).astype(np.uint64)
        yield np.concatenate([tail, np.repeat(head, rng.randint(1, 6))])


def sketch_state(sk):
    ks, cs = sk.items()
    o = np.argsort(ks)
    return ks[o], cs[o]


@pytest.mark.parametrize("cap", [16, 200, 1 << 16])
def test_freq_sketch_matches_the_reference(cap):
    """observe past the cap (every count halves, the zeros drop), items,
    hot_keys at several thresholds: bit for bit."""
    from paddlebox_tpu.parallel.sharding import FreqSketch as JSketch
    port, ref = sharding.FreqSketch(cap), JSketch(cap)
    for chunk in sketch_stream(cap):
        port.observe(chunk)
        ref.observe(chunk)
        for a, b in zip(sketch_state(port), sketch_state(ref)):
            np.testing.assert_array_equal(a, b)
    port.observe(np.empty(0, np.uint64))
    for th in (0, 1, 2, 5, 9, 40):
        got = port.hot_keys(th)
        assert got.dtype == np.uint64
        np.testing.assert_array_equal(got, ref.hot_keys(th))


def test_freq_sketch_summed_in_any_order_matches_the_reference():
    """summed over three ranks' snapshots: the same sketch in every part
    order, equal to the reference's, the inputs untouched, truncated to
    the heaviest cap entries (count descending, key ascending)."""
    from paddlebox_tpu.parallel.sharding import FreqSketch as JSketch
    parts = []
    for r in range(3):
        sk = sharding.FreqSketch(1 << 16)
        for chunk in sketch_stream(100 + r, n_calls=4):
            sk.observe(chunk)
        parts.append(sk.items())
    frozen = [(k.copy(), c.copy()) for k, c in parts]
    for cap in (1 << 16, 50, 7):
        want = sketch_state(JSketch.summed(parts, cap))
        for order in itertools.permutations(range(3)):
            got = sharding.FreqSketch.summed([parts[i] for i in order], cap)
            assert got.cap == cap
            for a, b in zip(sketch_state(got), want):
                np.testing.assert_array_equal(a, b)
    for (k, c), (k0, c0) in zip(parts, frozen):
        np.testing.assert_array_equal(k, k0)
        np.testing.assert_array_equal(c, c0)


# ------------------------------------------------------------- hot tier

def frozen_pair(P, rows, threshold, cap=1024, seed=3):
    """(port, reference) 2-D grid policies observing the same skewed
    stream and frozen against the same shard key lists."""
    # (the all-ones key, the native store's empty mark, left out)
    keys = grid_keys(seed, n=1024, tables=8, shift=0)[:-1]
    port, ref = both(P, "2d-grid", num_tables=8, rows=rows, table_shift=0,
                     hot_threshold=threshold, hot_cap=cap)
    rng = np.random.RandomState(seed)
    hot = rng.choice(keys, 40, replace=False)
    for _ in range(5):
        chunk = np.concatenate([hot, rng.choice(keys, 200)])
        port.observe(chunk)
        ref.observe(chunk)
    shard = port.shard_of(keys)
    shard_keys = [keys[shard == s] for s in range(P)]
    return port, ref, shard_keys, keys


@pytest.mark.parametrize("P,rows", [(1, 1), (2, 1), (4, 2), (8, 2)])
@pytest.mark.parametrize("threshold", [0, 3, 5])
def test_freeze_hot_matches_the_reference(P, rows, threshold):
    port, ref, shard_keys, _ = frozen_pair(P, rows, threshold)
    port.freeze_hot(shard_keys)
    ref.freeze_hot(shard_keys)
    np.testing.assert_array_equal(port.hot_keys_frozen(),
                                  ref.hot_keys_frozen())
    assert (port.hot_keys_frozen().size > 0) == (threshold > 0)
    for d in range(P):
        a, b = port.hot_local_ids(d), ref.hot_local_ids(d)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)
            assert (np.diff(a.astype(np.int64)) > 0).all()
            np.testing.assert_array_equal(
                shard_keys[d][a], port.hot_keys_frozen()[
                    port.shard_of(port.hot_keys_frozen()) == d])


def test_merge_observations_sums_the_ranks_as_the_reference():
    """Two ranks' sketches summed over an all_gather: a key hot only in
    the sum freezes on both, the local sketches keep their own history,
    and the frozen sets equal the reference's."""
    from paddlebox_tpu.parallel import sharding as jsharding
    keys = grid_keys(9, n=256, shift=0)
    hot = keys[7:8]
    streams = [[np.concatenate([hot, hot, keys[:64]]), keys[64:128]],
               [np.concatenate([hot, hot, keys[128:]]), keys[:32]]]
    out = {}
    for mod in (sharding, jsharding):
        pols = [mod.TwoDGridPolicy(4, 8, 2, table_shift=0, hot_threshold=4)
                for _ in range(2)]
        for pol, stream in zip(pols, streams):
            for chunk in stream:
                pol.observe(chunk)
        payloads = [None, None]

        def gather(p, payloads=payloads):
            return [pp for pp in payloads]

        for r, pol in enumerate(pols):
            ks, cs = pol.sketch.items()
            payloads[r] = np.concatenate([np.array([ks.size], np.uint64), ks,
                                          cs.view(np.uint64)])
        shard = pols[0].shard_of(keys)
        for pol in pols:
            pol.merge_observations(gather)
            pol.freeze_hot([keys[shard == s] for s in range(4)])
        out[mod.__name__] = [p.hot_keys_frozen() for p in pols]
        assert hot[0] in out[mod.__name__][0].tolist()
        assert pols[0].sketch.items()[1].max() < 4
    a, b = out.values()
    for x, y in zip(a + b, a[:1] * 4):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mod", ["port", "reference"])
def test_hot_cap_raises(mod):
    if mod == "port":
        m = sharding
    else:
        from paddlebox_tpu.parallel import sharding as m
    pol = m.TwoDGridPolicy(8, 8, 2, hot_threshold=1, hot_cap=2)
    keys = np.arange(64, dtype=np.uint64) * np.uint64(8)
    pol.observe(keys)
    with pytest.raises(ValueError, match="sharding_hot_cap=2"):
        pol.freeze_hot([np.sort(keys)] + [np.empty(0, np.uint64)] * 7)


@pytest.mark.parametrize("kind", ["key-mod", "table-wise", "2d-grid"])
@pytest.mark.parametrize("hot_dest", [0, 3, 13])
def test_partition_pull_matches_the_reference(kind, hot_dest):
    from paddlebox_tpu.parallel.sharding import partition_pull as jpart
    kw = {"table-wise": dict(num_tables=7, table_shift=0),
          "2d-grid": dict(num_tables=7, rows=2, table_shift=0)}.get(kind, {})
    port, ref = both(4, kind, **kw)
    rng = np.random.RandomState(hot_dest)
    keys = rng.randint(0, 5000, 700).astype(np.uint64)
    hot = np.unique(rng.choice(keys, 30))
    for hk in (None, hot, np.empty(0, np.uint64)):
        got = sharding.partition_pull(port, keys, hk, hot_dest)
        want = jpart(ref, keys, hk, hot_dest)
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.sort(np.concatenate(got)),
                                      np.arange(keys.size))


class DictStore:
    """A store's lookup over a dict of rows (the reference's tier and the
    port's read the same contents)."""

    def __init__(self, rows):
        self.rows = rows

    def lookup(self, keys):
        return np.stack([self.rows[int(k)] for k in keys])


def test_replicated_hot_tier_matches_the_reference_and_the_store():
    """refresh over the owners' stores, then lookup: the reference's
    rows and found mask, and bit for bit the rows of store.lookup; None
    stores skip their shards."""
    from paddlebox_tpu.parallel.sharding import \
        ReplicatedHotTier as JTier
    P = 4
    port, ref, shard_keys, keys = frozen_pair(P, 2, 3)
    port.freeze_hot(shard_keys)
    ref.freeze_hot(shard_keys)
    table = TableConfig(embedx_dim=4, pass_capacity=4096,
                        optimizer=SparseOptimizerConfig())
    layout = ValueLayout(4)
    rng = np.random.RandomState(5)
    stores = []
    for s in range(P):
        st = NativeHostEmbeddingStore(layout, table, seed=s)
        st.load_blob({"keys": shard_keys[s],
                      "values": rng.randn(shard_keys[s].size,
                                          layout.width).astype(np.float32),
                      "embedx_dim": 4, "optimizer": layout.optimizer})
        stores.append(st)
    dict_stores = [DictStore({int(k): v for k, v in zip(
        shard_keys[s], st.lookup(shard_keys[s]))})
        for s, st in enumerate(stores)]
    tier, jtier = sharding.ReplicatedHotTier(port), JTier(ref)
    n = tier.refresh(stores)
    assert n == jtier.refresh(dict_stores) == port.hot_keys_frozen().size
    probe = np.concatenate([port.hot_keys_frozen()[::2], keys[:50]])
    rows, found = tier.lookup(probe)
    jrows, jfound = jtier.lookup(probe)
    np.testing.assert_array_equal(found, jfound)
    np.testing.assert_array_equal(rows.view(np.uint32),
                                  jrows.view(np.uint32))
    hot = probe[found]
    shard = port.shard_of(hot)
    for s in range(P):
        m = shard == s
        if m.any():
            np.testing.assert_array_equal(
                rows[found][m].view(np.uint32),
                stores[s].lookup(hot[m]).view(np.uint32))
    assert not rows[~found].any()
    # shards this process does not hold are skipped
    part = sharding.ReplicatedHotTier(port)
    jpart = JTier(ref)
    held = [stores[0], None, stores[2], None]
    assert part.refresh(held) == jpart.refresh(
        [dict_stores[0], None, dict_stores[2], None])
    np.testing.assert_array_equal(part.lookup(probe)[1],
                                  jpart.lookup(probe)[1])
    # nothing frozen: nothing mirrored
    empty = sharding.ReplicatedHotTier(sharding.TwoDGridPolicy(4, 8, 2))
    assert empty.refresh(stores) == 0
    assert not empty.lookup(probe)[1].any()


# ----------------------------------------------------------- the router

def table_of(P, pol, keys, cap_per_shard=4096, kb=128):
    t = ShardedPassTable(
        TableConfig(embedx_dim=4, pass_capacity=P * cap_per_shard,
                    optimizer=SparseOptimizerConfig()),
        P, kb, owned_shards=[0], policy=pol, device="cpu")
    t.begin_feed_pass()
    t.add_keys(keys)
    t.end_feed_pass()
    return t


@pytest.mark.parametrize("P", [2, 4, 8])
@pytest.mark.parametrize("kind", ["key-mod", "table-wise", "2d-grid"])
def test_native_router_equals_its_numpy_twin(P, kind):
    """rt_bucketize (key-mod) or rt_bucketize_sharded (the others) and
    bucketize_plain: the same buckets, restore, overflow and valid mask,
    with and without overflow; the route counter names the entry."""
    kw = {"table-wise": dict(num_tables=7, table_shift=0),
          "2d-grid": dict(num_tables=7, rows=grid_rows(P)[1] if P > 1
                          else 1, table_shift=0)}.get(kind, {})
    pol = both(P, kind, **kw)[0]
    rng = np.random.RandomState(P)
    keys = np.unique(rng.randint(0, 20000, 3000).astype(np.uint64))
    for kb in (1024, 16):
        t = table_of(P, pol, keys, kb=kb)
        probe = rng.choice(keys, 900).astype(np.uint64)
        valid = np.ones(probe.size, bool)
        valid[::7] = False
        v_n, v_p = valid.copy(), valid.copy()
        got = t.bucketize(probe, v_n)
        want = bucketize_plain([t.shard_keys(s) for s in range(P)], probe,
                               v_p, kb, t.shard_cap - 1, pol.shard_of(probe))
        np.testing.assert_array_equal(got.buckets, want.buckets)
        np.testing.assert_array_equal(got.restore, want.restore)
        np.testing.assert_array_equal(v_n, v_p)
        assert got.overflow == want.overflow
        assert (got.overflow > 0) == (kb == 16)
        entry = "rt_bucketize" if kind == "key-mod" else \
            "rt_bucketize_sharded"
        assert t.route_counts == {entry: 1}


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("kind", ["table-wise", "2d-grid"])
def test_router_matches_the_reference_router(P, kind):
    """The port's native router under a non-key-mod policy against the
    reference's ShardedPassTable.bucketize on the same pass: the same
    owner and local key of every kept occurrence, the same overflow."""
    from paddlebox_tpu.config.configs import \
        SparseOptimizerConfig as JOpt
    from paddlebox_tpu.config.configs import TableConfig as JTable
    from paddlebox_tpu.parallel.sharded_table import \
        ShardedPassTable as JTable_
    kw = {"table-wise": dict(num_tables=7, table_shift=0),
          "2d-grid": dict(num_tables=7, rows=2, table_shift=0)}[kind]
    pol, jpol = both(P, kind, **kw)
    rng = np.random.RandomState(11 + P)
    keys = np.unique(rng.randint(0, 9000, 2500).astype(np.uint64))
    t = table_of(P, pol, keys)
    jt = JTable_(JTable(embedx_dim=4, pass_capacity=P * 4096,
                        optimizer=JOpt()), P, bucket_cap=128, policy=jpol)
    jt.begin_feed_pass()
    jt.add_keys(keys)
    jt.end_feed_pass()
    probe = rng.choice(keys, 700).astype(np.uint64)
    v, jv = np.ones(probe.size, bool), np.ones(probe.size, bool)
    got = t.bucketize(probe, v)
    want = jt.bucketize(probe, jv)
    np.testing.assert_array_equal(v, jv)
    assert got.overflow == want.overflow
    kb = t.bucket_cap
    for idx, table in ((got, t._shard_keys), (want, jt._shard_keys)):
        s = idx.restore[v] // kb
        np.testing.assert_array_equal(s, pol.shard_of(probe[v]))
        local = idx.buckets.reshape(-1)[idx.restore[v]]
        np.testing.assert_array_equal(
            np.array([table[a][b] for a, b in zip(s, local)], np.uint64),
            probe[v])


# --------------------------------------------------------- the exchange

def hot_buckets(P, seed=13, KB=64, shard_cap=256):
    """Each rank's [P, KB] deduplicated columns and a hot set a
    destination, the hot ids in every source's column."""
    rng = np.random.RandomState(seed + P)
    hot = {d: np.array(sorted(rng.choice(np.arange(1, 40), 5,
                                         replace=False)), np.int32)
           for d in range(P)}
    buckets = np.full((P, P, KB), shard_cap - 1, np.int32)
    for s in range(P):
        for d in range(P):
            pool = np.setdiff1d(np.arange(shard_cap - 1), hot[d])
            n = rng.randint(8, KB - 8)
            col = np.concatenate([hot[d][:rng.randint(0, 6)],
                                  rng.choice(pool, n, replace=False)])
            buckets[s, d, :col.size] = col
    return buckets, hot, shard_cap


@pytest.mark.parametrize("P", [2, 4])
def test_hot_filtered_exchange_matches_the_reference(P):
    """With a frozen hot set a destination: every owner's uids equal the
    reference's, the hot ids never travel (fewer bytes than the unfiltered
    exchange, the difference the dropped ids), the wire bytes are the
    reference's plus the port's real-id header words, the real-id counts
    are the unfiltered columns', and the counts of dropped and re-added
    ids are kept."""
    from paddlebox_tpu.parallel.sharded_table import \
        exchange_push_uids_p2p as jexchange
    from paddlebox_tpu.utils import stats as jstats
    from paddlebox_tpu.parallel.sharding import TwoDGridPolicy as JGrid
    buckets, hot, cap = hot_buckets(P)
    pol = sharding.TwoDGridPolicy(P, 8, 1, hot_threshold=1)
    jpol = JGrid(P, 8, 1, hot_threshold=1)
    pol._hot_local = dict(hot)
    jpol._hot_local = dict(hot)

    def run(policy, fn, st, counts=None):
        before = st.stat_peek("hostplane_exchange_bytes")
        out = threaded_exchange(P, lambda m: fn(
            buckets[m.rank][None], [m.rank], P, cap, m, policy=policy,
            **({} if counts is None else {"hot_counts": counts[m.rank]})))
        return out, st.stat_peek("hostplane_exchange_bytes") - before

    counts = [{} for _ in range(P)]
    got, got_bytes = run(pol, exchange_push_uids_p2p, pstats, counts)
    plain, plain_bytes = run(None, exchange_push_uids_p2p, pstats)
    want, want_bytes = run(jpol, jexchange, jstats)
    for d in range(P):
        uids, n_real = got[d]
        np.testing.assert_array_equal(uids[d], want[d][d])
        # the unfiltered uids and the whole hot set: the over-approximation
        live = plain[d][0][d][plain[d][0][d] < cap]
        union = np.union1d(live, hot[d])
        np.testing.assert_array_equal(uids[d][:union.size], union)
        assert (uids[d][union.size:] >= cap).all()
        assert n_real[d] == plain[d][1][d] == sum(
            int(np.unique(buckets[s][d]).size
                - (buckets[s][d] == cap - 1).any()) for s in range(P))
    # every part's header carries one real-id word a destination (P - 1
    # parts sent and P - 1 received a rank, one destination each)
    assert got_bytes == want_bytes + 4 * 2 * P * (P - 1)
    dropped = sum(int(np.isin(np.unique(buckets[s][d]), hot[d]).sum())
                  for s in range(P) for d in range(P))
    assert sum(c["dropped"] for c in counts) == dropped
    assert all(c["readded"] == hot[r].size for r, c in enumerate(counts))
    sent_dropped = sum(int(np.isin(np.unique(buckets[s][d]), hot[d]).sum())
                       for s in range(P) for d in range(P) if d != s)
    assert plain_bytes - got_bytes == 2 * 4 * sent_dropped


def test_hot_union_over_the_staged_length_raises():
    buckets, hot, cap = hot_buckets(2, KB=24)
    pol = sharding.TwoDGridPolicy(2, 8, 1, hot_threshold=1)
    pol._hot_local = {0: np.arange(60, dtype=np.int32)}
    errs = threaded_exchange(2, lambda m: _raises(
        lambda: exchange_push_uids_p2p(buckets[m.rank][None], [m.rank], 2,
                                       cap, m, policy=pol)))
    assert "sharding_hot_cap/bucket_cap" in errs[0]
    assert errs[1] is None


def _raises(fn):
    try:
        fn()
    except RuntimeError as e:
        return str(e)
    return None


# ------------------------------------------------------ checkpoint routing

def test_a_checkpoint_loads_by_the_live_policy(tmp_path):
    """Shard files written by a key-mod table of 2 shards load into each
    shard of a 2-D grid table by the grid's routing: every key lands on
    its grid owner with its row unchanged."""
    from paddlebox_tpu_torch.parallel.sharding import (KeyModPolicy,
                                                       TwoDGridPolicy)
    rng = np.random.RandomState(21)
    keys = np.unique(rng.randint(0, 1 << 40, 900).astype(np.uint64))
    table = TableConfig(embedx_dim=4, pass_capacity=2048,
                        optimizer=SparseOptimizerConfig())
    rows = {}
    paths = []
    for s in range(2):
        t = ShardedPassTable(table, 2, 64, owned_shards=[s],
                             policy=KeyModPolicy(2), device="cpu")
        mine = keys[keys % np.uint64(2) == np.uint64(s)]
        vals = rng.randn(mine.size, t.layout.width).astype(np.float32)
        t.shard.store.load_blob({"keys": mine, "values": vals,
                                 "embedx_dim": 4,
                                 "optimizer": t.layout.optimizer})
        rows.update(zip(mine.tolist(), vals))
        t.save(str(tmp_path / "ck"))
        paths.append(str(tmp_path / ("ck.shard%03d" % s)))
    grid = TwoDGridPolicy(2, 5, 2, table_shift=0)
    for s in range(2):
        t = ShardedPassTable(table, 2, 64, owned_shards=[s], policy=grid,
                             device="cpu")
        t.load_split(paths)
        k, v = t.shard.store.state_items()
        np.testing.assert_array_equal(np.sort(k),
                                      np.sort(keys[grid.shard_of(keys) == s]))
        for kk, vv in zip(k.tolist(), v):
            np.testing.assert_array_equal(vv.view(np.uint32),
                                          rows[kk].view(np.uint32))
