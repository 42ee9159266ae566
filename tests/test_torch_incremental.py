"""The port's incremental pass lifecycle and preload against the JAX package
and against the port's own full-rebuild path.

Same inputs, made from a seed with numpy, go through both packages on the
CPU (the port's gather_rows runs its plain version on CPU tensors).
Tolerances:

  * the delta promote, sorted_member and lookup_present against the JAX
    functions: exact (bit moves, integer probes, rows from the same
    RandomState draws);
  * the port's incremental PassTable, sequential passes and preloaded
    passes against its full rebuild: slab and host store bit-identical,
    losses rtol 1e-6 (the reference's own tolerance, tests/
    test_pass_incremental.py:323) and AUC 1e-6 absolute;
  * three sliding-window train_passes against the JAX BoxTrainer: loss
    rtol 1e-4, AUC 1e-4 absolute, store rows rtol 1e-4 with the integer
    columns exact (float32 sums taken in another order by XLA and ATen, as
    in tests/test_torch_train.py).
"""

import dataclasses
import filecmp
import functools
import sys
import threading

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
from paddlebox_tpu.embedding.pass_table import (_delta_promote_impl,
                                                _pow2_pad)
from paddlebox_tpu.embedding.pass_table import (
    sorted_member as jax_sorted_member)
from paddlebox_tpu.models.base import ModelSpec as JSpec
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.train.trainer import BoxTrainer as JTrainer

from paddlebox_tpu_torch import cadence_probe
from paddlebox_tpu_torch.config.configs import (DataFeedConfig, SlotConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.config.flags import PassFlags, PushFlags
from paddlebox_tpu_torch.convert import params_from_jax
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.embedding.accessor import ValueLayout
from paddlebox_tpu_torch.embedding.host_store import HostEmbeddingStore
from paddlebox_tpu_torch.embedding.native_store import \
    NativeHostEmbeddingStore
from paddlebox_tpu_torch.embedding.optimizers import push_sparse_hostdedup
from paddlebox_tpu_torch.embedding.pass_table import (PassTable,
                                                      delta_promote,
                                                      lookup_ids_plain,
                                                      segment_offsets,
                                                      sorted_member)
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.native import host_lib
from paddlebox_tpu_torch.ops import row_kernels as rk
from paddlebox_tpu_torch.train import flagship
from paddlebox_tpu_torch.train.preload import (PassPreloader,
                                               PromotePrefetcher)
from paddlebox_tpu_torch.train.trainer import BoxTrainer

D = 4
CAP = 1 << 10
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
INT_COLS = [acc.SLOT, acc.SHOW, acc.CLICK, acc.UNSEEN_DAYS, acc.MF_SIZE]
FULL = PassFlags(incremental_pass=False)


def table_cfg(cap=CAP, d=D):
    return TableConfig(embedx_dim=d, pass_capacity=cap,
                       optimizer=SparseOptimizerConfig(**OPT))


def sorted_items(store):
    keys, rows = store.state_items()
    order = np.argsort(keys)
    return keys[order], rows[order]


def assert_bits_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a).view(np.uint32),
                                  np.asarray(b).view(np.uint32))


# ------------------------------------------------- delta promote vs JAX

def _promote_case(overlap, seed, cap=512, width=13):
    """(old slab, old_pos, new_rows): a resident slab of ``old`` keys and
    the next pass's keys keeping ``overlap`` of them, old_pos as
    PassTable._resident_pos gives it."""
    rng = np.random.RandomState(seed)
    old = np.unique(rng.randint(0, 1 << 40, 300).astype(np.uint64))
    kept = old[rng.rand(old.size) < overlap]
    fresh = (np.unique(rng.randint(1 << 41, 1 << 42, 150).astype(np.uint64))
             if overlap < 1.0 else old[:0])
    new = np.unique(np.concatenate([kept, fresh]))
    pos, hit = sorted_member(old, new)
    old_pos = np.where(hit, pos, -1).astype(np.int32)
    # a resident slab: every row nonzero, signed zeros and subnormals among
    # them (the move is of bits); the tail and the trash row too
    slab = rng.randn(cap, width).astype(np.float32)
    slab[::7, 0] = -0.0
    slab[::11, 1] = np.float32(1e-40)
    new_rows = rng.randn(int((~hit).sum()), width).astype(np.float32)
    return slab, old_pos, new_rows


def _jax_promote(slab, old_pos, new_rows):
    """_delta_promote_impl on the inputs begin_pass builds
    (paddlebox_tpu/embedding/pass_table.py:534-552)."""
    cap = slab.shape[0]
    n = old_pos.size
    hit = old_pos >= 0
    miss_idx = np.flatnonzero(~hit).astype(np.int32)
    src = np.zeros(cap, np.int32)
    keep = np.zeros(cap, bool)
    src[:n][hit] = old_pos[hit]
    keep[:n] = hit
    m = miss_idx.size
    pad = _pow2_pad(max(m, 1))
    idx_p = np.full(pad, cap, np.int32)
    rows_p = np.zeros((pad, slab.shape[1]), np.float32)
    idx_p[:m] = miss_idx
    rows_p[:m] = new_rows
    return np.asarray(_delta_promote_impl(
        jnp.asarray(slab), jnp.asarray(src), jnp.asarray(keep),
        jnp.asarray(idx_p), jnp.asarray(rows_p)))


@pytest.mark.parametrize("overlap", [0.0, 0.5, 1.0])
def test_delta_promote_matches_jax_bitwise(overlap):
    slab, old_pos, new_rows = _promote_case(overlap, seed=int(overlap * 10))
    hits = int((old_pos >= 0).sum())
    assert (hits == 0) == (overlap == 0.0)
    assert (new_rows.shape[0] == 0) == (overlap == 1.0)
    got = delta_promote(torch.from_numpy(slab), old_pos, new_rows)
    assert got.shape == slab.shape and got.dtype == torch.float32
    want = _jax_promote(slab, old_pos, new_rows)
    assert_bits_equal(got.numpy(), want)
    assert not got[old_pos.size:].any()


def test_sorted_member_matches_jax():
    rng = np.random.RandomState(5)
    sk = np.unique(rng.randint(0, 1000, 200).astype(np.uint64))
    cases = {"mixed": rng.randint(0, 1200, 300).astype(np.uint64),
             "all in": rng.choice(sk, 50),
             "past the end": np.uint64([5000, 7000]),
             "none": np.empty(0, np.uint64)}
    for name, keys in cases.items():
        for sorted_keys in (sk, sk[:0]):
            got, want = (sorted_member(sorted_keys, keys),
                         jax_sorted_member(sorted_keys, keys))
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b, err_msg=name)
    pos, hit = sorted_member(sk, sk[::3])
    assert hit.all() and (pos == np.arange(0, sk.size, 3)).all()


def test_lookup_present_and_state_items_match_jax():
    jtable = JTable(embedx_dim=D, pass_capacity=CAP, optimizer=JSparse(**OPT))
    port = HostEmbeddingStore(ValueLayout(D), table_cfg(), seed=3)
    ref = JHostStore(JLayout(D, "adagrad"), jtable, seed=3)
    rng = np.random.RandomState(0)
    k1 = np.unique(rng.randint(0, 1 << 40, 300).astype(np.uint64))
    absent = np.unique(rng.randint(1 << 41, 1 << 42, 60).astype(np.uint64))
    for s in (port, ref):
        s.lookup_or_create(k1)
    probe = rng.permutation(np.concatenate([k1[::2], absent]))
    (pr, pf), (jr, jf) = port.lookup_present(probe), ref.lookup_present(probe)
    np.testing.assert_array_equal(pf, jf)
    assert_bits_equal(pr, jr)
    assert not pr[~pf].any() and pf.sum() == k1[::2].size
    # nothing was created: the next creation draws as if no probe had run
    assert len(port) == k1.size
    assert_bits_equal(port.lookup_or_create(absent),
                      ref.lookup_or_create(absent))
    (pk, pv), (jk, jv) = sorted_items(port), sorted_items(ref)
    np.testing.assert_array_equal(pk, jk)
    assert_bits_equal(pv, jv)


# --------------------------------- incremental PassTable vs the full path

def make_passes(rng, n_passes=3, n_keys=500, overlap=0.9):
    """Consecutive sorted-unique key sets keeping about ``overlap`` of the
    keys (tests/test_pass_incremental.py:40-55)."""
    cur = np.unique(rng.randint(0, 1 << 30, n_keys).astype(np.uint64))
    out = [cur]
    for _ in range(n_passes - 1):
        keep = rng.rand(cur.size) < overlap
        fresh = np.unique(
            rng.randint(0, 1 << 30, max(8, int(n_keys * (1 - overlap))))
            .astype(np.uint64))
        cur = np.unique(np.concatenate([cur[keep], fresh]))
        out.append(cur)
    return out


def _push(t, keys, step):
    """A push with repeats on ``keys`` through lookup_ids, as a train step
    pushes: the dedup products and push_sparse_hostdedup."""
    ids = t.lookup_ids(keys)
    uids, perm, inv, n_uniq = t.dedup_for_push(ids)
    pl = t.push_layout
    g = np.zeros((ids.size, pl.width), np.float32)
    g[:, pl.SHOW] = 1.0
    g[:, pl.CLICK] = (np.arange(ids.size) % 2).astype(np.float32)
    g[:, pl.EMBED_G] = 0.05
    g[:, pl.embedx_g:] = 0.01
    dev = t.slab.device
    uids, perm, offsets, g = (torch.from_numpy(x).to(dev) for x in (
        uids, perm, segment_offsets(inv, ids.size), g))
    push_sparse_hostdedup(t.slab, uids, perm, offsets, n_uniq, g, 1000 + step,
                          t.layout, t.config.optimizer)


def run_table(passes, flags, cadence, seed=11):
    """Drive a PassTable through ``passes``; returns per pass (slab after
    begin_pass, slab after the pushes, sorted store items after end_pass,
    row counters of the pass).

    cadence: 'plain'; 'untouched' (pass 1 changes the slab without
    lookup_ids, so no row is marked); 'invalidated' (a store change outside
    the cadence and invalidate_residency after pass 0, invalidate_residency
    during pass 2)."""
    t = PassTable(table_cfg(), seed=seed, device="cpu", flags=flags)
    out = []
    for p, keys in enumerate(passes):
        before = dict(t.counters)
        t.begin_feed_pass()
        t.add_keys(keys)
        t.end_feed_pass()
        t.begin_pass()
        built = t.slab.clone().numpy()
        if cadence == "untouched" and p == 1:
            t.slab[:keys.size, acc.SHOW] += 2.0
        else:
            _push(t, np.concatenate([keys[:max(1, keys.size // 2)],
                                     keys[:7]]), p)
        if cadence == "invalidated" and p == 2:
            t.invalidate_residency()
        pushed = t.slab.clone().numpy()
        t.end_pass()
        if cadence == "invalidated" and p == 0:
            # a store change outside the pass cadence (as aging or a load)
            k, rows = t.store.state_items()
            with t.store_lock:
                t.store.write_back(k[::3], rows[::3] * 0.5 + 1.0)
            t.invalidate_residency()
        counters = {k: v - before[k] for k, v in t.counters.items()}
        out.append((built, pushed, sorted_items(t.store), counters))
    return out


CADENCES = {
    "overlap_0.9": (lambda: make_passes(np.random.RandomState(0), 4), "plain"),
    "zero_overlap": (lambda: [
        np.unique((np.random.RandomState(1).randint(0, 1 << 20, 300)
                   + (p << 32)).astype(np.uint64)) for p in range(3)],
        "plain"),
    "invalidated": (lambda: make_passes(np.random.RandomState(4), 4),
                    "invalidated"),
    "untouched": (lambda: make_passes(np.random.RandomState(2), 3),
                  "untouched"),
}


@pytest.mark.parametrize("name", sorted(CADENCES))
def test_pass_table_incremental_matches_full_bitwise(name):
    make, cadence = CADENCES[name]
    passes = make()
    full = run_table(passes, FULL, cadence)
    inc = run_table(passes, PassFlags(), cadence)
    for p, (f, i) in enumerate(zip(full, inc)):
        for a, b in zip(f[:2], i[:2]):
            assert_bits_equal(a, b)
        np.testing.assert_array_equal(f[2][0], i[2][0])
        assert_bits_equal(f[2][1], i[2][1])
        assert not any(f[3].values()), "the full path counts no rows"
    # the counters prove which path each pass took
    rows = [c for *_, c in inc]
    pushed = [np.unique(np.concatenate([k[:max(1, k.size // 2)], k[:7]])).size
              for k in passes]
    for p, (keys, c) in enumerate(zip(passes, rows)):
        delta = p > 0 and not (name == "invalidated" and p in (1, 3))
        if delta:
            hit = np.isin(keys, passes[p - 1]).sum()
            assert c["pass_rows_promote_hit"] == hit
            assert c["pass_rows_promote_new"] == keys.size - hit
        else:
            assert c["pass_rows_promote_hit"] == c["pass_rows_promote_new"] \
                == 0
        if name == "untouched" and p == 1:
            # no row marked: the whole slab is written back, uncounted
            assert c["pass_rows_written_back"] == 0
        else:
            assert c["pass_rows_written_back"] == pushed[p]
            assert c["pass_rows_writeback_skipped"] == keys.size - pushed[p]
    if name == "zero_overlap":
        assert all(c["pass_rows_promote_new"] == k.size
                   for c, k in zip(rows[1:], passes[1:]))
    if name == "overlap_0.9":
        assert all(c["pass_rows_promote_hit"] > 0.8 * k.size
                   for c, k in zip(rows[1:], passes[1:]))


def test_staged_rows_are_used_and_never_create():
    """Rows accepted from the prefetcher stand in for store reads; keys it
    did not stage are created at begin_pass in sorted order, as the full
    path creates them."""
    rng = np.random.RandomState(6)
    k0, k1 = make_passes(rng, 2, overlap=0.8)
    # pass 2 brings back pass 0's keys that pass 1 dropped, and new ones
    passes = [k0, k1, np.union1d(k0, rng.randint(0, 1 << 30, 60).astype(
        np.uint64))]
    ref = run_table(passes, FULL, "plain")
    t = PassTable(table_cfg(), seed=11, device="cpu")
    for p, keys in enumerate(passes):
        ctx = t.promote_prefetch_ctx()
        assert (ctx is None) == (p == 0)
        if ctx is not None:
            known, store, lock = ctx
            pre = PromotePrefetcher(known, store, lock)
            for chunk in np.array_split(keys, 5):
                pre.feed(chunk)
            t.accept_staged_rows(*pre.finish())
        t.begin_feed_pass()
        t.add_keys(keys)
        t.end_feed_pass()
        t.begin_pass()
        assert_bits_equal(t.slab.numpy(), ref[p][0])
        _push(t, np.concatenate([keys[:max(1, keys.size // 2)], keys[:7]]),
              p)
        t.end_pass()
        assert_bits_equal(sorted_items(t.store)[1], ref[p][2][1])
    # pass 2's keys that pass 1 lacked but pass 0 had came from the stage
    came_back = np.setdiff1d(np.intersect1d(passes[2], passes[0]), passes[1])
    assert came_back.size
    assert t.counters["pass_rows_promote_prefetched"] == came_back.size
    assert t.seconds["begin_pass"] > 0 and t.seconds["end_pass"] > 0


def test_prefetch_ctx_follows_the_flags():
    for flags, on in ((PassFlags(), True),
                      (PassFlags(preload_promote=False), False),
                      (PassFlags(incremental_pass=False), False)):
        t = PassTable(table_cfg(), device="cpu", flags=flags)
        assert t.promote_prefetch_ctx() is None   # no pass key set yet
        t.begin_feed_pass()
        t.add_keys(np.uint64([3, 5]))
        t.end_feed_pass()
        assert (t.promote_prefetch_ctx() is not None) == on
    assert PassFlags() == PassFlags(True, True)


# ------------------------------------- train passes: port vs JAX, 3 ways

@pytest.fixture(scope="module")
def window_data(tmp_path_factory):
    """Four files; passes over files [0, 1], [1, 2] and [2, 3]."""
    out = tmp_path_factory.mktemp("torch_incremental_data")
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


def _jax_pass_seeds(table_key, n_steps):
    """(one train_pass's per-step push seeds, the next table key), as the
    JAX trainer draws them (trainer.py:725, optimizers.py:238)."""
    table_key, prng = jax.random.split(table_key)
    seeds = []
    for _ in range(n_steps):
        prng, sub = jax.random.split(prng)
        seeds.append(int(jax.random.randint(sub, (), 0,
                                            jnp.int32(2**31 - 1))))
    return seeds, table_key


def test_sliding_window_passes_match_jax(window_data, pallas_interpret):
    windows, jfeed, pfeed = window_data
    assert jflags.get_flag("incremental_pass")
    jt = JTrainer(JDeepFM(JSpec(num_slots=4, slot_dim=3 + 8),
                          hidden=(16, 8)),
                  JTable(embedx_dim=8, pass_capacity=CAP,
                         optimizer=JSparse(**OPT)),
                  jfeed, JTrainerCfg(dense_lr=5e-3), seed=0)
    model = DeepFM(ModelSpec(num_slots=4, slot_dim=3 + 8), hidden=(16, 8))
    model.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in jt.params.items()}))
    pt = BoxTrainer(model, table_cfg(d=8), pfeed, TrainerConfig(dense_lr=5e-3),
                    seed=0, flags=PushFlags("scatter", 64), device="cpu")
    for t in (jt, pt):
        t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    key = jax.random.PRNGKey(0)
    for p, files in enumerate(windows):
        jds = JDataset(jfeed, read_threads=1, columnar=False)
        pds = BoxDataset(pfeed)
        jds.set_filelist(files)
        pds.set_filelist(files)
        seeds, key = _jax_pass_seeds(key, (2 * 96 + 31) // 32)
        pt.seed_fn = iter(seeds).__next__
        before = dict(pt.table.counters)
        want, got = jt.train_pass(jds)["loss"], pt.train_pass(pds)["loss"]
        np.testing.assert_allclose(got, want, rtol=1e-4)
        ja = jt.metrics.get_metric_msg("auc")["auc"]
        pa = pt.metrics.get_metric_msg("auc")["auc"]
        assert abs(pa - ja) <= 1e-4, (p, pa, ja)
        hits = pt.table.counters["pass_rows_promote_hit"] - before[
            "pass_rows_promote_hit"]
        assert (hits > 0) == (p > 0)
    (pk, pv), (jk, jv) = sorted_items(pt.table.store), sorted_items(
        jt.table.store)
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_array_equal(pv[:, INT_COLS], jv[:, INT_COLS])
    np.testing.assert_allclose(pv, jv, rtol=1e-4, atol=1e-7)


@pytest.fixture(scope="module")
def cadence_files(tmp_path_factory):
    """write_cadence at a narrow replace of FLAGSHIP: pass 2 brings back
    keys that pass 1 lacked, so the prefetcher has rows to read."""
    cfg = dataclasses.replace(
        flagship.FLAGSHIP, num_slots=4, batch=32, max_len=3, hidden=(16, 8),
        capacity=4096, num_files=4, lines_per_file=96, vocab_per_slot=400,
        data_seed=7)
    windows, feed = flagship.write_cadence(
        str(tmp_path_factory.mktemp("cadence")), cfg)
    return cfg, windows, feed


NATIVE_TIER = {"dataset": "columnar", "store": "NativeHostEmbeddingStore"}


def _cadence_run(cfg, windows, feed, mode):
    t, run = cadence_probe.run_cadence(mode, windows, feed, cfg, "cpu")
    # every mode runs on the native host tier, the route index included
    assert run["host_tier"] == NATIVE_TIER
    assert isinstance(t.table.store, NativeHostEmbeddingStore)
    assert t.table.route_index is not None
    passes = run["passes"]
    counters = {k: sum(p["counters"][k] for p in passes)
                for k in t.table.counters}
    assert counters == t.table.counters
    return ([(p["loss"], p["auc"]) for p in passes],
            [list(p["phase_s"]) for p in passes],
            sorted_items(t.table.store), counters, passes)


@pytest.mark.parametrize("mode", ["a", "b", "d"])
def test_cadence_matches_full_rebuild(cadence_files, mode):
    """Modes (a) preloaded with the prefetcher, (b) sequential and (d)
    preloaded without the prefetcher, all incremental, against (c) the
    full rebuild."""
    cfg, windows, feed = cadence_files
    got = _cadence_run(cfg, windows, feed, mode)
    want = _cadence_run(cfg, windows, feed, "c")
    for (gl, ga), (wl, wa) in zip(got[0], want[0], strict=True):
        np.testing.assert_allclose(gl, wl, rtol=1e-6)
        assert abs(ga - wa) <= 1e-6
    np.testing.assert_array_equal(got[2][0], want[2][0])
    assert_bits_equal(got[2][1], want[2][1])
    first = "wait" if mode in "ad" else "feed"
    assert got[1] == [[first, "build", "steps", "end"]] * 3
    c = got[3]
    assert c["pass_rows_promote_hit"] > 0 and c["pass_rows_promote_new"] > 0
    assert (c["pass_rows_promote_prefetched"] > 0) == (mode == "a")
    assert not any(want[3].values())
    for p in got[4]:
        assert p["table_s"]["begin_pass"] > 0 and p["gc_s"] >= 0
        assert p["examples_per_s"] > 0


def test_cadence_native_tier_matches_plain_tier(cadence_files):
    """The cadence's sequential incremental mode (b) on the native host
    tier against the same passes on the plain tier (the record-path
    dataset, the Python store): losses, AUC, store and counters
    bit-identical."""
    cfg, windows, feed = cadence_files
    got = _cadence_run(cfg, windows, feed, "b")
    trainer, _ = flagship.build_trainer(windows[0], feed, cfg, "scatter",
                                        "cpu", plain_host=True)
    assert type(trainer.table.store) is HostEmbeddingStore
    want = []
    for files in windows:
        ds = BoxDataset(feed, columnar=False)
        ds.set_filelist(files)
        res = trainer.train_pass(ds)
        want.append((res["loss"], trainer.metrics.get_metric_msg("auc")[
            "auc"]))
    assert got[0] == want
    k, v = sorted_items(trainer.table.store)
    np.testing.assert_array_equal(got[2][0], k)
    assert_bits_equal(got[2][1], v)
    assert got[3] == trainer.table.counters


def test_cadence_probe_order_is_balanced():
    """After the warm-up, every mode follows every other mode once a
    repetition, and every mode runs equally often."""
    order = "a" + cadence_probe.BALANCED * 2
    pairs = [order[i:i + 2] for i in range(len(order) - 1)]
    want = sorted(x + y for x in cadence_probe.MODES
                  for y in cadence_probe.MODES if x != y)
    assert sorted(pairs) == sorted(want * 2)
    assert sorted(order[1:]) == sorted("".join(cadence_probe.MODES) * 6)


def test_write_cadence_windows(cadence_files, tmp_path):
    cfg, windows, feed = cadence_files
    assert [len(w) for w in windows] == [4, 4, 4]
    assert windows[1][:2] == windows[0][2:] and windows[2][:2] == \
        windows[1][2:]
    files, _ = flagship.write_files(str(tmp_path), cfg)
    assert all(filecmp.cmp(a, b, shallow=False)
               for a, b in zip(files, windows[0]))
    keys = flagship.sorted_pass_keys(windows[0], feed)
    assert (np.diff(keys.astype(np.float64)) > 0).all()


# --------------------------------------------------- preload and dataset

def _small_trainer(pfeed):
    model = DeepFM(ModelSpec(num_slots=4, slot_dim=3 + D), hidden=(8,))
    return BoxTrainer(model, table_cfg(), pfeed, TrainerConfig(), seed=0,
                      device="cpu")


def _datasets(files, pfeed, n):
    out = []
    for _ in range(n):
        out.append(BoxDataset(pfeed))
        out[-1].set_filelist(files)
    return out


def test_preloader_guards(window_data):
    windows, _, pfeed = window_data
    tr = _small_trainer(pfeed)
    pre = PassPreloader(tr.table)
    ds1, ds2 = _datasets(windows[0], pfeed, 2)
    pre.preload(ds1)
    with pytest.raises(RuntimeError, match="in flight"):
        pre.preload(ds2)          # one preload in flight at a time
    with pytest.raises(RuntimeError, match="not preloaded"):
        pre.wait(ds2)             # wait() must name the preloaded dataset
    pre.wait(ds1)
    assert len(ds1) == 192 and tr.table.pass_size > 0
    tr.table.begin_pass()
    tr.table.end_pass()
    # a reader error is raised at the wait, from its cause, and the
    # preloader resets
    bad = BoxDataset(pfeed)
    bad.set_filelist([windows[0][0], windows[0][0] + ".missing"])
    pre.preload(bad)
    with pytest.raises(RuntimeError, match="dataset load failed") as err:
        pre.wait(bad)
    assert isinstance(err.value.__cause__, FileNotFoundError)
    pre.preload(ds2)
    pre.wait(ds2)
    assert len(ds2) == 192


def test_prefetcher_error_surfaces_at_finish():
    def known(keys):
        raise ValueError("known_fn failed")

    store = HostEmbeddingStore(ValueLayout(D), table_cfg())
    pre = PromotePrefetcher(known, store, threading.Lock())
    pre.feed(np.uint64([1, 2, 3]))
    with pytest.raises(ValueError, match="known_fn failed"):
        pre.finish()


def test_prefetcher_system_exit_surfaces_at_finish():
    """A non-Exception error in the prefetcher is kept and raised at
    finish(), not lost with the thread."""
    def known(keys):
        raise SystemExit(3)

    pre = PromotePrefetcher(known, HostEmbeddingStore(ValueLayout(D),
                                                      table_cfg()),
                            threading.Lock())
    pre.feed(np.uint64([1, 2, 3]))
    with pytest.raises(SystemExit):
        pre.finish()


@pytest.mark.parametrize("columnar", [True, False])
def test_reader_system_exit_fails_the_load(window_data, columnar,
                                           monkeypatch):
    """A parser that raises SystemExit partway through the second file: the
    load raises RuntimeError("dataset load failed") from it at
    wait_preload_done, on either path, and does not hand back a truncated
    dataset."""
    windows, _, pfeed = window_data
    ds = BoxDataset(pfeed, columnar=columnar)
    ds.set_filelist(windows[0])
    second = windows[0][1]
    if columnar:
        parse = ds.parser.parse_file_columnar

        def failing(path):
            if path == second:
                raise SystemExit("parser exit")
            return parse(path)

        monkeypatch.setattr(ds.parser, "parse_file_columnar", failing)
    else:
        parse = ds.parser.parse_file

        def failing(path):
            for i, rec in enumerate(parse(path)):
                if path == second and i == 40:
                    raise SystemExit("parser exit")
                yield rec

        monkeypatch.setattr(ds.parser, "parse_file", failing)
    keys = []
    ds.preload_into_memory(add_keys_fn=keys.append)
    with pytest.raises(RuntimeError, match="dataset load failed") as err:
        ds.wait_preload_done()
    assert isinstance(err.value.__cause__, SystemExit)
    with pytest.raises(RuntimeError, match="dataset load failed"):
        ds.load_into_memory()
    # the reader is joined: a new load may start
    monkeypatch.undo()
    ds.load_into_memory()
    assert len(ds) == 192


def _fed(t, keys):
    t.begin_feed_pass()
    t.add_keys(keys)
    t.end_feed_pass()


def test_route_index_lifetime():
    """The route index of an ended pass is kept across the feed boundary
    for the next begin_pass's diff and dropped there; invalidate_residency
    drops it; a second feed pass before begin_pass rebuilds one of the
    resident keys; lookup_ids reads the index, equal to searchsorted."""
    passes = make_passes(np.random.RandomState(12), 4)
    ref = run_table(passes, FULL, "plain")
    t = PassTable(table_cfg(), seed=11, device="cpu")
    assert t.route_index is None
    _fed(t, passes[0])
    first = t.route_index
    assert first is not None and t._prev_route is None
    t.begin_pass()
    _push(t, np.concatenate([passes[0][:passes[0].size // 2],
                             passes[0][:7]]), 0)
    t.end_pass()
    _fed(t, passes[1])
    assert t._prev_route == first and t.route_index not in (None, first)
    t.begin_pass()
    assert t._prev_route is None
    assert t.counters["pass_rows_promote_hit"] == np.isin(
        passes[1], passes[0]).sum()
    _push(t, np.concatenate([passes[1][:passes[1].size // 2],
                             passes[1][:7]]), 1)
    t.end_pass()
    # an invalidation drops the kept index; the next pass builds in full
    _fed(t, passes[2])
    assert t._prev_route is not None
    t.invalidate_residency()
    assert t._prev_route is None
    hits = t.counters["pass_rows_promote_hit"]
    t.begin_pass()
    assert t.counters["pass_rows_promote_hit"] == hits
    assert_bits_equal(t.slab.numpy(), ref[2][0])
    _push(t, np.concatenate([passes[2][:passes[2].size // 2],
                             passes[2][:7]]), 2)
    t.end_pass()
    # two feed passes before a begin_pass: the kept index was dropped, and
    # the diff builds one of the resident keys
    _fed(t, passes[3])
    _fed(t, passes[3])
    assert t._prev_route is None
    t.begin_pass()
    assert t.counters["pass_rows_promote_hit"] - hits == np.isin(
        passes[3], passes[2]).sum()
    assert_bits_equal(t.slab.numpy(), ref[3][0])
    q = passes[3][np.random.RandomState(1).randint(0, passes[3].size, 500)]
    valid = np.arange(q.size) % 5 != 0
    np.testing.assert_array_equal(
        t.lookup_ids(q, valid), lookup_ids_plain(passes[3], q, valid,
                                                  t.padding_id))
    t.end_pass()


def test_prefetcher_never_touches_the_route_index(cadence_files,
                                                  monkeypatch):
    """Mode (a), preloaded with the prefetcher: the prefetcher makes no
    route index call (it diffs a numpy snapshot). The index is made,
    dropped and probed for the resident diff on the main thread; batches
    look their ids up on the main thread or on the chunk driver's
    staging threads, which run only while the pass holds its index."""
    cfg, windows, feed = cadence_files
    calls = []
    for name in ("create_route_index", "destroy_route_index",
                 "route_lookup", "route_lookup_serve"):
        def spy(*a, _fn=getattr(host_lib, name), _name=name, **k):
            calls.append((_name, threading.current_thread()))
            return _fn(*a, **k)
        monkeypatch.setattr(host_lib, name, spy)
    got = _cadence_run(cfg, windows, feed, "a")
    assert got[3]["pass_rows_promote_prefetched"] > 0
    main = threading.main_thread()
    assert calls and all(
        t is main or (name == "route_lookup"
                      and t.name.startswith(("pbt-stage", "chunk-stager")))
        for name, t in calls), {(n, t.name) for n, t in calls}
    assert any(t is not main for _, t in calls)


def test_prefetcher_reads_under_the_lock_while_the_store_grows():
    """Stress: the prefetcher reads store-present rows while another thread
    grows the store under the same lock (each growth replaces the value
    array); every row it returns is the row its key holds, and it creates
    nothing."""
    store = HostEmbeddingStore(ValueLayout(D), table_cfg(), seed=1)
    present = np.arange(1, 3001, dtype=np.uint64)
    want = store.lookup_or_create(present)
    lock = threading.Lock()
    stop = threading.Event()

    def grow():
        k = 100_000
        for _ in range(200):
            if stop.is_set():
                return
            with lock:
                store.lookup_or_create(np.arange(k, k + 5000,
                                                 dtype=np.uint64))
            k += 5000

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    grower = threading.Thread(target=grow, daemon=True)
    try:
        grower.start()
        pre = PromotePrefetcher(lambda k: k % 7 == 0, store, lock)
        rng = np.random.RandomState(0)
        for _ in range(60):
            pre.feed(rng.randint(1, 6000, 200).astype(np.uint64))
        keys, rows = pre.finish()
    finally:
        stop.set()
        grower.join(timeout=30)
        sys.setswitchinterval(old)
    assert not grower.is_alive()
    assert keys.size and (keys <= 3000).all() and (keys % 7 != 0).all()
    assert (np.diff(keys.astype(np.int64)) > 0).all()
    assert_bits_equal(rows, want[keys.astype(np.int64) - 1])


def test_dataset_preload_matches_load(window_data):
    windows, jfeed, pfeed = window_data
    loaded, preloaded = _datasets(windows[1], pfeed, 2)
    got_keys, want_keys = [], []
    loaded.load_into_memory(add_keys_fn=want_keys.append)
    preloaded.preload_into_memory(add_keys_fn=got_keys.append)
    with pytest.raises(RuntimeError, match="already running"):
        preloaded.preload_into_memory()
    preloaded.wait_preload_done()
    for a, b in zip(got_keys, want_keys, strict=True):
        np.testing.assert_array_equal(a, b)
    # the JAX dataset's record order (one reader, record path)
    jds = JDataset(jfeed, read_threads=1, columnar=False)
    jds.set_filelist(windows[1])
    jds.load_into_memory()
    for a, b in zip(preloaded.split_batches(1)[0], jds.split_batches(1)[0],
                    strict=True):
        np.testing.assert_array_equal(a.keys, b.keys)
    preloaded.release_memory()
    assert len(preloaded) == 0


def test_cadence_probe_refuses_to_measure_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        cadence_probe.main(["--reps", "1"])


# ------------------------------------------------ gather_rows' out= form

def test_gather_rows_fills_out():
    rng = np.random.RandomState(3)
    src = torch.from_numpy(rng.rand(50, 17).astype(np.float32))
    ids = torch.from_numpy(rng.randint(0, 60, 30).astype(np.int32))
    buf = torch.zeros(40, 17)
    got = rk.gather_rows(src, ids, out=buf[5:35])
    assert got.data_ptr() == buf[5:35].data_ptr()
    assert torch.equal(buf[5:35], rk.gather_rows(src, ids))
    assert not buf[:5].any() and not buf[35:].any()
    with pytest.raises(ValueError, match="must be"):
        rk.gather_rows(src, ids, out=buf[:29])
    with pytest.raises(ValueError, match="shares its storage"):
        rk.gather_rows(src, ids[:20], out=src[20:40])
    with pytest.raises(TypeError):
        rk.gather_rows(src, ids, out=buf[:30].double())


# ---------------------------------------------- on the card (cuda mark)

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode; "
                    "chip_smoke.py holds the delta promote and the "
                    "write-back on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [0.0, 0.5, 1.0])
def test_cuda_promote_and_writeback_on_the_kernel(cuda_device, overlap):
    slab, old_pos, new_rows = _promote_case(overlap, seed=3)
    before = rk.gather_rows.launches
    got = delta_promote(torch.from_numpy(slab).to(cuda_device), old_pos,
                        new_rows)
    torch.cuda.synchronize()
    assert rk.gather_rows.launches == before + int(overlap > 0)
    assert_bits_equal(got.cpu().numpy(),
                      delta_promote(torch.from_numpy(slab), old_pos,
                                    new_rows).numpy())
    # the touched-row write-back of a table on the card: one launch
    passes = make_passes(np.random.RandomState(8), 2)
    ref = run_table(passes, FULL, "plain")
    t = PassTable(table_cfg(), seed=11, device=cuda_device)
    for p, keys in enumerate(passes):
        t.begin_feed_pass()
        t.add_keys(keys)
        t.end_feed_pass()
        t.begin_pass()
        _push(t, np.concatenate([keys[:max(1, keys.size // 2)], keys[:7]]),
              p)
        before = rk.gather_rows.launches
        t.end_pass()
        assert rk.gather_rows.launches == before + 1
        assert_bits_equal(sorted_items(t.store)[1], ref[p][2][1])
