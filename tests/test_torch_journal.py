"""The port's touched-row journal against the JAX package's: the segment
format, replay, the checkpoint plane's journal-mode snapshots, artifacts
that cross between the packages both ways, the reference's serving tailer
over a port-written journal, and merge_models.

Everything here moves rows without arithmetic, or runs the same numpy
accessor code in both packages, so every comparison is bit- or
byte-exact: segment files byte for byte, reconstructed blobs and loaded
stores bit for bit (sorted by key), merged blobs and dense.pkl bytes.
The passes are driven by hand (a deterministic edit of the touched slab
rows), on the CPU.
"""

import os
import shutil
import struct

import numpy as np
import pytest
import torch

from paddlebox_tpu.config import flags as jflags
from paddlebox_tpu.config.configs import (CheckpointConfig as JCkptCfg,
                                          SparseOptimizerConfig as JSparse,
                                          TableConfig as JTable)
from paddlebox_tpu.embedding.accessor import ValueLayout as JLayout
from paddlebox_tpu.embedding.host_store import (
    HostEmbeddingStore as JHostStore)
from paddlebox_tpu.embedding.pass_table import PassTable as JPassTable
from paddlebox_tpu.serving.refresh import JournalDeltaSource
from paddlebox_tpu.serving.store import MmapViewStack
from paddlebox_tpu.train import checkpoint as jckpt
from paddlebox_tpu.train import journal as jjr
from paddlebox_tpu.utils import journal_format as jjf

from paddlebox_tpu_torch.config.configs import (CheckpointConfig,
                                                SparseOptimizerConfig,
                                                TableConfig)
from paddlebox_tpu_torch.config.flags import CkptFlags
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.embedding import ckpt_store as cks
from paddlebox_tpu_torch.embedding.accessor import ValueLayout
from paddlebox_tpu_torch.embedding.host_store import HostEmbeddingStore
from paddlebox_tpu_torch.embedding.pass_table import PassTable
from paddlebox_tpu_torch.train import checkpoint as pckpt
from paddlebox_tpu_torch.train import journal as jr
from paddlebox_tpu_torch.utils import journal_format as jf

D = 4
CAP = 1 << 10
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
META = {"embedx_dim": D, "optimizer": "adagrad"}


def table_cfg(**kw):
    return TableConfig(embedx_dim=D, pass_capacity=CAP,
                       optimizer=SparseOptimizerConfig(**OPT), **kw)


def jtable_cfg(**kw):
    return JTable(embedx_dim=D, pass_capacity=CAP, optimizer=JSparse(**OPT),
                  **kw)


def sorted_items(store):
    keys, rows = store.state_items()
    order = np.argsort(keys)
    return keys[order], rows[order]


def sorted_blob(blob):
    order = np.argsort(blob["keys"])
    return blob["keys"][order], np.asarray(blob["values"])[order]


def assert_stores_equal(a, b):
    (ka, va), (kb, vb) = a, b
    np.testing.assert_array_equal(ka, kb)
    assert va.shape == vb.shape
    np.testing.assert_array_equal(np.ascontiguousarray(va).view(np.uint32),
                                  np.ascontiguousarray(vb).view(np.uint32))


def rand_keys(rng, n):
    return np.unique(rng.randint(1, 1 << 40, n).astype(np.uint64))


def rand_rows(rng, n, width=ValueLayout(D).width):
    v = rng.rand(n, width).astype(np.float32)
    v[:, acc.SHOW] = rng.randint(0, 30, n)
    v[:, acc.CLICK] = np.minimum(rng.randint(0, 6, n), v[:, acc.SHOW])
    v[:, acc.UNSEEN_DAYS] = rng.randint(0, 35, n)
    v[:, acc.DELTA_SCORE] = rng.choice(
        np.float32([0.0, 0.24, 0.25, 0.26, 3.0]), n)
    return v


def drive_pass(table, keys, scale=0.05):
    """One train pass over ``keys``: half of them (and the first five
    again) looked up, their slab rows edited as a push would (show, click,
    delta score, embed_w), then the touched write-back."""
    table.begin_feed_pass()
    table.add_keys(keys)
    table.end_feed_pass()
    table.begin_pass()
    sub = np.concatenate([keys[:max(1, keys.size // 2)], keys[:5]])
    ids = torch.from_numpy(np.unique(table.lookup_ids(sub)).astype(np.int64))
    with torch.no_grad():
        slab = table.slab
        slab[ids, acc.SHOW] += 1.0
        slab[ids, acc.CLICK] += (ids % 2).to(torch.float32)
        slab[ids, acc.DELTA_SCORE] += 0.5
        slab[ids, acc.EMBED_W] += scale
        slab[ids, acc.UNSEEN_DAYS] = 0.0
    table.end_pass()


def mk_cm(tmp_path, table, sub="a", async_save=False, **flags):
    return pckpt.CheckpointManager(
        CheckpointConfig(batch_model_dir=str(tmp_path / sub / "batch"),
                         xbox_model_dir=str(tmp_path / sub / "xbox"),
                         async_save=async_save), table, CkptFlags(**flags))


def run_cadence(tmp_path, sub, seed=21, mode="full", async_save=False):
    """Passes, a delta save, the day boundary and base saves with the
    journal on: a full base d0 (the anchor), then d1 in ``mode``."""
    rng = np.random.RandomState(seed)
    t = PassTable(table_cfg(), seed=seed, device="cpu")
    cm = mk_cm(tmp_path, t, sub=sub, async_save=async_save)
    base = rand_keys(rng, 500)
    drive_pass(t, base)
    cm.save_base({"w": np.float32(0)}, {}, day="d0")
    drive_pass(t, base[:base.size // 3])
    cm.save_delta("d1", delta_id=1)
    t.end_day()                                 # ages, then shrinks
    fresh = rand_keys(rng, 80)
    drive_pass(t, np.unique(np.concatenate([base[::4], fresh])))
    cm.save_base({"w": np.float32(1)}, {}, day="d1", mode=mode)
    t.end_day(age=False)
    return t, cm


# ------------------------------------------------------ the segment format

def _journal_calls(j, anchor_dir):
    """One sequence of journal calls; returns the snapshot_refs outcomes
    (refs relative to their directories, or the error)."""
    rng = np.random.RandomState(3)
    width = j.layout.width
    out = []

    def rows(n):
        j.append_rows(rand_keys(rng, n), rand_rows(rng, n, width))

    def refs():
        try:
            r = j.snapshot_refs()
        except Exception as e:  # either package's JournalIncompleteError
            return type(e).__name__
        return ([os.path.basename(p) for p in r["parts"]],
                [os.path.basename(p) for p in r["segments"]],
                r["dirty_rows"], j.dirty_rows)

    rows(12)
    j.append_event(jf.EV_STAT_SAVE_DELTA)
    rows(30)
    out.append(refs())                   # no anchor yet
    j.anchor_full([os.path.join(anchor_dir, "sparse.xman.p0000")])
    for n in (5, 40, 17):
        rows(n)
    j.append_event(jf.EV_SHRINK)
    out.append((j.snapshot_ready(), refs()))
    j.rebase([os.path.join(anchor_dir, "base.b0000")],
             [os.path.join(anchor_dir, "journal-000000.jrnl")])
    rows(9)
    j.append_event(jf.EV_AGE_DAYS)
    rows(21)
    out.append((j.snapshot_ready(), refs()))
    j.taint("a load outside the checkpoint plane")
    rows(3)
    out.append((j.snapshot_ready(), refs()))
    j.anchor_full([os.path.join(anchor_dir, "sparse.xman.p0001")])
    rows(7)
    j.close()
    return out


def _dir_bytes(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("segment_bytes,max_segments",
                         [(1 << 20, 32), (700, 32), (700, 2)],
                         ids=["one-segment", "rotation", "cap-drops"])
def test_segments_byte_identical_to_the_reference(segment_bytes,
                                                  max_segments, tmp_path):
    """The same calls to both packages' journals: the same segment files,
    byte for byte, at every step that keeps files, and the same snapshot
    references and refusals."""
    outs, dirs = {}, {}
    for tag, mod, layout, cfg in (
            ("port", jr, ValueLayout(D), table_cfg()),
            ("jax", jjr, JLayout(D), jtable_cfg())):
        dirs[tag] = str(tmp_path / tag)
        j = mod.TouchedRowJournal(dirs[tag], layout, cfg,
                                  segment_bytes=segment_bytes,
                                  max_segments=max_segments)
        outs[tag] = _journal_calls(j, str(tmp_path / "anchor"))
    assert outs["port"] == outs["jax"]
    got, want = _dir_bytes(dirs["port"]), _dir_bytes(dirs["jax"])
    assert list(got) == list(want) and got == want
    assert all(n.startswith("seg-0002-") for n in got)
    # the calls hit what the parameters aim at
    ready = [o[0] for o in outs["port"][1:3]]
    assert all(ready) == (max_segments > 2)
    (last,) = got
    # each snapshot seals a segment; rotation seals many more
    assert (int(last[9:15]) > 6) == (segment_bytes == 700)


def test_torn_tail_parses_as_the_segment_end(tmp_path):
    layout = ValueLayout(D)
    j = jr.TouchedRowJournal(str(tmp_path / "j"), layout, table_cfg())
    keys = np.arange(1, 65, dtype=np.uint64)
    vals = np.random.RandomState(1).rand(64, layout.width).astype(
        np.float32)
    j.append_rows(keys, vals)
    j.append_rows(keys, vals)
    j.close()
    (seg,) = [p for p in os.listdir(str(tmp_path / "j"))
              if p.endswith(".jrnl")]
    path = os.path.join(str(tmp_path / "j"), seg)
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:-17])  # tear the last record in its payload
    for mod in (jf, jjf):
        assert [k for k, _ in mod.iter_segment(path)] == [
            jf.KIND_HEADER, jf.KIND_ROWS]
    k, v = jf.decode_rows_payload(list(jf.iter_segment(path))[1][1])
    np.testing.assert_array_equal(k, keys)
    np.testing.assert_array_equal(v, vals)


def test_restart_sweeps_stale_segments(tmp_path):
    layout = ValueLayout(D)
    j1 = jr.TouchedRowJournal(str(tmp_path / "j"), layout, table_cfg())
    j1.append_rows(np.arange(1, 9, dtype=np.uint64),
                   np.ones((8, layout.width), np.float32))
    j1.close()
    assert any(p.endswith(".jrnl") for p in os.listdir(str(tmp_path / "j")))
    jr.TouchedRowJournal(str(tmp_path / "j"), layout, table_cfg())
    assert not any(p.endswith((".jrnl", ".open"))
                   for p in os.listdir(str(tmp_path / "j")))


def test_rotation_bound_marks_the_epoch_incomplete(tmp_path):
    """Past max_segments the oldest segment goes and snapshots refuse; a
    seal that itself trips the bound refuses too (the check runs after
    the seal)."""
    layout = ValueLayout(D)
    rng = np.random.RandomState(0)

    def rows(j):
        j.append_rows(rand_keys(rng, 64), rand_rows(rng, 64))

    j = jr.TouchedRowJournal(str(tmp_path / "a"), layout, table_cfg(),
                             segment_bytes=2048, max_segments=2)
    j.anchor_full(["/nonexistent/base.p0000"])
    for _ in range(8):
        rows(j)
    assert not j.snapshot_ready()
    with pytest.raises(jr.JournalIncompleteError, match="rotation bound"):
        j.snapshot_refs()
    j = jr.TouchedRowJournal(str(tmp_path / "b"), layout, table_cfg(),
                             segment_bytes=1 << 20, max_segments=2)
    j.anchor_full(["/nonexistent/base.p0000"])
    for _ in range(2):
        rows(j)
        with j._lock:
            j._seal_locked()
    rows(j)
    assert j.snapshot_ready()
    with pytest.raises(jr.JournalIncompleteError, match="rotation bound"):
        j.snapshot_refs()


# ------------------------------------------------------------------ replay

def _segments(d):
    return sorted(os.path.join(d, p) for p in os.listdir(d)
                  if p.endswith(".jrnl"))


def _write_journal(mod, layout, cfg, d, base_keys):
    """Rows over a base (updates and new keys), every replayable event,
    then more rows; returns the sealed segment paths."""
    rng = np.random.RandomState(9)
    j = mod.TouchedRowJournal(d, layout, cfg, segment_bytes=4096)
    j.anchor_full(["/nonexistent/base.p0000"])
    upd = base_keys[::3]
    j.append_rows(upd, rand_rows(rng, upd.size))
    new = rand_keys(rng, 60)
    j.append_rows(new, rand_rows(rng, new.size))
    for code in (jf.EV_STAT_SAVE_DELTA, jf.EV_STAT_SAVE_AGE,
                 jf.EV_AGE_DAYS, jf.EV_SHRINK):
        j.append_event(code)
    more = np.unique(np.concatenate([base_keys[1::5], new[::2],
                                     rand_keys(rng, 20)]))
    j.append_rows(more, rand_rows(rng, more.size))
    j.close()
    return _segments(d)


def test_cross_replay_bit_identical(tmp_path):
    """Each package's reconstruct_blob over the other's segments (and its
    own) gives the same rows, bit for bit."""
    rng = np.random.RandomState(5)
    keys = rand_keys(rng, 400)
    base = {"keys": keys, "values": rand_rows(rng, keys.size), **META}
    blobs = {}
    for writer, mod, layout, cfg in (
            ("port", jr, ValueLayout(D), table_cfg()),
            ("jax", jjr, JLayout(D), jtable_cfg())):
        segs = _write_journal(mod, layout, cfg, str(tmp_path / writer), keys)
        assert len(segs) > 1
        blobs[writer, "port"] = jr.reconstruct_blob(
            base, segs, ValueLayout(D), table_cfg())
        blobs[writer, "jax"] = jjr.reconstruct_blob(
            base, segs, JLayout(D), jtable_cfg())
    ref = sorted_blob(blobs["jax", "jax"])
    assert 0 < ref[0].size < keys.size + 60 + 20   # shrink deleted rows
    for k, b in blobs.items():
        assert_stores_equal(sorted_blob(b), ref)
    # the port's replay onto the native store too
    t = PassTable(table_cfg(), device="cpu")
    t.store.load_blob(base)
    jr.replay_segments(t.store, table_cfg(), _segments(str(tmp_path /
                                                           "port")))
    assert_stores_equal(sorted_items(t.store), ref)


def _union(store):
    """(keys, rows) of a store's resident and SSD-tier rows (the tier's at
    their effective values), sorted by key."""
    keys, rows = store.state_items()
    skeys, srows = store.spilled_snapshot()
    return sorted_blob({"keys": np.concatenate([keys, skeys]),
                        "values": np.vstack([rows, srows])})


@pytest.mark.parametrize("record", ["move", "tick_spill_age", "taint"])
def test_port_replay_refuses_what_it_cannot_reproduce(record, tmp_path):
    """A reference segment holding SSD-tier MOVE records (a spill, then a
    fault-in of part of it) or the tier's day tick after a spill: the
    port's replay gives the reference replay's store, resident and tier
    rows bit for bit; a watermark record is skipped, as the reference
    skips it. A taint is what the port cannot reproduce: its replay raises
    JournalIncompleteError after the rows before it."""
    d = str(tmp_path / "j")
    j = jjr.TouchedRowJournal(d, JLayout(D), jtable_cfg())
    keys = np.arange(1, 33, dtype=np.uint64)
    rows = rand_rows(np.random.RandomState(3), 32)
    j.append_rows(keys, rows)
    with j._lock:
        j._append_locked(jf.KIND_WATERMARK,
                         jf.pack_watermark(1.0, 2.0, 3.0, 4))
    if record == "taint":
        j.taint("external load")
    else:
        j.append_move(jjr.MV_SPILL, keys[:10])
        j.append_event(jf.EV_TICK_SPILL_AGE)
        if record == "move":
            j.append_move(jjr.MV_FAULT_IN, keys[2:6])
    j.append_rows(keys + np.uint64(100), rows)
    j.close()
    st = HostEmbeddingStore(ValueLayout(D), table_cfg())
    if record == "taint":
        with pytest.raises(jr.JournalIncompleteError, match="tainted"):
            jr.replay_segments(st, table_cfg(), _segments(d))
        assert len(st) == 32           # the rows before the record applied
        return
    ref = JHostStore(JLayout(D), jtable_cfg())
    n = jr.replay_segments(st, table_cfg(), _segments(d))
    assert n == jjr.replay_segments(ref, jtable_cfg(), _segments(d))
    assert n == (5 if record == "move" else 4)
    assert st.spilled_count() == ref.spilled_count() == (
        6 if record == "move" else 10)
    assert len(st) == 64 - st.spilled_count()
    got, want = _union(st), _union(ref)
    assert_stores_equal(got, want)
    # the sleeping rows aged a day: one more unseen day, show decayed
    slept = np.isin(got[0], st.spilled_keys())
    np.testing.assert_array_equal(
        got[1][slept, acc.UNSEEN_DAYS],
        rows[np.isin(keys, st.spilled_keys()), acc.UNSEEN_DAYS] + 1)


def test_cross_replay_with_moves_bit_identical(tmp_path):
    """Journals of both packages holding MOVE records (spill, tier tick,
    fault-in, more rows, a shrink): byte-identical segments, and each
    package's reconstruct_blob over either's segments the same resident
    and tier rows."""
    rng = np.random.RandomState(8)
    keys = rand_keys(rng, 300)
    base = {"keys": keys, "values": rand_rows(rng, keys.size), **META}
    upd = rand_rows(rng, keys.size // 2)
    fresh = rand_keys(rng, 40)
    fresh_rows = rand_rows(rng, fresh.size)
    segs = {}
    for writer, mod, layout, cfg in (
            ("port", jr, ValueLayout(D), table_cfg()),
            ("jax", jjr, JLayout(D), jtable_cfg())):
        d = str(tmp_path / writer)
        j = mod.TouchedRowJournal(d, layout, cfg, segment_bytes=4096)
        j.anchor_full(["/nonexistent/base.p0000"])
        j.append_move(jf.MV_SPILL, keys[::3])
        j.append_event(jf.EV_TICK_SPILL_AGE)
        j.append_rows(keys[1::2], upd)
        j.append_move(jf.MV_FAULT_IN, keys[::9])
        j.append_event(jf.EV_AGE_DAYS)
        j.append_rows(fresh, fresh_rows)
        j.append_move(jf.MV_SPILL, fresh[::2])
        j.append_event(jf.EV_SHRINK)
        j.close()
        segs[writer] = _segments(d)
    assert len(segs["port"]) == len(segs["jax"]) > 1
    for a, b in zip(segs["port"], segs["jax"]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    blobs = [mod.reconstruct_blob(base, segs[w], layout, cfg)
             for w in ("port", "jax")
             for mod, layout, cfg in ((jr, ValueLayout(D), table_cfg()),
                                      (jjr, JLayout(D), jtable_cfg()))]
    ref = sorted_blob(blobs[-1])
    assert ref[0].size > 0
    for b in blobs:
        assert_stores_equal(sorted_blob(b), ref)


# ------------------------------------------------- the checkpoint plane

def test_pass_table_journals_what_it_hands_the_store(tmp_path):
    """A full build, a delta promote's misses and each write-back appear
    as ROWS records holding the exact rows; shrink, aging and
    end_day(age=False)'s tier tick as events; a test-mode pass records
    nothing; a load outside the plane taints."""
    t = PassTable(table_cfg(), device="cpu")
    cm = mk_cm(tmp_path, t)
    seen = []
    real = cm.journal._append_locked

    def spy(kind, payload):
        seen.append((kind, payload))
        real(kind, payload)

    cm.journal._append_locked = spy
    rng = np.random.RandomState(2)
    k1 = rand_keys(rng, 200)
    drive_pass(t, k1)                          # full build, write-back
    after1 = sorted_items(t.store)
    k2 = np.unique(np.concatenate([k1[::2], rand_keys(rng, 50)]))
    drive_pass(t, k2)                          # delta promote, write-back
    kinds = [k for k, _ in seen]
    assert kinds == [jf.KIND_ROWS] * 4
    rows = [jf.decode_rows_payload(p) for _, p in seen]
    np.testing.assert_array_equal(rows[0][0], k1)
    assert not rows[0][1].any()                # created rows, all zero
    wk, wv = rows[1]
    np.testing.assert_array_equal(wk, k1[:k1.size // 2])
    np.testing.assert_array_equal(wv, after1[1][np.searchsorted(after1[0],
                                                                wk)])
    miss = k2[~np.isin(k2, k1)]
    np.testing.assert_array_equal(rows[2][0], miss)
    assert t.counters["pass_rows_promote_new"] == miss.size
    final = sorted_items(t.store)
    wk, wv = rows[3]
    np.testing.assert_array_equal(wk, k2[:k2.size // 2])
    np.testing.assert_array_equal(wv, final[1][np.searchsorted(final[0],
                                                               wk)])
    seen.clear()
    t.set_test_mode(True)
    drive_pass(t, k2)
    t.set_test_mode(False)
    assert seen == []
    t.end_day()
    t.shrink_table()
    t.end_day(age=False)
    assert [(k, struct.unpack("<I", p)[0]) for k, p in seen] == [
        (jf.KIND_EVENT, jf.EV_AGE_DAYS), (jf.KIND_EVENT, jf.EV_SHRINK),
        (jf.KIND_EVENT, jf.EV_SHRINK),
        (jf.KIND_EVENT, jf.EV_TICK_SPILL_AGE),
        (jf.KIND_EVENT, jf.EV_SHRINK)]
    cm.save_base({}, {}, day="d0")
    assert cm.journal.snapshot_ready()
    t.save(str(tmp_path / "side.xman"))
    t.load(str(tmp_path / "side.xman"))
    assert not cm.journal.snapshot_ready()
    bdir, xdir = cm.save_base({}, {}, day="d1", mode="auto")
    assert cks.read_manifest(os.path.join(bdir, "sparse.xman"))[
        "mode"] == "full" and xdir is not None


def test_replay_over_base_matches_the_live_store(tmp_path):
    """Through passes, a delta save, the day boundary and a base save:
    the anchor's base with the journal's segments replays to the live
    store, bit for bit."""
    t, cm = run_cadence(tmp_path, "jr", mode="full")
    drive_pass(t, np.arange(1, 300, dtype=np.uint64) * 19)
    assert cm.journal.snapshot_ready()
    refs = cm.journal.snapshot_refs()
    rebuilt = jr.reconstruct_blob(cm._read_base_files(refs["parts"]),
                                  refs["segments"], t.layout, t.config)
    assert_stores_equal(sorted_blob(rebuilt), sorted_items(t.store))


@pytest.mark.parametrize("async_save", [False, True])
def test_touched_save_restores_identically_to_a_full_save(async_save,
                                                          tmp_path):
    t1, cm1 = run_cadence(tmp_path, "full", seed=33, mode="full",
                          async_save=async_save)
    t2, cm2 = run_cadence(tmp_path, "touched", seed=33, mode="touched",
                          async_save=async_save)
    d1 = os.path.join(cm2.cfg.batch_model_dir, "d1")
    man = cks.read_manifest(os.path.join(d1, "sparse.xman"))
    assert man["mode"] == "journal" and man["segments"]
    assert not os.path.exists(os.path.join(cm2.cfg.xbox_model_dir, "d1",
                                           "view.xcol"))
    # the snapshot's base links share the anchor's inodes
    d0 = os.path.join(cm2.cfg.batch_model_dir, "d0")
    for i, name in enumerate(man["base"]):
        assert os.stat(os.path.join(d1, name)).st_ino == os.stat(
            os.path.join(d0, "sparse.xman.p%04d" % i)).st_ino
    cm1.load_base("d1")
    cm2.load_base("d1")
    assert_stores_equal(sorted_items(t1.store), sorted_items(t2.store))
    # the journal goes on after a load: the next 'auto' save is touched
    drive_pass(t2, np.arange(1, 150, dtype=np.uint64) * 23)
    bdir, xdir = cm2.save_base({"w": np.float32(9)}, {}, day="d2",
                               mode="auto")
    assert xdir is None
    assert cks.read_manifest(os.path.join(bdir, "sparse.xman"))[
        "mode"] == "journal"
    live = sorted_items(t2.store)
    cm2.wait()
    t3 = PassTable(table_cfg(), device="cpu")
    cm3 = mk_cm(tmp_path, t3, sub="touched")
    params, _, _ = cm3.load_base("d2")
    assert params == {"w": np.float32(9)}
    cm3.replay_base_rewrite()
    assert_stores_equal(sorted_items(t3.store), live)
    with pytest.raises(ValueError, match="journal-over-base"):
        pckpt.read_batch_sparse(bdir)


def test_touched_save_without_anchor_falls_back_full(tmp_path, caplog):
    t = PassTable(table_cfg(), device="cpu")
    drive_pass(t, np.arange(1, 200, dtype=np.uint64) * 29)
    cm = mk_cm(tmp_path, t)
    assert not cm.journal.snapshot_ready()
    bdir, xdir = cm.save_base({}, {}, day="d0", mode="auto")
    assert cks.read_manifest(os.path.join(bdir, "sparse.xman"))[
        "mode"] == "full" and xdir is not None
    cm2 = mk_cm(tmp_path, PassTable(table_cfg(), device="cpu"), sub="b")
    bdir, xdir = cm2.save_base({}, {}, day="d0", mode="touched")
    assert "falling back to FULL" in caplog.text
    assert cks.read_manifest(os.path.join(bdir, "sparse.xman"))[
        "mode"] == "full" and xdir is not None


def test_touched_save_io_death_falls_back_full(tmp_path, caplog):
    """An anchor part that is gone (pruned, or never written by a writer
    that died) degrades to a full save with a warning."""
    t, cm = run_cadence(tmp_path, "io", seed=55, mode="full")
    drive_pass(t, np.arange(1, 120, dtype=np.uint64) * 43)
    cm.journal.rebase(["/nonexistent/base.p0000"], [])
    assert cm.journal.snapshot_ready()
    want = sorted_items(t.store)
    bdir, xdir = cm.save_base({}, {}, day="d9", mode="touched")
    assert "falling back to FULL" in caplog.text
    assert cks.read_manifest(os.path.join(bdir, "sparse.xman"))[
        "mode"] == "full" and xdir is not None
    assert_stores_equal(sorted_blob(pckpt.read_batch_sparse(bdir)), want)
    # the fallback re-anchored: the next touched save is whole again
    bdir, xdir = cm.save_base({}, {}, day="d10", mode="touched")
    assert xdir is None


def test_snapshot_survives_pruning_its_base_dir(tmp_path):
    """A touched snapshot hard-links its base: deleting the original base
    directory leaves it loadable, and the journal (rebased onto the
    snapshot's own links) serves the next touched save."""
    t, cm = run_cadence(tmp_path, "pr", seed=44, mode="touched")
    d1 = os.path.join(cm.cfg.batch_model_dir, "d1")
    oracle = cm._reconstruct_journal_manifest(
        d1, cks.read_manifest(os.path.join(d1, "sparse.xman")))
    shutil.rmtree(os.path.join(cm.cfg.batch_model_dir, "d0"))
    drive_pass(t, np.arange(1, 100, dtype=np.uint64) * 37)
    live = sorted_items(t.store)
    bdir, xdir = cm.save_base({}, {}, day="d2", mode="touched")
    assert xdir is None
    cm.load_base("d1")
    assert_stores_equal(sorted_items(t.store), sorted_blob(oracle))
    cm.load_base("d2")
    assert_stores_equal(sorted_items(t.store), live)


# ------------------------------------------- artifacts across the packages

def test_port_snapshot_loads_in_the_reference(tmp_path):
    """A port-written journal-mode snapshot through the reference's
    CheckpointManager.load_base (its JAX PassTable): the store bit-equal
    to the port's own load."""
    t, cm = run_cadence(tmp_path, "p", seed=61, mode="touched")
    d1 = os.path.join(cm.cfg.batch_model_dir, "d1")
    assert cks.read_manifest(os.path.join(d1, "sparse.xman"))[
        "mode"] == "journal"
    mine = PassTable(table_cfg(), device="cpu")
    mk_cm(tmp_path, mine, sub="p").load_base("d1")
    jflags.set_flag("flatten_dense_opt", False)
    jt = JPassTable(jtable_cfg())
    params, _, _ = jckpt.CheckpointManager(
        JCkptCfg(batch_model_dir=cm.cfg.batch_model_dir,
                 xbox_model_dir=cm.cfg.xbox_model_dir,
                 async_save=False), jt).load_base("d1")
    assert params == {"w": np.float32(1)}
    assert_stores_equal(sorted_items(jt.store), sorted_items(mine.store))


def test_reference_snapshot_loads_in_the_port(tmp_path):
    """A reference-written journal-mode snapshot (the JAX PassTable with
    the journal on, a full base then an 'auto' save) through the port's
    load_base: the store bit-equal to the reference's own load. The
    reference's dense.pkl holds numpy here (the port refuses jax
    arrays)."""
    jflags.set_flag("ckpt_journal", True)
    jflags.set_flag("flatten_dense_opt", False)
    rng = np.random.RandomState(8)
    jt = JPassTable(jtable_cfg())
    keys = rand_keys(rng, 300)
    jt.store.load_blob({"keys": keys, "values": rand_rows(rng, keys.size),
                        **META})
    cfg = JCkptCfg(batch_model_dir=str(tmp_path / "batch"),
                   xbox_model_dir=str(tmp_path / "xbox"), async_save=False)
    jcm = jckpt.CheckpointManager(cfg, jt)
    assert jcm.journal is not None
    jcm.save_base({"w": np.ones(2, np.float32)}, {}, day="d0")
    upd = np.unique(np.concatenate([keys[::3], rand_keys(rng, 40)]))
    jt.begin_feed_pass()
    jt.add_keys(upd)
    jt.end_feed_pass()
    jt.begin_pass()
    jt.lookup_ids(upd[::2])
    jt.end_pass()
    jt.end_day()
    bdir, xdir = jcm.save_base({"w": np.ones(2, np.float32)}, {}, day="d1",
                               mode="auto")
    assert xdir is None
    assert cks.read_manifest(os.path.join(bdir, "sparse.xman"))[
        "mode"] == "journal"
    jt2 = JPassTable(jtable_cfg())
    jckpt.CheckpointManager(cfg, jt2).load_base("d1")
    pt = PassTable(table_cfg(), device="cpu")
    params, _, _ = pckpt.CheckpointManager(
        CheckpointConfig(batch_model_dir=cfg.batch_model_dir,
                         xbox_model_dir=cfg.xbox_model_dir), pt).load_base(
        "d1")
    assert_stores_equal(sorted_items(pt.store), sorted_items(jt2.store))
    np.testing.assert_array_equal(params["w"], np.ones(2, np.float32))


def test_reference_snapshot_across_the_day_tick_loads_in_the_port(
        tmp_path):
    """A reference journal-mode snapshot whose epoch spans
    end_day(age=False), which journals the SSD tier's day tick: a full
    base at d0, the day tick and shrink, one pass, an 'auto' save at d1.
    The port's load_base gives the store of the reference's own load, bit
    for bit. A port table fed the same calls writes the same journal
    segments, byte for byte, tick included."""
    jflags.set_flag("ckpt_journal", True)
    jflags.set_flag("flatten_dense_opt", False)
    rng = np.random.RandomState(12)
    keys = rand_keys(rng, 300)
    blob = {"keys": keys, "values": rand_rows(rng, keys.size), **META}
    upd = np.unique(np.concatenate([keys[::3], rand_keys(rng, 40)]))
    jt = JPassTable(jtable_cfg())
    pt = PassTable(table_cfg(), device="cpu")
    dirs = {}
    for tag, t, mk in (
            ("jax", jt, lambda d, t: jckpt.CheckpointManager(
                JCkptCfg(batch_model_dir=d + "/batch",
                         xbox_model_dir=d + "/xbox", async_save=False), t)),
            ("port", pt, lambda d, t: pckpt.CheckpointManager(
                CheckpointConfig(batch_model_dir=d + "/batch",
                                 xbox_model_dir=d + "/xbox",
                                 async_save=False), t))):
        t.store.load_blob(blob)
        d = str(tmp_path / tag)
        cm = mk(d, t)
        cm.save_base({"w": np.ones(2, np.float32)}, {}, day="d0")
        t.end_day(age=False)
        t.begin_feed_pass()
        t.add_keys(upd)
        t.end_feed_pass()
        t.begin_pass()
        t.lookup_ids(upd[::2])
        t.end_pass()
        bdir, xdir = cm.save_base({"w": np.ones(2, np.float32)}, {},
                                  day="d1", mode="auto")
        assert xdir is None
        assert cks.read_manifest(os.path.join(bdir, "sparse.xman"))[
            "mode"] == "journal"
        dirs[tag] = bdir
    # the snapshot's segments (hard links of the sealed journal files)
    got, want = ({n: b for n, b in _dir_bytes(dirs[tag]).items()
                  if n.endswith(".jrnl")} for tag in ("port", "jax"))
    assert list(got) == list(want) and got == want
    tick = struct.pack("<I", jf.EV_TICK_SPILL_AGE)
    assert any((k, p) == (jf.KIND_EVENT, tick)
               for seg in _segments(dirs["jax"])
               for k, p in jf.iter_segment(seg))
    jt2 = JPassTable(jtable_cfg())
    jckpt.CheckpointManager(
        JCkptCfg(batch_model_dir=str(tmp_path / "jax/batch"),
                 xbox_model_dir=str(tmp_path / "jax/xbox"),
                 async_save=False), jt2).load_base("d1")
    loaded = PassTable(table_cfg(), device="cpu")
    params, _, _ = pckpt.CheckpointManager(
        CheckpointConfig(batch_model_dir=str(tmp_path / "jax/batch"),
                         xbox_model_dir=str(tmp_path / "jax/xbox")),
        loaded, CkptFlags(ckpt_journal=False)).load_base("d1")
    assert_stores_equal(sorted_items(loaded.store), sorted_items(jt2.store))
    assert_stores_equal(sorted_items(pt.store), sorted_items(jt.store))
    np.testing.assert_array_equal(params["w"], np.ones(2, np.float32))


def test_reference_tailer_serves_a_port_journal(tmp_path):
    """serving/refresh.py's JournalDeltaSource tails the port's journal
    directory: its overlay serves each touched key's xbox columns of the
    port's store, bit for bit."""
    t = PassTable(table_cfg(), device="cpu")
    cm = mk_cm(tmp_path, t)
    src = JournalDeltaSource([cm.journal.dir])
    try:
        rng = np.random.RandomState(4)
        keys = rand_keys(rng, 300)
        drive_pass(t, keys)
        assert src.poll()
        drive_pass(t, keys[::2], scale=0.25)
        assert src.poll()
        stack = MmapViewStack([], extra_files=(src.compile_overlay(),))
        sk, sv = sorted_items(t.store)
        cols = jf.xbox_embed_cols(D, "adagrad")
        np.testing.assert_array_equal(cols, jjf.xbox_embed_cols(D,
                                                                "adagrad"))
        got = stack.lookup(sk)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      np.ascontiguousarray(
                                          sv[:, cols]).view(np.uint32))
    finally:
        src.close()


# ------------------------------------------------------------ merge_models

@pytest.mark.parametrize("fmt", ["columnar", "pickle"])
def test_merge_models_matches_the_reference(fmt, tmp_path):
    """Both packages' merge_models over the same port-written full bases:
    the same blob bit for bit and the same dense.pkl bytes; both refuse a
    journal-mode snapshot."""
    dirs = []
    rng = np.random.RandomState(12)
    shared = rand_keys(rng, 150)
    for i in range(3):
        t = PassTable(table_cfg(), device="cpu")
        keys = np.unique(np.concatenate([shared, rand_keys(rng, 60)]))
        t.store.load_blob({"keys": keys, "values": rand_rows(
            rng, keys.size), **META})
        cm = mk_cm(tmp_path, t, sub="m%d" % i, ckpt_format=fmt)
        cm.save_base({"w": np.full(3, i, np.float32)}, {"count": i},
                     day="d0")
        dirs.append(os.path.join(cm.cfg.batch_model_dir, "d0"))
    jflags.set_flag("ckpt_format", fmt)
    out_p = pckpt.merge_models(dirs, str(tmp_path / "out_p"),
                               CkptFlags(ckpt_format=fmt))
    out_j = jckpt.merge_models(dirs, str(tmp_path / "out_j"))
    name = "sparse.pkl" if fmt == "pickle" else "sparse.xman"
    assert os.path.exists(os.path.join(out_p, name))
    bp = pckpt.read_batch_sparse(out_p)
    bj = jckpt.read_batch_sparse(out_j)
    assert_stores_equal(sorted_blob(bp), sorted_blob(bj))
    np.testing.assert_array_equal(bp["keys"], bj["keys"])
    assert bp["keys"].size == np.unique(np.concatenate(
        [pckpt.read_batch_sparse(d)["keys"] for d in dirs])).size
    with open(os.path.join(out_p, "dense.pkl"), "rb") as a, \
            open(os.path.join(out_j, "dense.pkl"), "rb") as b, \
            open(os.path.join(dirs[0], "dense.pkl"), "rb") as c:
        assert a.read() == b.read() == c.read()
    assert os.path.exists(os.path.join(out_p, "DONE"))
    # a journal-mode snapshot: both refuse it
    t, cm = run_cadence(tmp_path, "jm", mode="touched")
    jdir = os.path.join(cm.cfg.batch_model_dir, "d1")
    for merge in (lambda: pckpt.merge_models([jdir], str(tmp_path / "x")),
                  lambda: jckpt.merge_models([jdir], str(tmp_path / "y"))):
        with pytest.raises(ValueError, match="journal-over-base"):
            merge()
