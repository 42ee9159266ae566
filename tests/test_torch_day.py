"""The port's day cadence against the JAX package: test-mode eval, the day
boundary and the checkpoint plane, and a port-written day served by the
reference's serving/ readers.

The same inputs, made from a seed with numpy, go through both packages on
the CPU; the JAX trainer runs with use_pallas_push (its kernel
interpreted), columnar data and ckpt_journal off. Tolerances:

  * the day's row arithmetic (decay, delete mask, the stat rewrites), the
    stores' lifecycle, the sparse tier's files and the xbox views, from
    the same rows in both packages: bit-exact (numpy f32 in the same
    order, the same file format);
  * test-mode passes against the JAX PassTable and against the port's
    full path: bit-exact (rows move without arithmetic);
  * predict_batches and run_day after training: preds rtol 1e-5, loss
    rtol 1e-4, AUC 1e-4 absolute, trained store rows rtol 1e-4 with the
    key sets and the integer columns exact (float32 sums taken in another
    order by XLA and ATen, as in tests/test_torch_train.py);
  * resume equals continue, in the port: bit-exact.
"""

import dataclasses
import functools
import json
import logging
import os
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.config import flags as jflags
from paddlebox_tpu.config.configs import (CheckpointConfig as JCkptCfg,
                                          SparseOptimizerConfig as JSparse,
                                          TableConfig as JTable,
                                          TrainerConfig as JTrainerCfg)
from paddlebox_tpu.data.dataset import BoxDataset as JDataset
from paddlebox_tpu.data.generator import write_synthetic_ctr_files
from paddlebox_tpu.embedding import ckpt_store as jcks
from paddlebox_tpu.embedding.accessor import ValueLayout as JLayout
from paddlebox_tpu.embedding.host_store import (
    HostEmbeddingStore as JHostStore)
from paddlebox_tpu.embedding.pass_table import PassTable as JPassTable
from paddlebox_tpu.models.base import ModelSpec as JSpec
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.serving import store as jserving
from paddlebox_tpu.train import checkpoint as jckpt
from paddlebox_tpu.train.trainer import BoxTrainer as JTrainer

from paddlebox_tpu_torch.config.configs import (CheckpointConfig,
                                                DataFeedConfig, SlotConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.config.flags import CkptFlags, PassFlags, PushFlags
from paddlebox_tpu_torch.convert import (adam_state_from_optax,
                                         params_from_jax)
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.embedding import ckpt_store as cks
from paddlebox_tpu_torch.embedding.accessor import ValueLayout
from paddlebox_tpu_torch.embedding.host_store import (_GROW,
                                                      HostEmbeddingStore)
from paddlebox_tpu_torch.embedding.native_store import \
    NativeHostEmbeddingStore
from paddlebox_tpu_torch.embedding.pass_table import PassTable
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.serving import store as pserving
from paddlebox_tpu_torch.train import checkpoint as pckpt
from paddlebox_tpu_torch.train.eval_driver import simple_predict_batches
from paddlebox_tpu_torch.train.trainer import BoxTrainer

D = 4
CAP = 1 << 10
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
INT_COLS = [acc.SLOT, acc.SHOW, acc.CLICK, acc.UNSEEN_DAYS, acc.MF_SIZE]
META = {"embedx_dim": D, "optimizer": "adagrad"}


def table_cfg(d=D, **kw):
    return TableConfig(embedx_dim=d, pass_capacity=CAP,
                       optimizer=SparseOptimizerConfig(**OPT), **kw)


def jtable_cfg(d=D, **kw):
    return JTable(embedx_dim=d, pass_capacity=CAP, optimizer=JSparse(**OPT),
                  **kw)


def sorted_items(store):
    keys, rows = store.state_items()
    order = np.argsort(keys)
    return keys[order], rows[order]


def assert_bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(np.ascontiguousarray(a).view(np.uint32),
                                  np.ascontiguousarray(b).view(np.uint32))


def assert_stores_equal(a, b):
    (ka, va), (kb, vb) = a, b
    np.testing.assert_array_equal(ka, kb)
    assert_bits_equal(va, vb)


def assert_rows_close(got, want, rtol=1e-4):
    np.testing.assert_array_equal(got[:, INT_COLS], want[:, INT_COLS])
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7)


def random_rows(rng, n, width):
    """Store rows with integer show/click, unseen days around the delete
    and delta-keep limits, and delta scores around the delta threshold."""
    v = rng.rand(n, width).astype(np.float32)
    v[:, acc.SHOW] = rng.randint(0, 30, n)
    v[:, acc.CLICK] = np.minimum(rng.randint(0, 6, n), v[:, acc.SHOW])
    v[:, acc.UNSEEN_DAYS] = rng.randint(0, 35, n)
    v[:, acc.DELTA_SCORE] = rng.choice(
        np.float32([0.0, 0.24, 0.25, 0.26, 3.0]), n)
    return v


# ------------------------------------------------ the day's row arithmetic

EDGE_TABLES = {
    "defaults": {},
    # no decay and thresholds on integer grid points: scores land exactly
    # on the delete and base thresholds, unseen days on both day limits
    "edges": dict(show_click_decay_rate=1.0, delete_threshold=1.0,
                  base_threshold=2.0, delta_threshold=0.25,
                  delete_after_unseen_days=3.0, delta_keep_days=3.0),
}


def _edge_rows(rng, width):
    v = random_rows(rng, 4000, width)
    # score = 0.1 * (show - click) + click: show 10 click 0 scores 1.0,
    # show 11 click 1 scores 2.0
    v[:8, acc.SHOW] = [10, 10, 11, 11, 0, 0, 2, 2]
    v[:8, acc.CLICK] = [0, 0, 1, 1, 0, 0, 1, 1]
    v[:8, acc.UNSEEN_DAYS] = [3, 4, 3, 4, 0, 30, 31, 16]
    v[8, acc.SHOW] = -0.0
    v[9, acc.DELTA_SCORE] = -0.0
    return v


@pytest.mark.parametrize("tname", sorted(EDGE_TABLES))
@pytest.mark.parametrize("op", ["shrink_mask", "stat_1", "stat_3"])
def test_day_arithmetic_matches_jax_bitwise(op, tname):
    kw = EDGE_TABLES[tname]
    port, ref = ValueLayout(D), JLayout(D, "adagrad")
    pt, jt = table_cfg(**kw), jtable_cfg(**kw)
    rows = _edge_rows(np.random.RandomState(3), port.width)
    a, b = rows.copy(), rows.copy()
    if op == "shrink_mask":
        got, want = port.shrink_mask(a, pt), ref.shrink_mask(b, jt)
        np.testing.assert_array_equal(got, want)
        assert got.any() and not got.all()
    else:
        param = int(op[-1])
        port.update_stat_after_save(a, pt, param)
        ref.update_stat_after_save(b, jt, param)
        assert not np.array_equal(a, rows)
    assert_bits_equal(a, b)
    assert_bits_equal(port.show_click_score(rows[:, acc.SHOW],
                                            rows[:, acc.CLICK], pt.optimizer),
                      ref.show_click_score(rows[:, acc.SHOW],
                                           rows[:, acc.CLICK], jt.optimizer))


# ----------------------------------------------------- the stores' lifecycle

def _three_stores(seed=5):
    cfg = TableConfig(embedx_dim=D, pass_capacity=CAP,
                      optimizer=SparseOptimizerConfig(initial_range=0.05,
                                                      **OPT))
    jcfg = JTable(embedx_dim=D, pass_capacity=CAP,
                  optimizer=JSparse(initial_range=0.05, **OPT))
    return {"plain": HostEmbeddingStore(ValueLayout(D), cfg, seed),
            "native": NativeHostEmbeddingStore(ValueLayout(D), cfg, seed),
            "jax": JHostStore(JLayout(D, "adagrad"), jcfg, seed)}, cfg


@pytest.mark.parametrize("n", [0, 500, _GROW + 1000],
                         ids=["empty", "small", "past_capacity"])
def test_store_lifecycle_matches_jax_bitwise(n, tmp_path):
    """create -> age -> shrink -> stat-after-save -> save -> load, then
    creation past the loaded rows, in the port's two stores and the JAX
    plain store: bit-equal sorted state and equal deletion counts."""
    stores, cfg = _three_stores()
    rng = np.random.RandomState(n)
    keys = np.unique(rng.randint(1, 1 << 40, n).astype(np.uint64))
    vals = random_rows(rng, keys.size, ValueLayout(D).width)
    for s in stores.values():
        created = s.lookup_or_create(keys)
        assert created.shape == (keys.size, ValueLayout(D).width)
        if keys.size:
            s.write_back(keys, vals)
    states = {}
    for name, s in stores.items():
        s.age_unseen_days()
        deleted = s.shrink()
        s.update_stat_after_save(cfg, 1)
        s.update_stat_after_save(cfg, 3)
        states[name] = (deleted, len(s), sorted_items(s))
    ref = states["jax"]
    assert (ref[0] > 0) == (n > 0) and ref[1] < max(keys.size, 1)
    for name in ("plain", "native"):
        assert states[name][:2] == ref[:2], name
        assert_stores_equal(states[name][2], ref[2])
    # save, then load into fresh stores: each store's own file
    fresh, _ = _three_stores(seed=9)
    for name, s in stores.items():
        path = str(tmp_path / name / "sparse.xman")
        s.save(path)
        fresh[name].load(path)
        assert_stores_equal(sorted_items(fresh[name]), ref[2])
    # creation after a load takes free rows and clobbers no loaded row
    new = np.unique(rng.randint(1 << 41, 1 << 42, 300).astype(np.uint64))
    made = {name: s.lookup_or_create(new) for name, s in fresh.items()}
    for name in ("plain", "native"):
        assert_bits_equal(made[name], made["jax"])
        assert_stores_equal(sorted_items(fresh[name]),
                            sorted_items(fresh["jax"]))
    if ref[2][0].size:
        assert_bits_equal(fresh["plain"].lookup(ref[2][0]), ref[2][1])


def test_store_load_refuses_a_bad_blob():
    stores, _ = _three_stores()
    for name in ("plain", "native"):
        s = stores[name]
        with pytest.raises(ValueError, match="layout"):
            s.load_blob({"keys": np.uint64([1]),
                         "values": np.zeros((1, 99), np.float32),
                         "embedx_dim": 7, "optimizer": "adagrad"})
        with pytest.raises(ValueError, match="twice"):
            s.load_blob({"keys": np.uint64([3, 3]),
                         "values": np.zeros((2, ValueLayout(D).width),
                                            np.float32), **META})


# ------------------------------------------- the sparse tier across packages

@pytest.mark.parametrize("fmt", ["columnar", "pickle"])
def test_sparse_tier_crosses_packages(fmt, tmp_path):
    """A port-written sparse tier loads through the reference's loaders bit
    for bit, a JAX-written one through the port's PassTable.load; the
    columnar files are byte-identical for the same rows."""
    rng = np.random.RandomState(11)
    keys = np.unique(rng.randint(1, 1 << 40, 3000).astype(np.uint64))
    vals = random_rows(rng, keys.size, ValueLayout(D).width)
    name = "sparse.xman" if fmt == "columnar" else "sparse.pkl"
    port_path = str(tmp_path / "port" / name)
    jax_path = str(tmp_path / "jax" / name)
    cks.save_sparse_auto(port_path, keys, vals, META, fmt=fmt, parts=5)
    jflags.set_flag("ckpt_format", fmt)
    jflags.set_flag("ckpt_parts", 5)
    jcks.save_sparse_auto(jax_path, keys, vals, META)
    # the reference reads the port's file, the port the reference's
    for blob in (jcks.load_sparse_any(port_path),
                 cks.load_sparse_any(jax_path)):
        np.testing.assert_array_equal(blob["keys"], keys)
        assert_bits_equal(blob["values"], vals)
        assert (blob["embedx_dim"], blob["optimizer"]) == (D, "adagrad")
    if fmt == "columnar":
        assert cks.manifest_part_paths(port_path) == [
            port_path + ".p%04d" % i for i in range(5)]
        for a, b in zip([port_path] + cks.manifest_part_paths(port_path),
                        [jax_path] + jcks.manifest_part_paths(jax_path)):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), a
        got = jcks.load_sparse_columnar(port_path)
        np.testing.assert_array_equal(got["keys"], keys)
    # the PassTable of each package over the other's file, and over a
    # PassTable.save of the port
    pt = PassTable(table_cfg(), device="cpu")
    pt.load(jax_path)
    assert pt.load_ssd_to_mem() == 0
    jt = JPassTable(jtable_cfg())
    jt.load(port_path)
    want = sorted_items(pt.store)
    assert_stores_equal(sorted_items(jt.store), want)
    np.testing.assert_array_equal(want[0], keys)
    table_path = str(tmp_path / "table" / name)
    pt.save(table_path, CkptFlags(ckpt_format=fmt, ckpt_parts=3))
    jt2 = JPassTable(jtable_cfg())
    jt2.load(table_path)
    assert_stores_equal(sorted_items(jt2.store), want)


# ------------------------------------------------ the day plane, bit-exact

def _day_from_rows(pkg, root, keys, vals, touched, rows2, store_kind):
    """A day written from the same rows by ``pkg`` ('port' or 'jax'): the
    store loaded from (keys, vals), delta 1, the rows of ``touched``
    rewritten to ``rows2`` (a pass's write-back), delta 2, the base and
    end_day(age=False). Returns (the table, rows deleted, the day's
    (batch_dir, xbox_dir))."""
    blob = {"keys": keys, "values": vals, **META}
    if pkg == "port":
        store = (HostEmbeddingStore(ValueLayout(D), table_cfg())
                 if store_kind == "plain" else None)
        table = PassTable(table_cfg(), device="cpu", store=store)
        cm = pckpt.CheckpointManager(
            CheckpointConfig(batch_model_dir=os.path.join(root, "batch"),
                             xbox_model_dir=os.path.join(root, "xbox")),
            table)
        params, opt = {"w": np.arange(3, dtype=np.float32)}, {"count": 0}
    else:
        jflags.set_flag("ckpt_journal", False)
        table = JPassTable(jtable_cfg())
        cm = jckpt.CheckpointManager(
            JCkptCfg(batch_model_dir=os.path.join(root, "batch"),
                     xbox_model_dir=os.path.join(root, "xbox")), table)
        params, opt = {"w": np.arange(3, dtype=np.float32)}, {"count": 0}
    table.store.load_blob(blob)
    cm.save_delta("d0", 1)
    table.store.write_back(touched, rows2)
    cm.save_delta("d0", 2)
    dirs = cm.save_base(params, opt, "d0")
    deleted = table.end_day(age=False)
    cm.wait()
    return table, deleted, dirs


@pytest.fixture(scope="module")
def day_rows():
    rng = np.random.RandomState(21)
    keys = np.unique(rng.randint(1, 1 << 40, 2500).astype(np.uint64))
    vals = random_rows(rng, keys.size, ValueLayout(D).width)
    touched = keys[::3]
    rows2 = random_rows(rng, touched.size, ValueLayout(D).width)
    return keys, vals, touched, rows2


@pytest.fixture(scope="module")
def jax_day(day_rows, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jax_day"))
    saved = jflags.get_flag("ckpt_journal")
    try:
        table, deleted, dirs = _day_from_rows("jax", root, *day_rows, None)
    finally:
        jflags.set_flag("ckpt_journal", saved)
    return root, sorted_items(table.store), deleted, dirs


@pytest.mark.parametrize("store_kind", ["native", "plain"])
def test_day_plane_matches_jax_bitwise(store_kind, day_rows, jax_day,
                                       tmp_path):
    """From the same rows: the deltas' and the base's view.xcol byte for
    byte, the base's sparse tier and the store after end_day bit for bit,
    equal deletions."""
    jroot, jstore, jdeleted, jdirs = jax_day
    root = str(tmp_path)
    table, deleted, dirs = _day_from_rows("port", root, *day_rows,
                                          store_kind)
    assert deleted == jdeleted > 0
    assert_stores_equal(sorted_items(table.store), jstore)
    for view in ("d0/delta-1", "d0/delta-2", "d0"):
        with open(os.path.join(root, "xbox", view, "view.xcol"), "rb") as f:
            got = f.read()
        with open(os.path.join(jroot, "xbox", view, "view.xcol"), "rb") as f:
            assert got == f.read(), view
    want = jcks.load_sparse_columnar(os.path.join(jdirs[0], "sparse.xman"))
    got = jcks.load_sparse_columnar(os.path.join(dirs[0], "sparse.xman"))
    order_w, order_g = np.argsort(want["keys"]), np.argsort(got["keys"])
    np.testing.assert_array_equal(got["keys"][order_g],
                                  want["keys"][order_w])
    assert_bits_equal(got["values"][order_g], want["values"][order_w])
    # the reference's own readers take the port's batch directory
    blob = jckpt.read_batch_sparse(dirs[0])
    assert_bits_equal(blob["values"], got["values"])


def test_port_day_is_served_by_the_reference(day_rows, jax_day, tmp_path):
    """The reference's serving readers over a port-written day (two deltas
    and the base) return the rows they return over the JAX package's day
    from the same rows."""
    jroot = jax_day[0]
    root = str(tmp_path)
    _day_from_rows("port", root, *day_rows, "native")
    keys = day_rows[0]
    probe = np.concatenate([keys, np.uint64([7, 1 << 50])])
    rows = {}
    for tag, r in (("port", root), ("jax", jroot)):
        xbox = os.path.join(r, "xbox")
        reader = jckpt.XboxModelReader(xbox, "d0")
        stack, sources = jserving.build_stack(xbox, ["d0"])
        views = [jserving.read_xbox_view(s.path) for s in sources]
        mm = jserving.MmapXboxStore(os.path.join(xbox, "d0", "view.xcol"))
        rows[tag] = (reader.lookup(probe), stack.lookup(probe),
                     mm.lookup(probe), views, len(sources))
        # the port's reader agrees with the reference's, and its composed
        # file serves through the reference's mmap store
        preader = pckpt.XboxModelReader(xbox, "d0")
        assert_bits_equal(preader.lookup(probe), rows[tag][0])
        composed = jserving.MmapXboxStore(preader.save_columnar(
            os.path.join(r, "composed.xcol")))
        assert_bits_equal(composed.lookup(probe), rows[tag][0])
        composed.close()
        stack.close()
        mm.close()
    assert rows["port"][4] == rows["jax"][4] == 3
    for a, b in zip(rows["port"][:3], rows["jax"][:3]):
        assert_bits_equal(a, b)
    for (ka, ra), (kb, rb) in zip(rows["port"][3], rows["jax"][3]):
        np.testing.assert_array_equal(ka, kb)
        assert_bits_equal(ra, rb)
    assert not rows["port"][0][-2:].any() and rows["port"][0][:-2].any()


# ------------------------------------------------------------- test mode

def _mutate(table, keys, p, jax_table=False):
    """A train pass's row update, exact in both packages: the rows of
    ``keys`` (through lookup_ids, so they are touched) get show + 1 and
    embed_w + 0.5 * (p + 1)."""
    ids = table.lookup_ids(keys)
    delta = np.zeros((ids.size, table.layout.width), np.float32)
    delta[:, acc.SHOW] = 1.0
    delta[:, acc.EMBED_W] = 0.5 * (p + 1)
    if jax_table:
        table.set_slab(table.slab.at[jnp.asarray(ids)].add(
            jnp.asarray(delta)))
    else:
        table.slab.index_add_(0, torch.from_numpy(ids.astype(np.int64)),
                              torch.from_numpy(delta))


def _run_test_mode(kind, train_keys, test_keys):
    """Train passes over train_keys[0], [1], an eval pass over test_keys,
    then train_keys[2]; ``kind`` 'port'/'port_full'/'jax'. Returns the
    eval pass's pulled rows, the store after each pass and the port's
    counters of each pass."""
    if kind == "jax":
        jflags.set_flag("incremental_pass", True)
        t = JPassTable(jtable_cfg(), seed=3)
    else:
        t = PassTable(table_cfg(), seed=3, device="cpu",
                      flags=(PassFlags() if kind == "port"
                             else PassFlags(incremental_pass=False)))
    out = {"stores": [], "counters": []}

    def one(keys, test):
        before = dict(getattr(t, "counters", {}))
        t.set_test_mode(test)
        t.begin_feed_pass()
        t.add_keys(keys)
        t.end_feed_pass()
        t.begin_pass()
        if test:
            ids = t.lookup_ids(keys)
            out["eval"] = np.asarray(t.slab)[ids].copy()
        else:
            _mutate(t, keys[::2], len(out["stores"]), kind == "jax")
        t.end_pass()
        t.set_test_mode(False)
        out["stores"].append(sorted_items(t.store))
        if before:
            out["counters"].append({k: v - before[k]
                                    for k, v in t.counters.items()})

    one(train_keys[0], False)
    one(train_keys[1], False)
    one(test_keys, True)
    one(train_keys[2], False)
    return out


@pytest.mark.parametrize("overlap", [0.0, 0.85, 1.0])
def test_test_mode_matches_jax_and_full_path(overlap):
    rng = np.random.RandomState(int(overlap * 100))
    a = np.unique(rng.randint(1, 1 << 30, 400).astype(np.uint64))
    b = np.unique(np.concatenate([a[::2], rng.randint(
        1 << 31, 1 << 32, 200).astype(np.uint64)]))
    c = np.unique(np.concatenate([b[::3], a[1::4]]))
    present = np.setdiff1d(a, b)  # in the store, not resident
    unseen = np.unique((rng.randint(0, 1 << 20, 64) + (7 << 40))
                       .astype(np.uint64))
    n_res = int(round(overlap * 100))
    test_keys = np.unique(np.concatenate(
        [b[:n_res]] + ([] if overlap == 1.0 else [present[:50], unseen])))
    runs = {k: _run_test_mode(k, (a, b, c), test_keys)
            for k in ("port", "port_full", "jax")}
    for k in ("port_full", "jax"):
        assert_bits_equal(runs["port"]["eval"], runs[k]["eval"])
        for s, w in zip(runs["port"]["stores"], runs[k]["stores"]):
            assert_stores_equal(s, w)
    port = runs["port"]
    # the eval pass created nothing and wrote nothing back
    assert_stores_equal(port["stores"][2], port["stores"][1])
    assert not np.isin(unseen, port["stores"][2][0]).any()
    ev = port["eval"]
    miss = np.isin(test_keys, unseen)
    assert not ev[miss].any() and miss.any() == (overlap < 1.0)
    sk, sv = port["stores"][1]
    assert_bits_equal(ev[~miss], sv[np.searchsorted(sk, test_keys[~miss])])
    resident = np.isin(test_keys, b)
    cnt = port["counters"]
    assert cnt[2]["pass_rows_promote_hit"] == resident.sum()
    assert cnt[2]["pass_rows_promote_new"] == test_keys.size - resident.sum()
    assert cnt[2]["pass_rows_written_back"] == 0
    # residency dropped: the next train pass builds in full
    assert cnt[3]["pass_rows_promote_hit"] == 0
    assert cnt[3]["pass_rows_promote_new"] == 0
    assert cnt[3]["pass_rows_written_back"] == np.unique(c[::2]).size
    assert all(not any(c.values()) for c in runs["port_full"]["counters"])


def test_test_mode_keeps_staged_rows_and_hands_out_no_prefetch():
    t = PassTable(table_cfg(), device="cpu")
    keys = np.arange(1, 50, dtype=np.uint64)
    t.begin_feed_pass()
    t.add_keys(keys)
    t.end_feed_pass()
    assert t.promote_prefetch_ctx() is not None
    staged = (np.uint64([3, 4]), np.ones((2, t.layout.width), np.float32))
    t.accept_staged_rows(*staged)
    t.set_test_mode(True)
    assert t.test_mode and t.promote_prefetch_ctx() is None
    t.begin_pass()
    assert len(t.store) == 0  # nothing created
    t.lookup_ids(keys)
    t.end_pass()
    # neither used nor cleared
    assert all(a is b for a, b in zip(t._staged, staged))
    t.set_test_mode(False)
    t.begin_pass()
    assert t._staged is None and len(t.store) == keys.size
    t.end_pass()


# --------------------------------------------- trainers: eval and the day

@pytest.fixture(scope="module")
def day_data(tmp_path_factory):
    """Six files; a day of three passes over [0, 1], [2, 3], [4, 5]."""
    out = tmp_path_factory.mktemp("torch_day_data")
    files, feed = write_synthetic_ctr_files(
        str(out), num_files=6, lines_per_file=64, num_slots=4,
        vocab_per_slot=50, max_len=3, seed=23)
    jfeed = type(feed)(slots=feed.slots, batch_size=32)
    pfeed = DataFeedConfig(
        slots=tuple(SlotConfig(s.name, s.type, is_used=s.is_used,
                               max_len=s.max_len)
                    for s in feed.slots), batch_size=32)
    return [files[2 * p:2 * p + 2] for p in range(3)], jfeed, pfeed


@pytest.fixture
def jax_day_flags(monkeypatch):
    """The JAX trainer with use_pallas_push (its kernel interpreted on the
    CPU), ckpt_journal off."""
    import paddlebox_tpu.embedding.pallas_push as pp
    jflags.set_flag("use_pallas_push", True)
    jflags.set_flag("ckpt_journal", False)
    monkeypatch.setattr(pp, "pallas_apply_push",
                        functools.partial(pp.pallas_apply_push,
                                          interpret=True))


HIDDEN = (16, 8)
LR = 5e-3
# a day's thresholds that the small data crosses: some rows are deleted
DAY_TABLE = dict(delete_threshold=1.2)


def _trainers(jfeed, pfeed):
    jt = JTrainer(JDeepFM(JSpec(num_slots=4, slot_dim=3 + D),
                          hidden=HIDDEN),
                  jtable_cfg(**DAY_TABLE), jfeed, JTrainerCfg(dense_lr=LR),
                  seed=0)
    model = DeepFM(ModelSpec(num_slots=4, slot_dim=3 + D), hidden=HIDDEN)
    model.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in jt.params.items()}))
    pt = BoxTrainer(model, table_cfg(**DAY_TABLE), pfeed,
                    TrainerConfig(dense_lr=LR), seed=0,
                    flags=PushFlags("scatter", 64), device="cpu")
    for t in (jt, pt):
        t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    return jt, pt


def _jax_seeds(key, n_steps):
    """(one train_pass's per-step push seeds, the next table key), as the
    JAX trainer draws them (trainer.py:725, optimizers.py:238)."""
    key, prng = jax.random.split(key)
    seeds = []
    for _ in range(n_steps):
        prng, sub = jax.random.split(prng)
        seeds.append(int(jax.random.randint(sub, (), 0,
                                            jnp.int32(2**31 - 1))))
    return seeds, key


def _datasets(files_per_pass, jfeed, pfeed):
    jds, pds = [], []
    for files in files_per_pass:
        j = JDataset(jfeed, read_threads=1, columnar=True)
        p = BoxDataset(pfeed)
        j.set_filelist(files)
        p.set_filelist(files)
        jds.append(j)
        pds.append(p)
    return jds, pds


STEPS = (2 * 64 + 31) // 32


def test_predict_batches_matches_jax(day_data, jax_day_flags):
    windows, jfeed, pfeed = day_data
    jt, pt = _trainers(jfeed, pfeed)
    key = jax.random.PRNGKey(0)
    jds, pds = _datasets(windows[:2], jfeed, pfeed)
    for j, p in zip(jds, pds):
        seeds, key = _jax_seeds(key, STEPS)
        pt.seed_fn = iter(seeds).__next__
        np.testing.assert_allclose(pt.train_pass(p)["loss"],
                                   jt.train_pass(j)["loss"], rtol=1e-4)
    # the dense Adam state crosses from optax (flattened) to the port
    want = adam_state_from_optax(jt.opt_state,
                                 {k: np.asarray(v)
                                  for k, v in jt.params.items()})
    got = pt.opt_state
    assert got["count"] == want["count"] == 2 * STEPS
    for m in ("mu", "nu"):
        for name in want[m]:
            np.testing.assert_allclose(got[m][name], want[m][name],
                                       rtol=1e-3, atol=1e-9)
    jtest, ptest = _datasets(windows[2:], jfeed, pfeed)
    for d in jtest + ptest:
        d.load_into_memory()
    before = sorted_items(pt.table.store)
    jp, jl = jt.predict_batches(jtest[0])
    pp, pl = pt.predict_batches(ptest[0])
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_allclose(pp, jp, rtol=1e-5, atol=1e-7)
    assert_stores_equal(sorted_items(pt.table.store), before)
    assert not pt.table.test_mode
    aucs = [rank_auc(jp, jl), rank_auc(pp, pl)]
    assert abs(aucs[0] - aucs[1]) <= 1e-4 and 0.0 < aucs[1] < 1.0
    # eval_driver's variant gives the same predictions
    sp, sl = simple_predict_batches(pt, ptest[0])
    assert_bits_equal(sp, pp)
    np.testing.assert_array_equal(sl, pl)


def test_simple_predict_batches_closes_its_pass(day_data):
    windows, _, pfeed = day_data
    t = BoxTrainer(DeepFM(ModelSpec(num_slots=4, slot_dim=3 + D),
                          hidden=HIDDEN), table_cfg(), pfeed, device="cpu")
    ds = BoxDataset(pfeed)
    ds.set_filelist(windows[0])

    def boom(b):
        raise RuntimeError("eval step failed")

    t.eval_batch = boom
    with pytest.raises(RuntimeError, match="eval step failed"):
        simple_predict_batches(t, ds)
    assert not t.table.test_mode and len(ds) > 0
    del t.eval_batch
    res = t.train_pass(ds)  # the pass was closed: training goes on
    assert res["batches"] == STEPS


def rank_auc(preds, labels):
    """The exact AUC of ``preds`` (ties scored a half): the test pass's
    AUC, which a bucketed AUC table would move by a bucket edge."""
    order = np.argsort(preds, kind="stable")
    p = preds[order]
    ranks = np.empty(p.size)
    starts = np.flatnonzero(np.r_[True, p[1:] != p[:-1], True])
    for lo, hi in zip(starts[:-1], starts[1:]):
        ranks[lo:hi] = 0.5 * (lo + hi - 1) + 1
    pos = labels[order] > 0
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


def _sparse_sorted(blob):
    order = np.argsort(blob["keys"])
    return blob["keys"][order], np.asarray(blob["values"])[order]


@pytest.mark.parametrize("preload", [True, False])
def test_run_day_matches_jax(preload, day_data, jax_day_flags, tmp_path):
    windows, jfeed, pfeed = day_data
    jt, pt = _trainers(jfeed, pfeed)
    key = jax.random.PRNGKey(0)
    seeds = []
    for _ in windows:
        s, key = _jax_seeds(key, STEPS)
        seeds += s
    pt.seed_fn = iter(seeds).__next__
    jds, pds = _datasets(windows, jfeed, pfeed)
    roots = {k: str(tmp_path / k) for k in ("jax", "port")}
    jcm = jckpt.CheckpointManager(
        JCkptCfg(batch_model_dir=roots["jax"] + "/batch",
                 xbox_model_dir=roots["jax"] + "/xbox"), jt.table)
    pcm = pckpt.CheckpointManager(
        CheckpointConfig(batch_model_dir=roots["port"] + "/batch",
                         xbox_model_dir=roots["port"] + "/xbox"), pt.table)
    aucs = {"jax": [], "port": []}
    sizes = {}

    def record(tag, t, cm, real):
        def save_delta(day, delta_id):
            aucs[tag].append(t.metrics.get_metric_msg("auc")["auc"])
            return real(day, delta_id)
        cm.save_delta = save_delta

    record("jax", jt, jcm, jcm.save_delta)
    record("port", pt, pcm, pcm.save_delta)
    jstats, jdirs = jckpt.run_day(jt, jds, jcm, "d0", preload=preload)
    pstats, pdirs = pckpt.run_day(pt, pds, pcm, "d0", preload=preload)
    assert len(pstats) == len(jstats) == 3
    for p, j in zip(pstats, jstats):
        np.testing.assert_allclose(p["loss"], j["loss"], rtol=1e-4)
        assert p["batches"] == j["batches"] == STEPS
    np.testing.assert_allclose(aucs["port"], aucs["jax"], atol=1e-4)
    for tag, dirs in (("jax", jdirs), ("port", pdirs)):
        blob = jckpt.read_batch_sparse(dirs[0])
        sizes[tag] = _sparse_sorted(blob)
    (pk, pv), (jk, jv) = sizes["port"], sizes["jax"]
    np.testing.assert_array_equal(pk, jk)
    assert_rows_close(pv, jv)
    # each delta view: the same keys, the rows at the trained tolerance;
    # the base view bit-equal to the port's own base rows
    for view in ("d0/delta-1", "d0/delta-2", "d0/delta-3", "d0"):
        kp, rp = pserving.read_xbox_view(
            os.path.join(roots["port"], "xbox", view))
        kj, rj = jserving.read_xbox_view(
            os.path.join(roots["jax"], "xbox", view))
        np.testing.assert_array_equal(kp, kj)
        np.testing.assert_allclose(rp, rj, rtol=1e-4, atol=1e-7)
        assert kp.size > 0, view
    layout = pt.table.layout
    kb, rb = pserving.read_xbox_view(os.path.join(roots["port"], "xbox",
                                                  "d0"))
    assert_bits_equal(rb, np.concatenate(
        [pv[:, acc.EMBED_W:acc.EMBED_W + 1],
         pv[:, layout.embedx_w:layout.embedx_w + D]], axis=1))
    # the store after end_day, and the rows the shrink deleted
    (sk, sv), (tk, tv) = sorted_items(pt.table.store), sorted_items(
        jt.table.store)
    np.testing.assert_array_equal(sk, tk)
    assert_rows_close(sv, tv)
    assert pk.size - sk.size == jk.size - tk.size > 0
    assert (sv[:, acc.UNSEEN_DAYS] >= 1).all()


def test_resume_equals_continue(day_data, tmp_path):
    """A trainer loaded from the day's base, after the day boundary's stat
    rewrite and shrink, trains the next pass bit-identically to the trainer
    that saved it."""
    windows, _, pfeed = day_data
    ckpt = CheckpointConfig(batch_model_dir=str(tmp_path / "batch"),
                            xbox_model_dir=str(tmp_path / "xbox"))

    def trainer(seed):
        t = BoxTrainer(DeepFM(ModelSpec(num_slots=4, slot_dim=3 + D),
                              hidden=HIDDEN,
                              generator=torch.Generator().manual_seed(seed)),
                       table_cfg(**DAY_TABLE), pfeed,
                       TrainerConfig(dense_lr=LR), seed=seed, device="cpu")
        t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
        return t

    saver = trainer(0)
    cm = pckpt.CheckpointManager(ckpt, saver.table)
    snap = {}
    real = cm.save_base

    def save_base(params, opt_state, day, **kw):
        snap["store"] = sorted_items(saver.table.store)
        return real(params, opt_state, day, **kw)

    cm.save_base = save_base
    pds = [BoxDataset(pfeed) for _ in windows]
    for d, files in zip(pds, windows):
        d.set_filelist(files)
    pckpt.run_day(saver, pds, cm, "d0")
    resumed = trainer(1)
    params, opt_state, extra = pckpt.CheckpointManager(
        ckpt, resumed.table).load_base("d0")
    assert extra == {} and opt_state["count"] == 3 * STEPS
    resumed.restore_dense(params, opt_state)
    assert_stores_equal(sorted_items(resumed.table.store), snap["store"])
    for name, v in saver.params.items():
        assert_bits_equal(resumed.params[name], v)
    for m in ("mu", "nu"):
        for name, v in saver.opt_state[m].items():
            assert_bits_equal(resumed.opt_state[m][name], v)
    cfg = resumed.table.config
    with resumed.table.store_lock:
        resumed.table.store.update_stat_after_save(cfg, 1)
        resumed.table.store.update_stat_after_save(cfg, 3)
    resumed.table.end_day(age=False)
    assert_stores_equal(sorted_items(resumed.table.store),
                        sorted_items(saver.table.store))
    out = []
    for t in (saver, resumed):
        t.reseed(5)
        t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
        d = BoxDataset(pfeed)
        d.set_filelist(windows[0])
        loss = t.train_pass(d)["loss"]
        out.append((loss, t.metrics.get_metric_msg("auc")["auc"],
                    sorted_items(t.table.store)))
    assert out[0][:2] == out[1][:2]
    assert_stores_equal(out[0][2], out[1][2])


# --------------------------------------------- the checkpoint plane's edges

def _small_table_with_rows(n=300, seed=4):
    t = PassTable(table_cfg(), device="cpu")
    rng = np.random.RandomState(seed)
    keys = np.unique(rng.randint(1, 1 << 40, n).astype(np.uint64))
    t.store.load_blob({"keys": keys, "values": random_rows(
        rng, keys.size, t.layout.width), **META})
    return t


def _cm(tmp_path, table, async_save=True, **flags):
    return pckpt.CheckpointManager(
        CheckpointConfig(batch_model_dir=str(tmp_path / "batch"),
                         xbox_model_dir=str(tmp_path / "xbox"),
                         async_save=async_save), table, CkptFlags(**flags))


@pytest.mark.parametrize("mode", ["touched", "auto"])
def test_touched_mode_without_journal_falls_back_full(mode, tmp_path,
                                                      caplog):
    t = _small_table_with_rows()
    cm = _cm(tmp_path, t, ckpt_journal=False)
    assert cm.journal is None
    with caplog.at_level(logging.WARNING):
        bdir, xdir = cm.save_base({}, {}, day="d0", mode=mode)
    # an explicit 'touched' warns; 'auto' picks full without a journal,
    # as the reference does, and says nothing
    assert ("falling back to FULL" in caplog.text) == (mode == "touched")
    cm.wait()
    with open(os.path.join(bdir, "sparse.xman")) as f:
        assert json.load(f)["mode"] == "full"
    assert xdir is not None and os.path.exists(os.path.join(xdir, "DONE"))
    cm.load_base("d0")
    with pytest.raises(ValueError, match="mode"):
        cm.save_base({}, {}, day="d1", mode="partial")


def test_wait_joins_every_writer_and_raises_a_writer_error(tmp_path,
                                                          monkeypatch):
    t = _small_table_with_rows()
    cm = _cm(tmp_path, t)
    done, gates = [], [threading.Event(), threading.Event()]
    for i in range(2):
        def writer(i=i):
            assert gates[i].wait(10.0)
            done.append(i)
        cm._spawn_writer(writer, "save_delta_writer")
    assert len(cm._writers) == 2
    for g in gates:
        g.set()
    cm.wait()
    assert sorted(done) == [0, 1] and not cm._writers
    assert cm.seconds["save_delta_writer"] > 0
    # a writer that dies: the save returns, wait() raises its error once
    k0, v0 = sorted_items(t.store)
    cm.save_base({"w": np.float32(1)}, {}, day="d0")
    cm.wait()
    real = cks.write_part

    def dying(path, keys, values, fsync=True):
        raise OSError("injected writer death")

    monkeypatch.setattr(cks, "write_part", dying)
    cm.save_base({"w": np.float32(2)}, {}, day="d1")
    with pytest.raises(OSError, match="injected"):
        cm.wait()
    cm.wait()
    monkeypatch.setattr(cks, "write_part", real)
    assert not os.path.exists(str(tmp_path / "batch" / "d1" / "DONE"))
    with pytest.raises(FileNotFoundError):
        cm.load_base("d1")
    # the last completed base still loads, as it was saved
    params, _, _ = cm.load_base("d0")
    assert params == {"w": np.float32(1)}
    assert_stores_equal(sorted_items(t.store), (k0, v0))
    # without async_save the error reaches save_base itself
    sync = _cm(tmp_path / "sync", t, async_save=False)
    monkeypatch.setattr(cks, "write_part", dying)
    with pytest.raises(OSError, match="injected"):
        sync.save_base({}, {}, day="d0")


class NotNumpy:
    pass


def test_load_base_refuses_a_pickle_of_other_classes(tmp_path):
    t = _small_table_with_rows()
    cm = _cm(tmp_path, t, async_save=False)
    cm.save_base({"w": np.ones(2, np.float32)}, {"count": 0}, day="d0")
    before = sorted_items(t.store)
    path = os.path.join(cm.cfg.batch_model_dir, "d0", "dense.pkl")
    with open(path, "wb") as f:
        pickle.dump({"params": NotNumpy(), "opt_state": {}, "extra": {}}, f)
    other = _small_table_with_rows(seed=8)
    kept = sorted_items(other.store)
    with pytest.raises(pickle.UnpicklingError, match="NotNumpy"):
        _cm(tmp_path, other).load_base("d0")
    assert_stores_equal(sorted_items(other.store), kept)
    with pytest.raises(TypeError, match="dense.pkl"):
        cm.save_base({"w": torch.ones(2)}, {}, day="d1")
    assert before[0].size


def test_jax_base_dense_refused_and_port_base_loads_in_jax(tmp_path):
    """The port reads a JAX-written base's sparse tier but refuses its
    dense.pkl (jax arrays); the JAX package loads a port-written base."""
    jflags.set_flag("ckpt_journal", False)
    jt = JPassTable(jtable_cfg())
    rng = np.random.RandomState(2)
    keys = np.unique(rng.randint(1, 1 << 40, 200).astype(np.uint64))
    jt.store.load_blob({"keys": keys, "values": random_rows(
        rng, keys.size, ValueLayout(D).width), **META})
    jcm = jckpt.CheckpointManager(
        JCkptCfg(batch_model_dir=str(tmp_path / "j" / "batch"),
                 xbox_model_dir=str(tmp_path / "j" / "xbox"),
                 async_save=False), jt)
    want = sorted_items(jt.store)
    jcm.save_base({"w": jnp.ones(3)}, {"m": jnp.zeros(3)}, day="d0")
    pt = PassTable(table_cfg(), device="cpu")
    pcm = pckpt.CheckpointManager(
        CheckpointConfig(batch_model_dir=str(tmp_path / "j" / "batch"),
                         xbox_model_dir=str(tmp_path / "j" / "xbox")), pt)
    with pytest.raises(pickle.UnpicklingError, match="jax"):
        pcm.load_base("d0")
    assert len(pt.store) == 0
    pt.load(os.path.join(str(tmp_path / "j" / "batch"), "d0",
                         "sparse.xman"))
    assert_stores_equal(sorted_items(pt.store), want)
    # a port-written base, loaded by the JAX package's manager
    pcm2 = _cm(tmp_path / "p", pt, async_save=False)
    pcm2.save_base({"w": np.ones(3, np.float32)}, {"count": 0}, day="d0")
    jflags.set_flag("flatten_dense_opt", False)
    jt2 = JPassTable(jtable_cfg())
    params, opt, extra = jckpt.CheckpointManager(
        JCkptCfg(batch_model_dir=pcm2.cfg.batch_model_dir,
                 xbox_model_dir=pcm2.cfg.xbox_model_dir), jt2).load_base("d0")
    assert_bits_equal(params["w"], np.ones(3, np.float32))
    assert opt == {"count": 0} and extra == {}
    assert_stores_equal(sorted_items(jt2.store), want)


def test_ckpt_flags_refuse_what_the_port_lacks():
    with pytest.raises(ValueError, match="ckpt_format"):
        CkptFlags(ckpt_format="parquet")
    assert CkptFlags() == CkptFlags("columnar", 8, 0, True, True, 64 << 20,
                                    32)


def test_legacy_formats_round_trip(tmp_path):
    """ckpt_format pickle and ckpt_xbox_columnar off: the legacy files,
    which the port and the reference both read."""
    t = _small_table_with_rows()
    want = sorted_items(t.store)
    cm = _cm(tmp_path, t, async_save=False, ckpt_format="pickle",
             ckpt_xbox_columnar=False)
    bdir, xdir = cm.save_base({}, {"count": 0}, day="d0")
    assert sorted(os.listdir(bdir)) == ["DONE", "dense.pkl", "sparse.pkl"]
    assert os.path.exists(os.path.join(xdir, "embedding.pkl"))
    for read in (pserving.read_xbox_view, jserving.read_xbox_view):
        k, rows = read(xdir)
        np.testing.assert_array_equal(np.sort(k), want[0])
        assert rows.shape == (want[0].size, 1 + D)
    blob = jckpt.read_batch_sparse(bdir)
    assert_stores_equal(_sparse_sorted(blob),
                        _sparse_sorted(pckpt.read_batch_sparse(bdir)))
    cm.load_base("d0")
    assert_stores_equal(sorted_items(t.store), want)
    assert dataclasses.asdict(cm.flags)["ckpt_format"] == "pickle"
