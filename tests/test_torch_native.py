"""The port's native host tier (the g++ slot parser, the columnar dataset,
the C++ host store, the route index) against the JAX package's native tier
and against the port's plain (Python) tier.

The C++ runs here: g++ builds the port's library from
paddlebox_tpu_torch/native/*.cc and the JAX package's from its own copy.
Inputs are made from seeds with numpy. Tolerances:

  * parser, packing, dataset batches, the add_keys stream, store rows and
    route ids: exact (integer work, row moves and rows from the same
    RandomState draws);
  * a small two-pass train_pass: bit-equal between the port's native and
    plain tiers; against the JAX trainer (use_pallas_push, its kernel
    interpreted, on its columnar dataset) loss rtol 1e-4 and AUC 1e-4
    absolute, as in tests/test_torch_train.py.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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
from paddlebox_tpu.embedding.accessor import ValueLayout as JLayout
from paddlebox_tpu.embedding.native_store import \
    NativeHostEmbeddingStore as JNativeStore
from paddlebox_tpu.models.base import ModelSpec as JSpec
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.native import build as jnative
from paddlebox_tpu.train.trainer import BoxTrainer as JTrainer
from paddlebox_tpu.utils.stats import stat_get

from paddlebox_tpu_torch.config.configs import (DataFeedConfig, SlotConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.config.flags import PushFlags
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
from paddlebox_tpu_torch.embedding.native_store import (
    NativeHostEmbeddingStore, make_host_store)
from paddlebox_tpu_torch.embedding.pass_table import (PassTable,
                                                      lookup_ids_plain,
                                                      sorted_member)
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.native import host_lib
from paddlebox_tpu_torch.train.trainer import BoxTrainer

NUM_SLOTS = 4
BATCH = 32
D = 8
CAP = 1024
LR = 5e-3
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
FIELDS = ("keys", "slots", "segments", "valid", "labels", "ins_valid")


def _jax_feed(pfeed):
    return JFeed(slots=tuple(JSlot(s.name, s.type, is_used=s.is_used,
                                   max_len=s.max_len) for s in pfeed.slots),
                 batch_size=pfeed.batch_size)


def _with_max_len(feed, max_len, batch=BATCH):
    return DataFeedConfig(slots=tuple(
        SlotConfig(s.name, s.type, s.is_used,
                   max_len if s.type == "uint64" else s.max_len)
        for s in feed.slots), batch_size=batch)


# malformed lines of the 4-slot format (click, then slot_0..slot_3): each
# is dropped by every parser; the empty ones are skipped without a count
BAD_LINES = [
    "1 1 2 5 abc 1 7 1 8 1 9",          # a non-numeric feasign
    "1 0 3 5 6",                         # a count past the line's end
    "x 1 1 5 1 6 1 7 1 8",               # a non-numeric count
    "1 1 -1 5 1 6 1 7 1 8",              # a negative count
    "1 1 1 5 1 6 1 7",                   # a missing slot
]
ODD_GOOD_LINES = [
    "1 0.7 1 11 2 12 13 1 14 1 15 99 98",  # float label, trailing extras
    "1\t1 1 21\t1 22 1 23 1 24\r",          # tabs and a carriage return
    "1 0 0 1 32 0 0",                        # empty slots
]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(three generated files and one with malformed lines, feed)."""
    out = tmp_path_factory.mktemp("torch_native_data")
    files, feed = write_synthetic_ctr_files(
        str(out), num_files=3, lines_per_file=70, num_slots=NUM_SLOTS,
        vocab_per_slot=50, max_len=3, seed=21)
    with open(files[0]) as fh:
        good = fh.read().splitlines()[:30]
    mixed = os.path.join(str(out), "mixed.txt")
    with open(mixed, "w") as fh:
        lines = good[:10] + BAD_LINES[:3] + ["", "   "] + good[10:20] \
            + ODD_GOOD_LINES + BAD_LINES[3:] + good[20:]
        fh.write("\n".join(lines) + "\n")
    return files + [mixed], DataFeedConfig(slots=feed.slots,
                                           batch_size=BATCH)


# ------------------------------------------------------------- the parser

@pytest.mark.parametrize("which", ["generated", "malformed"])
def test_parser_matches_jax_native_and_plain(data, which):
    files, feed = data
    path = files[0] if which == "generated" else files[-1]
    port = NativeMultiSlotParser(feed)
    got = port.parse_file_columnar(path)
    before = stat_get("parser_bad_lines")
    want = JNativeParser(_jax_feed(feed)).parse_file_columnar(path)
    assert port.bad_lines == stat_get("parser_bad_lines") - before \
        == (len(BAD_LINES) if which == "malformed" else 0)
    for f in ("keys", "key_slot", "labels", "rec_offsets"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.keys.dtype == np.uint64 and got.key_slot.dtype == np.int32
    # the plain parser drops the same lines and yields the same records
    recs = list(MultiSlotParser(feed).parse_file(path))
    assert len(recs) == got.n_recs
    np.testing.assert_array_equal([r.label for r in recs], got.labels)
    for r, rec in enumerate(recs):
        lo, hi = got.rec_offsets[r], got.rec_offsets[r + 1]
        np.testing.assert_array_equal(rec.all_keys(), got.keys[lo:hi])
        np.testing.assert_array_equal(
            np.concatenate([np.full(v.size, s, np.int32)
                            for s, v in rec.uint64_slots.items()]
                           or [np.empty(0, np.int32)]),
            got.key_slot[lo:hi])
    if which == "malformed":
        assert got.labels[20] == 0 and got.n_recs == 33


def test_parser_missing_file_raises(data, tmp_path):
    with pytest.raises(FileNotFoundError):
        NativeMultiSlotParser(data[1]).parse_file_columnar(
            str(tmp_path / "missing.txt"))


# --------------------------------------------------------------- packing

def _blocks(files, feed):
    """(the port's block, the JAX block of the same arrays, the plain
    parser's records) of ``files``."""
    parser = NativeMultiSlotParser(feed)
    block = ColumnarBlock.concat([parser.parse_file_columnar(f)
                                  for f in files])
    jblock = JBlock(block.keys, block.key_slot, block.labels,
                    block.rec_offsets)
    plain = MultiSlotParser(feed)
    recs = [r for f in files for r in plain.parse_file(f)]
    return block, jblock, recs


@pytest.mark.parametrize("max_len,kcap", [(3, None), (2, None), (2, 150),
                                          (1, 40)])
def test_pack_columnar_matches_jax_and_packer(data, max_len, kcap):
    files, feed = data
    feed = _with_max_len(feed, max_len)
    block, jblock, recs = _blocks(files, feed)
    packer = BatchPacker(feed)
    if kcap is not None:
        packer.kcap = kcap
    max_lens = np.full(NUM_SLOTS, max_len, np.int64)
    rng = np.random.RandomState(max_len)
    for size in (BATCH, 17, 0):
        rec_idx = rng.permutation(block.n_recs)[:size]
        got = pack_columnar(block, rec_idx, feed, packer.kcap, NUM_SLOTS,
                            max_lens)
        want = jax_pack_columnar(jblock, rec_idx, _jax_feed(feed),
                                 packer.kcap, NUM_SLOTS, max_lens)
        plain = packer.pack([recs[i] for i in rec_idx])
        for f in FIELDS:
            a, b, c = (getattr(x, f) for x in (got, want, plain))
            assert a.dtype == c.dtype and a.shape == c.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
            np.testing.assert_array_equal(a, c, err_msg=f)
        assert got.n_ins == want.n_ins == plain.n_ins == size
        if kcap is not None and size == BATCH:
            assert got.valid.sum() == kcap   # the batch was cut


def test_block_select_and_concat_match_jax(data):
    files, feed = data
    block, jblock, _ = _blocks(files[:2], feed)
    idx = np.random.RandomState(3).permutation(block.n_recs)[:50]
    got, want = block.select(idx), jblock.select(idx)
    for f in ("keys", "key_slot", "labels", "rec_offsets"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    parts = [block.select(np.arange(0, 40)), block.select(np.arange(40, 40)),
             block.select(np.arange(40, block.n_recs))]
    whole = ColumnarBlock.concat(parts)
    for f in ("keys", "key_slot", "labels", "rec_offsets"):
        np.testing.assert_array_equal(getattr(whole, f), getattr(block, f))
    empty = ColumnarBlock.concat([])
    assert empty.n_recs == empty.n_keys == 0


# --------------------------------------------------------------- dataset

@pytest.mark.parametrize("seed,workers", [(7, 1), (11, 1), (5, 3)])
def test_dataset_columnar_matches_jax_and_record_path(data, seed, workers):
    files, feed = data
    port = BoxDataset(feed)
    plain = BoxDataset(feed, columnar=False)
    jds = JDataset(_jax_feed(feed), read_threads=1, columnar=True)
    assert port.columnar and not plain.columnar and jds.columnar
    streams = {}
    for name, ds in (("port", port), ("plain", plain), ("jax", jds)):
        ds.set_filelist(files)
        streams[name] = []
        ds.load_into_memory(add_keys_fn=streams[name].append)
    # one add_keys call a file, as the JAX columnar merge makes them
    assert len(streams["port"]) == len(files)
    for a, b in zip(streams["port"], streams["jax"], strict=True):
        np.testing.assert_array_equal(a, b)
    cat = {k: np.concatenate(v) for k, v in streams.items()}
    np.testing.assert_array_equal(cat["port"], cat["plain"])
    np.testing.assert_array_equal(port.all_keys(), cat["port"])
    np.testing.assert_array_equal(plain.all_keys(), cat["plain"])
    assert len(port) == len(plain) == len(jds) == 3 * 70 + 33
    for ds in (port, plain, jds):
        ds.local_shuffle(seed)
    got = port.split_batches(workers)
    for other in (plain.split_batches(workers), jds.split_batches(workers)):
        assert [len(w) for w in got] == [len(w) for w in other]
        for gw, ow in zip(got, other):
            for a, b in zip(gw, ow):
                for f in FIELDS:
                    np.testing.assert_array_equal(getattr(a, f),
                                                  getattr(b, f), err_msg=f)
                assert a.n_ins == b.n_ins
    port.release_memory()
    assert len(port) == 0 and port.all_keys().size == 0
    assert port.split_batches(1) == [[]]


# ----------------------------------------------------------------- store

def _stores(initial_range=0.05, seed=4):
    conf = dict(OPT, initial_range=initial_range)
    table = TableConfig(embedx_dim=D, pass_capacity=CAP,
                        optimizer=SparseOptimizerConfig(**conf))
    jtable = JTable(embedx_dim=D, pass_capacity=CAP, optimizer=JSparse(**conf))
    return (NativeHostEmbeddingStore(ValueLayout(D), table, seed),
            HostEmbeddingStore(ValueLayout(D), table, seed),
            JNativeStore(JLayout(D, "adagrad"), jtable, seed))


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


def _sorted(store):
    k, v = store.state_items()
    o = np.argsort(k)
    return k[o], v[o]


def test_native_store_matches_plain_and_jax():
    stores = _stores()
    native = stores[0]
    rng = np.random.RandomState(0)
    # three sorted unique key sets that overlap; the store grows past its
    # first 65,536 arena rows and its first hash table
    universe = np.unique(rng.randint(0, 1 << 62, 150_000).astype(np.uint64))
    sets = [universe[:40_000], universe[30_000:100_000],
            np.unique(np.concatenate([universe[::7], universe[-500:]]))]
    for keys in sets:
        got = [s.lookup_or_create(keys) for s in stores]
        for g in got[1:]:
            np.testing.assert_array_equal(_bits(got[0]), _bits(g))
        assert got[0][:, acc.EMBED_W].any()   # drawn from the RandomState
    assert len(native) == len(stores[1]) == len(stores[2]) > 1 << 16
    # reads create nothing; absent keys read as zero rows
    absent = np.uint64([1, 3, 5]) + np.uint64(1 << 63)
    present = np.unique(np.concatenate(sets))
    probe = rng.permutation(np.concatenate([present[::11], absent]))
    (nr, nf), (pr, pf), (jr, jf) = (s.lookup_present(probe) for s in stores)
    np.testing.assert_array_equal(nf, pf)
    np.testing.assert_array_equal(nf, jf)
    np.testing.assert_array_equal(_bits(nr), _bits(pr))
    np.testing.assert_array_equal(_bits(nr), _bits(jr))
    assert nf.dtype == bool and not nr[~nf].any() and (~nf).sum() == 3
    np.testing.assert_array_equal(_bits(native.lookup(probe)), _bits(pr))
    assert len(native) == len(stores[1])
    # write_back overwrites known rows and refuses unknown keys
    wkeys = universe[5:20_000:3]
    vals = rng.randn(wkeys.size, ValueLayout(D).width).astype(np.float32)
    for s in stores:
        s.write_back(wkeys, vals)
    for s in stores[:2]:
        with pytest.raises(KeyError):
            s.write_back(np.concatenate([wkeys[:2], absent[:1]]), vals[:3])
    np.testing.assert_array_equal(_bits(native.lookup(wkeys)), _bits(vals))
    items = [_sorted(s) for s in stores]
    for k, v in items[1:]:
        np.testing.assert_array_equal(items[0][0], k)
        np.testing.assert_array_equal(_bits(items[0][1]), _bits(v))
    assert items[0][0].size == len(native)


def test_make_host_store_is_native_and_empty_store_reads():
    table = TableConfig(embedx_dim=D, pass_capacity=CAP)
    store = make_host_store(ValueLayout(D), table, 0)
    assert isinstance(store, NativeHostEmbeddingStore) and len(store) == 0
    k, v = store.state_items()
    assert k.size == 0 and v.shape == (0, ValueLayout(D).width)
    rows, found = store.lookup_present(np.empty(0, np.uint64))
    assert rows.shape == (0, ValueLayout(D).width) and found.size == 0
    assert store.lookup_or_create(np.empty(0, np.uint64)).shape[0] == 0
    with pytest.raises(ValueError):
        store.write_back(np.uint64([1]), np.zeros((1, 3), np.float32))


# ----------------------------------------------------------------- route

@pytest.mark.parametrize("n_keys", [0, 1, 5000])
def test_route_lookup_matches_searchsorted(n_keys):
    rng = np.random.RandomState(n_keys)
    keys = np.unique(rng.randint(0, 1 << 62, n_keys).astype(np.uint64))
    if n_keys > 1:
        # the all-ones key lives outside the hash table
        keys = np.append(keys[:-1], np.uint64(2**64 - 1))
    pad = CAP - 1
    handle = host_lib.create_route_index(keys)
    jhandle = jnative.create_route_index([keys])
    try:
        q = (keys[rng.randint(0, keys.size, 3000)] if keys.size
             else np.zeros(3000, np.uint64))
        valid = rng.rand(q.size) < 0.8 if keys.size else np.zeros(
            q.size, bool)
        # invalid positions hold keys the pass never saw: never probed
        q = np.where(valid, q, np.uint64(12345))
        got = host_lib.route_lookup(handle, q, valid, pad)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(
            got, lookup_ids_plain(keys, q, valid, pad))
        if keys.size:
            np.testing.assert_array_equal(
                got, jnative.route_lookup(jhandle, q, valid, pad))
            np.testing.assert_array_equal(
                host_lib.route_lookup(handle, q[valid], None, pad),
                np.searchsorted(keys, q[valid]))
        # a valid key the pass never registered raises, in both versions
        stranger = np.uint64([7, 1 << 63])
        stranger = stranger[~sorted_member(keys, stranger)[1]]
        for fn in (functools.partial(host_lib.route_lookup, handle),
                   functools.partial(lookup_ids_plain, keys)):
            with pytest.raises(KeyError, match="not registered"):
                fn(np.concatenate([q[:3], stranger]), None, pad)
        # the serve form maps misses to -1
        mix = np.concatenate([q, stranger])
        pos, hit = sorted_member(keys, mix)
        np.testing.assert_array_equal(
            host_lib.route_lookup_serve(handle, mix, -1),
            np.where(hit, pos, -1))
    finally:
        host_lib.destroy_route_index(handle)
        jnative.destroy_route_index(jhandle)


# ------------------------------------------------- train_pass, three ways

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


def test_train_pass_native_matches_plain_and_jax(data, pallas_interpret):
    files, feed = data[0][:2], data[1]
    jt = JTrainer(JDeepFM(JSpec(num_slots=NUM_SLOTS, slot_dim=3 + D),
                          hidden=(16, 8)),
                  JTable(embedx_dim=D, pass_capacity=CAP,
                         optimizer=JSparse(**OPT)),
                  _jax_feed(feed), JTrainerCfg(dense_lr=LR), seed=0)
    params = params_from_jax({k: np.asarray(v) for k, v in jt.params.items()})
    table = TableConfig(embedx_dim=D, pass_capacity=CAP,
                        optimizer=SparseOptimizerConfig(**OPT))

    def port(plain):
        model = DeepFM(ModelSpec(num_slots=NUM_SLOTS, slot_dim=3 + D),
                       hidden=(16, 8))
        model.load_state_dict(params)
        return BoxTrainer(
            model, table, feed, TrainerConfig(dense_lr=LR), seed=0,
            flags=PushFlags("scatter", 64), device="cpu",
            store=(HostEmbeddingStore(ValueLayout(D), table, 0) if plain
                   else None))

    runs = {"native": (port(False), BoxDataset(feed)),
            "plain": (port(True), BoxDataset(feed, columnar=False)),
            "jax": (jt, JDataset(_jax_feed(feed), read_threads=1,
                                 columnar=True))}
    assert isinstance(runs["native"][0].table.store, NativeHostEmbeddingStore)
    key = jax.random.PRNGKey(0)
    seeds = []
    for _ in range(2):
        s, key = _jax_pass_seeds(key, (2 * 70 + BATCH - 1) // BATCH)
        seeds.append(s)
    out = {}
    for name, (t, ds) in runs.items():
        t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
        ds.set_filelist(files)
        out[name] = []
        for p in range(2):
            if name != "jax":
                t.seed_fn = iter(seeds[p]).__next__
            loss = t.train_pass(ds)["loss"]
            out[name].append((loss, t.metrics.get_metric_msg("auc")["auc"]))
    assert out["native"] == out["plain"]
    for (gl, ga), (wl, wa) in zip(out["native"], out["jax"], strict=True):
        np.testing.assert_allclose(gl, wl, rtol=1e-4)
        assert abs(ga - wa) <= 1e-4, (ga, wa)
    (nk, nv), (pk, pv) = (_sorted(runs[n][0].table.store)
                          for n in ("native", "plain"))
    np.testing.assert_array_equal(nk, pk)
    np.testing.assert_array_equal(_bits(nv), _bits(pv))
    jk, jv = _sorted(jt.table.store)
    np.testing.assert_array_equal(nk, jk)
    np.testing.assert_allclose(nv, jv, rtol=1e-4, atol=1e-7)


# ------------------------------------------------------ a failed build

def test_failed_build_raises_and_nothing_falls_back(data, tmp_path,
                                                   monkeypatch):
    files, feed = data
    monkeypatch.setattr(host_lib, "_lib", None)
    monkeypatch.setattr(host_lib, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(host_lib, "CXX", "false")   # exits 1
    table = TableConfig(embedx_dim=D, pass_capacity=CAP)
    for make in (host_lib.host_lib, lambda: BoxDataset(feed),
                 lambda: PassTable(table, device="cpu"),
                 lambda: make_host_store(ValueLayout(D), table),
                 lambda: host_lib.create_route_index(np.uint64([1, 2]))):
        with pytest.raises(RuntimeError, match="building the host library "
                           "failed.*rc=1"):
            make()
    assert host_lib._lib is None
    assert not os.listdir(str(tmp_path / "build"))
    monkeypatch.setattr(host_lib, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="did not run"):
        host_lib.host_lib()
    # the plain tier is there for a caller who names it
    ds = BoxDataset(feed, columnar=False)
    ds.set_filelist(files[:1])
    ds.load_into_memory()
    assert len(ds) == 70
