"""Side-table aux rows against the JAX package on the CPU: the InputTable
and the ReplicaCache, ins_id lines, the packer's aux_offset from either
source, CtrDnnAux, two train_passes through each source against the JAX
BoxTrainer (``use_pallas_push``, its kernel interpreted), the trainer's
aux_source contract, and where the dataset takes the record path.

Tolerances: the tables, the parsed records, the offsets and the miss
counts exact; CtrDnnAux's forward and gradients rtol 1e-5 / atol 1e-6
(f32 matmuls reduced in another order); two passes per-pass loss rtol
1e-4, AUC 1e-4 absolute, the MLP rtol 1e-4 / atol 1e-6, the store's
integer columns exact and its rows rtol 1e-4 / atol 1e-7, as the zoo's
tests hold them; the aux rows bit for bit.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from paddlebox_tpu.config import flags as jflags
from paddlebox_tpu.config.configs import (DataFeedConfig as JFeed,
                                          SlotConfig as JSlot,
                                          SparseOptimizerConfig as JSparse,
                                          TableConfig as JTable,
                                          TrainerConfig as JTrainerCfg)
from paddlebox_tpu.data.dataset import BoxDataset as JDataset
from paddlebox_tpu.data.packer import BatchPacker as JPacker
from paddlebox_tpu.data.parser import MultiSlotParser as JParser
from paddlebox_tpu.data.slot_record import SlotRecord as JRecord
from paddlebox_tpu.embedding import side_tables as jside
from paddlebox_tpu.models.aux_input import CtrDnnAux as JCtrDnnAux
from paddlebox_tpu.models.base import ModelSpec as JSpec
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.train.trainer import BoxTrainer as JTrainer

from paddlebox_tpu_torch.config.configs import (DataFeedConfig, SlotConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.convert import params_from_jax
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.data.generator import write_synthetic_ctr_files
from paddlebox_tpu_torch.data.packer import BatchPacker
from paddlebox_tpu_torch.data.parser import MultiSlotParser
from paddlebox_tpu_torch.data.slot_record import SlotRecord
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.embedding import side_tables as pside
from paddlebox_tpu_torch.models.aux_input import CtrDnnAux
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.train import flagship
from paddlebox_tpu_torch.train.trainer import BoxTrainer, model_logits

D = 8
SLOT_DIM = 3 + D
NUM_SLOTS = 4
BATCH = 32
LINES = 96
MAX_LEN = 3
HIDDEN = (16, 8)
AUX_DIM = 6
AUX_CAP = 64
VOCAB = 48
CAP = 1024
LR = 5e-3
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
INT_COLS = [acc.SLOT, acc.SHOW, acc.CLICK, acc.UNSEEN_DAYS, acc.MF_SIZE]
N_STEPS = (2 * LINES + BATCH - 1) // BATCH
# the small twin of FLAGSHIP_AUX the tables are built from
SMALL = dataclasses.replace(flagship.FLAGSHIP_AUX, ins_id_vocab=VOCAB,
                            aux_dim=AUX_DIM)


def _jfeed(feed):
    """The JAX package's DataFeedConfig of a port feed."""
    return JFeed(slots=tuple(JSlot(name=s.name, type=s.type,
                                   is_used=s.is_used, max_len=s.max_len,
                                   dim=s.dim) for s in feed.slots),
                 batch_size=feed.batch_size, rank_offset=feed.rank_offset,
                 parse_ins_id=feed.parse_ins_id,
                 task_label_slots=feed.task_label_slots)


def _tables(kind):
    """(port table, JAX table) with the same rows: flagship.input_table's
    or flagship.replica_cache's at the small twin's widths."""
    ours = (flagship.input_table(SMALL) if kind == "input_table"
            else flagship.replica_cache(SMALL))
    if kind == "input_table":
        theirs = jside.InputTable(AUX_DIM)
        for k in sorted(ours._offsets, key=ours._offsets.get)[1:]:
            theirs.add_index_data(k, ours.host_rows()[ours._offsets[k]])
    else:
        theirs = jside.ReplicaCache(AUX_DIM)
        for row in ours.host_rows():
            theirs.add_items(row)
    return ours, theirs


# ------------------------------------------------------------ side tables

def test_input_table_matches_jax():
    ours, theirs = _tables("input_table")
    assert ours.size() == theirs.size() == 1 + int(VOCAB * 0.75)
    keys = ["item%d" % k for k in range(VOCAB + 5)] + ["-", "", "x"]
    got = [ours.get_index_offset(k) for k in keys]
    want = [theirs.get_index_offset(k) for k in keys]
    assert got == want and ours.miss == theirs.miss > 0
    assert got[keys.index("-")] == 0
    for cap in (None, AUX_CAP):
        t = ours.to_device(cap, "cpu")
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(theirs.to_device(cap)))
        assert t.dtype == torch.float32 and t.device.type == "cpu"
    assert not ours.to_device(None, "cpu")[0].any()
    for table in (ours, theirs):
        with pytest.raises(ValueError, match="capacity"):
            table.to_device(ours.size() - 1)
        with pytest.raises(ValueError, match="dim"):
            table.add_index_data("k", np.zeros(AUX_DIM + 1))


def test_replica_cache_matches_jax():
    ours, theirs = _tables("replica_cache")
    assert len(ours) == len(theirs) == VOCAB
    for cap in (None, VOCAB, AUX_CAP):
        np.testing.assert_array_equal(ours.to_device(cap, "cpu").numpy(),
                                      np.asarray(theirs.to_device(cap)))
    assert ours.add_items(np.ones(AUX_DIM)) == theirs.add_items(
        np.ones(AUX_DIM)) == VOCAB
    np.testing.assert_array_equal(
        pside.ReplicaCache(3).to_device(2, "cpu").numpy(),
        np.asarray(jside.ReplicaCache(3).to_device(2)))
    assert not pside.ReplicaCache(3).to_device(2, "cpu").any()
    for cache in (ours, theirs):
        with pytest.raises(ValueError, match="capacity"):
            cache.to_device(VOCAB)
        with pytest.raises(ValueError, match="dim"):
            cache.add_items(np.zeros(2))


def test_to_device_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        flagship.input_table(SMALL).to_device(AUX_CAP)


# --------------------------------------------------------------- the feed

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_aux_data")
    files, feed = write_synthetic_ctr_files(
        str(out), num_files=2, lines_per_file=LINES, num_slots=NUM_SLOTS,
        vocab_per_slot=60, max_len=MAX_LEN, seed=13, ins_id_vocab=VOCAB)
    pfeed = dataclasses.replace(feed, batch_size=BATCH)
    return files, _jfeed(pfeed), pfeed


def test_generator_ids_lead_the_lines_it_writes_without(tmp_path, data):
    files, _, pfeed = data
    assert pfeed.parse_ins_id
    plain, feed = write_synthetic_ctr_files(
        str(tmp_path), num_files=2, lines_per_file=LINES,
        num_slots=NUM_SLOTS, vocab_per_slot=60, max_len=MAX_LEN, seed=13)
    assert not feed.parse_ins_id
    ids = set()
    for a, b in zip(files, plain):
        with open(a) as fa, open(b) as fb:
            for la, lb in zip(fa, fb, strict=True):
                head, rest = la.split(" ", 1)
                assert rest == lb and head.startswith("item")
                ids.add(int(head[4:]))
    assert max(ids) < VOCAB and len(ids) > VOCAB // 2


def test_parse_ins_id_lines_parsed_alike(data):
    files, jfeed, pfeed = data
    got = list(MultiSlotParser(pfeed).parse_file(files[0]))
    want = list(JParser(jfeed).parse_file(files[0]))
    assert len(got) == len(want) == LINES
    for a, b in zip(got, want):
        assert a.ins_id == b.ins_id and a.ins_id.startswith("item")
        assert a.label == b.label
        assert sorted(a.uint64_slots) == sorted(b.uint64_slots)
        for k, v in a.uint64_slots.items():
            np.testing.assert_array_equal(v, b.uint64_slots[k])
    # a line without its id is the ordinary line with its first token
    # read as an id: malformed, dropped in both
    line = "1 1 " + " ".join("2 7 8" for _ in range(NUM_SLOTS))
    assert MultiSlotParser(pfeed).parse_line(line) is None
    assert JParser(jfeed).parse_line(line) is None


def _records(n=21, seed=0):
    rng = np.random.RandomState(seed)
    ours, theirs = [], []
    for i in range(n):
        slots = {s: rng.randint(1, 40, 2).astype(np.uint64)
                 for s in range(NUM_SLOTS)}
        kw = dict(label=int(rng.rand() < 0.4),
                  ins_id="item%d" % rng.randint(VOCAB + 8),
                  cache_idx=int(rng.randint(VOCAB)))
        ours.append(SlotRecord(uint64_slots=dict(slots), **kw))
        theirs.append(JRecord(uint64_slots=dict(slots), **kw))
    return ours, theirs


@pytest.mark.parametrize("source", ["input_table", "use_cache_idx"])
def test_aux_offset_matches_jax(source, data):
    _, jfeed, pfeed = data
    ours, theirs = _records()
    if source == "input_table":
        pt, jt = _tables("input_table")
        pk, jk = (BatchPacker(pfeed, input_table=pt),
                  JPacker(jfeed, input_table=jt))
    else:
        pk, jk = (BatchPacker(pfeed, use_cache_idx=True),
                  JPacker(jfeed, use_cache_idx=True))
    got, want = pk.pack(ours), jk.pack(theirs)
    assert got.aux_offset.dtype == want.aux_offset.dtype == np.int32
    np.testing.assert_array_equal(got.aux_offset, want.aux_offset)
    assert not got.aux_offset[21:].any()
    if source == "input_table":
        assert pt.miss == jt.miss > 0
        assert (got.aux_offset[:21] == 0).sum() == pt.miss
    else:
        np.testing.assert_array_equal(got.aux_offset[:21],
                                      [r.cache_idx for r in ours])
    assert got.ins_ids == want.ins_ids


def test_aux_offset_refusals(data):
    _, jfeed, pfeed = data
    ours, theirs = _records()
    ours[5].cache_idx = theirs[5].cache_idx = -1
    for packer, recs in ((BatchPacker(pfeed, use_cache_idx=True), ours),
                         (JPacker(jfeed, use_cache_idx=True), theirs)):
        with pytest.raises(ValueError, match="cache_idx"):
            packer.pack(recs)
    table = pside.InputTable(AUX_DIM)
    with pytest.raises(ValueError, match="exclusive"):
        BatchPacker(pfeed, input_table=table, use_cache_idx=True)
    # a packer with no source packs no aux_offset
    assert BatchPacker(pfeed).pack(ours).aux_offset is None


CASES = {"plain": {}, "rank_offset": {"rank_offset": True},
         "parse_ins_id": {"parse_ins_id": True},
         "input_table": {"input_table": True},
         "use_cache_idx": {"use_cache_idx": True}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dataset_takes_the_record_path_where_jax_does(case, data):
    _, jfeed, pfeed = data
    kw = CASES[case]
    fields = {k: v for k, v in kw.items()
              if k in ("rank_offset", "parse_ins_id")}
    fields.setdefault("parse_ins_id", False)
    pf = dataclasses.replace(pfeed, **fields)
    jf = dataclasses.replace(jfeed, **fields)
    ptab, jtab = ((pside.InputTable(2), jside.InputTable(2))
                  if kw.get("input_table") else (None, None))
    cache = bool(kw.get("use_cache_idx"))
    ours = BoxDataset(pf, input_table=ptab, use_cache_idx=cache)
    theirs = JDataset(jf, read_threads=1, input_table=jtab,
                      use_cache_idx=cache)
    assert ours.columnar == theirs.columnar == (case == "plain")
    assert ours.packer.input_table is ptab
    assert ours.packer.use_cache_idx == cache


# -------------------------------------------------------------- CtrDnnAux

def _aux_pair(dense_dim=0):
    spec = ModelSpec(NUM_SLOTS, SLOT_DIM, dense_dim)
    jspec = JSpec(NUM_SLOTS, SLOT_DIM, dense_dim)
    kw = dict(aux_dim=AUX_DIM, aux_capacity=AUX_CAP, hidden=HIDDEN)
    return JCtrDnnAux(jspec, **kw), CtrDnnAux(spec, **kw)


@pytest.mark.parametrize("dense", [0, 5], ids=["sparse", "dense"])
def test_ctr_dnn_aux_forward_and_grads_match_jax(dense):
    jm, pm = _aux_pair(dense)
    rng = np.random.RandomState(4)
    jp = dict(jm.init(jax.random.PRNGKey(2)),
              aux_rows=rng.randn(AUX_CAP, AUX_DIM).astype(np.float32))
    pm.load_state_dict(params_from_jax(jp))
    assert "aux_rows" in dict(pm.named_buffers())
    assert "aux_rows" not in dict(pm.named_parameters())
    pooled = rng.randn(BATCH, NUM_SLOTS, SLOT_DIM).astype(np.float32)
    dn = rng.randn(BATCH, dense).astype(np.float32) if dense else None
    off = rng.randint(AUX_CAP, size=BATCH).astype(np.int32)
    jd = None if dn is None else jax.numpy.asarray(dn)

    def jf(p, x):
        return jm.apply(p, x, jd, aux_offset=jax.numpy.asarray(off)).sum()

    want = jm.apply(jp, jax.numpy.asarray(pooled), jd,
                    aux_offset=jax.numpy.asarray(off))
    jdp, jdx = jax.grad(jf, argnums=(0, 1))(jp, jax.numpy.asarray(pooled))
    assert not np.asarray(jdp["aux_rows"]).any()
    x = torch.from_numpy(pooled).requires_grad_(True)
    got = pm(x, None if dn is None else torch.from_numpy(dn),
             aux_offset=torch.from_numpy(off))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-6)
    flat = params_from_jax(jdp)
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), flat[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for model, call in ((pm, lambda: pm(x)),
                        (jm, lambda: jm.apply(jp, jax.numpy.asarray(
                            pooled)))):
        with pytest.raises(ValueError, match="aux_offset"):
            call()
    # bf16 compute: the buffer stays f32, the offsets int32
    with torch.no_grad():
        bf = model_logits(pm, x.detach(), "bfloat16",
                          dense=None if dn is None else torch.from_numpy(dn),
                          feed={"aux_offset": torch.from_numpy(off)})
    assert bf.dtype == torch.float32 and pm.aux_rows.dtype == torch.float32
    np.testing.assert_allclose(bf.numpy(), got.detach().numpy(), rtol=0.1,
                               atol=0.1)


def test_aux_source_refused_for_a_model_without_aux(data):
    _, jfeed, pfeed = data
    table = pside.InputTable(AUX_DIM)
    spec = ModelSpec(NUM_SLOTS, SLOT_DIM)
    with pytest.raises(ValueError, match="aux_source"):
        BoxTrainer(DeepFM(spec, hidden=HIDDEN),
                   _table(TableConfig, SparseOptimizerConfig), pfeed,
                   device="cpu", aux_source=table)
    with pytest.raises(ValueError, match="aux_source"):
        JTrainer(JDeepFM(JSpec(NUM_SLOTS, SLOT_DIM), hidden=HIDDEN),
                 _table(JTable, JSparse), jfeed,
                 aux_source=jside.InputTable(AUX_DIM))


# ------------------------------------------------ two passes against JAX

@pytest.fixture(scope="module")
def pallas_module():
    """The JAX trainer with use_pallas_push, its kernel interpreted on the
    CPU, for the module's JAX runs."""
    import paddlebox_tpu.embedding.pallas_push as pp
    mp = pytest.MonkeyPatch()
    jflags.set_flag("use_pallas_push", True)
    mp.setattr(pp, "pallas_apply_push",
               functools.partial(pp.pallas_apply_push, interpret=True))
    yield
    mp.undo()
    jflags.set_flag("use_pallas_push", False)


def _pass_seeds(n_draws, passes=2):
    """The push seeds of JAX train_passes from PRNGKey(0)."""
    key, seeds = jax.random.PRNGKey(0), []
    for _ in range(passes):
        key, prng = jax.random.split(key)
        s = []
        for _ in range(n_draws):
            prng, sub = jax.random.split(prng)
            s.append(int(jax.random.randint(sub, (), 0,
                                            jax.numpy.int32(2**31 - 1))))
        seeds.append(s)
    return seeds


def _table(cls, sparse_cls):
    return cls(embedx_dim=D, pass_capacity=CAP,
               optimizer=sparse_cls(**OPT))


def _run(trainer, ds, cache, seeds=None):
    trainer.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    out = []
    for p in range(2):
        if seeds is not None:
            trainer.seed_fn = iter(seeds[p]).__next__
        trainer.table.begin_feed_pass()
        ds.load_into_memory(add_keys_fn=trainer.table.add_keys)
        trainer.table.end_feed_pass()
        if cache:
            flagship.assign_cache_idx(ds.records)
        res = trainer.train_pass(ds, preloaded=True)
        out.append((res["loss"], trainer.metrics.get_metric_msg("auc")))
    return out


@pytest.mark.parametrize("source", ["input_table", "replica_cache"])
def test_two_passes_match_jax(source, data, pallas_module):
    """Two passes of 6 batches in a chunk of 4 and a tail of 2, through an
    InputTable (a quarter of the ids miss to its zero row) or a
    ReplicaCache read by cache_idx: losses, AUC, the MLP, the aux rows
    (the table's, untouched by Adam, no moments), the misses, the store."""
    files, jfeed, pfeed = data
    ptab, jtab = _tables(source)
    cache = source == "replica_cache"
    jm, pm = _aux_pair()
    jt = JTrainer(jm, _table(JTable, JSparse), jfeed,
                  JTrainerCfg(dense_lr=LR, scan_chunk=4), seed=0,
                  aux_source=jtab)
    params = jax.tree.map(np.asarray, jt.params)
    pm.load_state_dict(params_from_jax(params))
    pt = BoxTrainer(pm, _table(TableConfig, SparseOptimizerConfig), pfeed,
                    TrainerConfig(dense_lr=LR, scan_chunk=4), seed=0,
                    device="cpu", aux_source=ptab)
    jds = JDataset(jfeed, read_threads=1,
                   input_table=None if cache else jtab, use_cache_idx=cache)
    pds = BoxDataset(pfeed, input_table=None if cache else ptab,
                     use_cache_idx=cache)
    for ds in (jds, pds):
        ds.set_filelist(files)
    want = _run(jt, jds, cache)
    got = _run(pt, pds, cache, _pass_seeds(N_STEPS))
    for (gl, gm), (wl, wm) in zip(got, want, strict=True):
        np.testing.assert_allclose(gl, wl, rtol=1e-4)
        assert abs(gm["auc"] - wm["auc"]) <= 1e-4 and 0 < gm["auc"] <= 1
        assert gm["size"] == wm["size"]
    if not cache:
        assert ptab.miss == jtab.miss > 0
    jparams = jax.tree.map(np.asarray, jt.params)
    got_p = pt.params
    assert set(got_p) == set(jparams)
    for k, v in jparams.items():
        if k == "aux_rows":
            np.testing.assert_array_equal(got_p[k], v)
        else:
            np.testing.assert_allclose(got_p[k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    np.testing.assert_array_equal(
        pt.model.aux_rows.numpy(), ptab.to_device(AUX_CAP, "cpu").numpy())
    opt = pt.opt_state
    assert not opt["mu"]["aux_rows"].any() and not opt["nu"]["aux_rows"].any()
    assert all(p is not pt.model.aux_rows
               for g in pt.dense_opt.param_groups for p in g["params"])
    jk, jrows = jt.table.store.state_items()
    pk, prows = pt.table.store.state_items()
    jo, po = np.argsort(jk), np.argsort(pk)
    np.testing.assert_array_equal(pk[po], jk[jo])
    np.testing.assert_array_equal(prows[po][:, INT_COLS],
                                  jrows[jo][:, INT_COLS])
    np.testing.assert_allclose(prows[po], jrows[jo], rtol=1e-4, atol=1e-7)
    pt.close()
    jt.close()


def test_rows_refresh_at_every_train_and_test_pass(data):
    """Rows added to the table between passes reach the model at the next
    train_pass and at predict_batches, not before."""
    files, _, pfeed = data
    table = flagship.input_table(SMALL)
    _, pm = _aux_pair()
    pt = BoxTrainer(pm, _table(TableConfig, SparseOptimizerConfig), pfeed,
                    TrainerConfig(dense_lr=LR), seed=0, device="cpu",
                    aux_source=table)
    ds = BoxDataset(pfeed, input_table=table)
    ds.set_filelist(files[:1])
    assert not pm.aux_rows.any()
    pt.train_pass(ds)
    np.testing.assert_array_equal(pm.aux_rows.numpy(),
                                  table.to_device(AUX_CAP, "cpu").numpy())
    table.add_index_data("new", np.full(AUX_DIM, 7.0))
    assert not (pm.aux_rows == 7.0).any()
    preds, labels = pt.predict_batches(ds)
    assert preds.shape == labels.shape == (LINES,)
    assert (pm.aux_rows[table.size() - 1] == 7.0).all()
    pt.close()


# --------------------------------------------------------- the flagship

def test_flagship_aux_at_its_widths(tmp_path):
    """FLAGSHIP_AUX's model: CtrDnnAux 512-256-128 over 352 pooled columns
    and 8-wide aux rows, 4096 of them; its tables hold the vocabulary's
    rows (the input table 3/4 of it, behind the zero row)."""
    cfg = flagship.FLAGSHIP_AUX
    m = flagship.build_model(cfg)
    assert isinstance(m, CtrDnnAux)
    assert tuple(m.aux_rows.shape) == (4096, 8)
    assert [tuple(getattr(m, "dnn_w%d" % i).shape) for i in range(4)] == [
        (360, 512), (512, 256), (256, 128), (128, 1)]
    table, cache = flagship.input_table(cfg), flagship.replica_cache(cfg)
    assert table.size() == 1 + 3072 and len(cache) == 4096
    rows = cache.host_rows()
    for key, off in list(table._offsets.items())[1:50]:
        np.testing.assert_array_equal(table.host_rows()[off],
                                      rows[int(key[4:])])
    small = dataclasses.replace(cfg, num_slots=2, batch=16, num_files=1,
                                lines_per_file=20, vocab_per_slot=30,
                                capacity=256, hidden=(8,))
    files, feed = flagship.write_files(str(tmp_path), small)
    assert feed.parse_ins_id and not feed.rank_offset
    for src in (flagship.input_table(small), flagship.replica_cache(small)):
        t, ds = flagship.build_trainer(files, feed, small, device="cpu",
                                       aux_source=src)
        assert not ds.columnar and t.aux_source is src
        flagship.load_pass(t, ds)
        assert all(r.cache_idx == (int(r.ins_id[4:]) if
                                   ds.packer.use_cache_idx else -1)
                   for r in ds.records)
        res = t.train_pass(ds, preloaded=True)
        assert np.isfinite(res["loss"]) and res["batches"] == 2
        t.close()


# -------------------------------------------------------------- the card

@pytest.mark.cuda
def test_cuda_aux_matches_cpu(tmp_path):
    """On the card: two passes of a narrow FLAGSHIP_AUX through its input
    table give the CPU's losses and AUCs (rtol 1e-4) and the same aux
    rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch finds no CUDA device")
    cfg = dataclasses.replace(flagship.FLAGSHIP_AUX, num_slots=4, batch=32,
                              capacity=4096, num_files=2, lines_per_file=64,
                              vocab_per_slot=80, hidden=(16, 8))
    files, feed = flagship.write_files(str(tmp_path), cfg)
    out, rows = {}, {}
    for dev in ("cpu", "cuda"):
        t, ds = flagship.build_trainer(files, feed, cfg, device=dev,
                                       aux_source=flagship.input_table(cfg))
        out[dev] = []
        for _ in range(2):
            flagship.load_pass(t, ds)
            r = t.train_pass(ds, preloaded=True)
            out[dev].append((r["loss"],
                             t.metrics.get_metric_msg("auc")["auc"]))
        rows[dev] = t.model.aux_rows.cpu().numpy()
        t.close()
    np.testing.assert_allclose(np.array(out["cuda"]), np.array(out["cpu"]),
                               rtol=1e-4)
    np.testing.assert_array_equal(rows["cuda"], rows["cpu"])
