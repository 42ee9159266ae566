"""The no-CVM main path (BoxTrainer(use_cvm=False)) against the JAX
BoxTrainer(use_cvm=False), and the reference's parameters the port gained
with it.

Same synthetic files, the same carried CtrDnn weights (ModelSpec slot_dim
1 + D: a pooled slot is its embed_w and embedx) and the same per-step
creation seeds go through both packages on the CPU; the JAX reference
runs its Pallas push interpreted, as tests/test_torch_train.py wires it.
Covered: one step (loss, preds and dense params rtol 1e-5, every integer
slab column bit for bit), two passes one step a batch, in chunks
(scan_chunk=8: a chunk and a tail of 2) and chunk-synchronous, the
per-step path also with data_norm (dn_slot_dim 0, its summaries moved on
the no-CVM pool); per-pass loss rtol 1e-4 and AUC 1e-4 absolute, the host
rows' integer columns bit for bit and the rest rtol 1e-4, then
predict_batches over a third window (preds rtol 1e-4, atol 1e-6: after
two passes of last-bit differences). The pool itself: the no-CVM pool is
columns 2: of the CVM pool, bit for bit.

Then the parameters: MultiSlotParser and NativeMultiSlotParser
(label_slot=), StreamingDataset's positional read_threads and shuffler,
BatchPacker.pack(with_rank_offset=False) on a rank-offset feed, and
DeepFM(embedx_dim=), each against the reference.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.config import flags as jflags
from paddlebox_tpu.config.configs import DataFeedConfig as JFeed
from paddlebox_tpu.config.configs import SlotConfig as JSlot
from paddlebox_tpu.config.configs import (SparseOptimizerConfig as JSparse,
                                          TableConfig as JTable,
                                          TrainerConfig as JTrainerCfg)
from paddlebox_tpu.data.dataset import BoxDataset as JDataset
from paddlebox_tpu.data.generator import write_synthetic_ctr_files
from paddlebox_tpu.data.native_parser import \
    NativeMultiSlotParser as JNativeParser
from paddlebox_tpu.data.packer import BatchPacker as JPacker
from paddlebox_tpu.data.parser import MultiSlotParser as JParser
from paddlebox_tpu.data.slot_record import SlotRecord as JRecord
from paddlebox_tpu.data.streaming import StreamingDataset as JStream
from paddlebox_tpu.models.base import ModelSpec as JSpec
from paddlebox_tpu.models.ctr_dnn import CtrDnn as JCtrDnn
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.ops import seqpool as jseqpool
from paddlebox_tpu.train.trainer import BoxTrainer as JTrainer

from paddlebox_tpu_torch.config.configs import (DataFeedConfig, SlotConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.config.flags import PushFlags, StreamFlags
from paddlebox_tpu_torch.convert import params_from_jax, params_to_numpy
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.data.native_parser import NativeMultiSlotParser
from paddlebox_tpu_torch.data.packer import BatchPacker
from paddlebox_tpu_torch.data.parser import MultiSlotParser
from paddlebox_tpu_torch.data.shuffle import LocalShuffleGroup
from paddlebox_tpu_torch.data.slot_record import SlotRecord
from paddlebox_tpu_torch.data.streaming import StreamingDataset
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.ctr_dnn import CtrDnn
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.ops import seqpool
from paddlebox_tpu_torch.train import flagship
from paddlebox_tpu_torch.train.trainer import BoxTrainer

D = 8
NUM_SLOTS = 4
BATCH = 32
MAX_LEN = 3
HIDDEN = (16, 8)
CAP = 1024
LR = 5e-3
LINES = 160            # two files: 10 batches a pass
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
INT_COLS = [acc.SLOT, acc.SHOW, acc.CLICK, acc.UNSEEN_DAYS, acc.MF_SIZE]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Two windows of two files: the passes train on the first and
    predict_batches reads the second."""
    out = tmp_path_factory.mktemp("no_cvm")
    files, feed = write_synthetic_ctr_files(
        str(out), num_files=4, lines_per_file=LINES, num_slots=NUM_SLOTS,
        vocab_per_slot=60, max_len=MAX_LEN, seed=7)
    jfeed = type(feed)(slots=feed.slots, batch_size=BATCH)
    pfeed = DataFeedConfig(
        slots=tuple(SlotConfig(s.name, s.type, s.dim, s.is_used, s.max_len)
                    for s in feed.slots), batch_size=BATCH)
    return files[:2], files[2:], jfeed, pfeed


@pytest.fixture
def pallas_interpret(monkeypatch):
    import paddlebox_tpu.embedding.pallas_push as pp
    jflags.set_flag("use_pallas_push", True)
    monkeypatch.setattr(pp, "pallas_apply_push",
                        functools.partial(pp.pallas_apply_push,
                                          interpret=True))
    yield
    jflags.set_flag("use_pallas_push", False)


def _trainers(jfeed, pfeed, data_norm=False, **cfg):
    """(the JAX trainer, the port's) with use_cvm=False, the port's
    CtrDnn carrying the JAX one's weights."""
    kw = dict(use_data_norm=True, dn_slot_dim=0) if data_norm else {}
    table = dict(embedx_dim=D, pass_capacity=CAP)
    jt = JTrainer(JCtrDnn(JSpec(num_slots=NUM_SLOTS, slot_dim=1 + D),
                          hidden=HIDDEN, **kw),
                  JTable(optimizer=JSparse(**OPT), **table), jfeed,
                  JTrainerCfg(dense_lr=LR, **cfg), seed=0, use_cvm=False)
    model = CtrDnn(ModelSpec(num_slots=NUM_SLOTS, slot_dim=1 + D),
                   hidden=HIDDEN, **kw)
    model.load_state_dict(params_from_jax(_flat(jt.params)))
    pt = BoxTrainer(model, TableConfig(optimizer=SparseOptimizerConfig(
        **OPT), **table), pfeed, TrainerConfig(dense_lr=LR, **cfg), seed=0,
        use_cvm=False, flags=PushFlags("scatter", 64), device="cpu")
    for t in (jt, pt):
        t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    return jt, pt


def _flat(params):
    """A JAX params dict as numpy, a nested dict's entries as
    ``{name}_{key}`` (the port's names)."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update({"%s_%s" % (k, n): np.asarray(x)
                        for n, x in v.items()})
        else:
            out[k] = np.asarray(v)
    return out


def _datasets(files, jfeed, pfeed):
    j = JDataset(jfeed, read_threads=1, columnar=False)
    p = BoxDataset(pfeed)
    j.set_filelist(files)
    p.set_filelist(files)
    return j, p


def _jax_step_seed(prng):
    prng, sub = jax.random.split(prng)
    return int(jax.random.randint(sub, (), 0, jnp.int32(2**31 - 1))), prng


def _jax_seeds(key, n):
    """(one train_pass's push seeds, the next table key): next_prng, then
    one split a step (a chunk under chunk sync)."""
    key, prng = jax.random.split(key)
    seeds = []
    for _ in range(n):
        s, prng = _jax_step_seed(prng)
        seeds.append(s)
    return seeds, key


def _assert_rows(got, want, rtol):
    np.testing.assert_array_equal(got[:, INT_COLS], want[:, INT_COLS])
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7)


def test_the_constructor_takes_use_cvm_at_the_references_position(data):
    _, _, _, pfeed = data
    t = BoxTrainer(CtrDnn(ModelSpec(NUM_SLOTS, 1 + D), hidden=HIDDEN),
                   TableConfig(embedx_dim=D, pass_capacity=CAP), pfeed,
                   TrainerConfig(), 0, False, device="cpu")
    assert t.use_cvm is False and t.aux_source is None


def test_one_step_matches_jax(data, pallas_interpret):
    files, _, jfeed, pfeed = data
    jt, pt = _trainers(jfeed, pfeed)
    jds, pds = _datasets(files[:1], jfeed, pfeed)
    for t, ds in ((jt, jds), (pt, pds)):
        t.table.begin_feed_pass()
        ds.load_into_memory(add_keys_fn=t.table.add_keys)
        t.table.end_feed_pass()
        t.table.begin_pass()
    jb, pb = jds.split_batches(1)[0], pds.split_batches(1)[0]
    prng = jax.random.PRNGKey(3)
    n = pt.table.pass_size
    # step 1 creates every touched key's embedx; step 2 updates them
    for step in range(2):
        seed, prng_next = _jax_step_seed(prng)
        batch = jt.device_batch(jb[step], jt.table.lookup_ids(
            jb[step].keys, jb[step].valid))
        slab, jt.params, jt.opt_state, jloss, jpreds, _ = jt.fns.step(
            jt.table.slab, jt.params, jt.opt_state, batch, prng)
        jt.table.set_slab(slab)
        prng = prng_next
        pt.seed_fn = lambda s=seed: s
        ploss, ppreds = pt.train_batch(pb[step])
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(ppreds.numpy(), np.asarray(jpreds["ctr"]),
                                   rtol=1e-5, atol=1e-7)
        pparams = _flat(params_to_numpy(pt.model))
        for k, v in _flat(jt.params).items():
            np.testing.assert_allclose(pparams[k], v, rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        _assert_rows(pt.table.slab.numpy()[:n],
                     np.asarray(jt.table.slab)[:n], rtol=1e-5)


# (TrainerConfig fields, data_norm, the seeds a pass draws)
PATHS = {"per_step": (dict(scan_chunk=1), False, 10),
         "per_step_data_norm": (dict(scan_chunk=1), True, 10),
         "chunk": (dict(scan_chunk=8), False, 10),
         "chunk_sync": (dict(scan_chunk=8, sparse_chunk_sync=True), False,
                        3)}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_two_passes_and_predict_batches_match_jax(data, pallas_interpret,
                                                  path):
    files, test_files, jfeed, pfeed = data
    cfg, data_norm, draws = PATHS[path]
    jt, pt = _trainers(jfeed, pfeed, data_norm, **cfg)
    jds, pds = _datasets(files, jfeed, pfeed)
    key = jax.random.PRNGKey(0)
    got, want = [], []
    for _ in range(2):
        seeds, key = _jax_seeds(key, draws)
        pt.seed_fn = iter(seeds).__next__
        for t, ds, out in ((jt, jds, want), (pt, pds, got)):
            res = t.train_pass(ds)
            assert res["batches"] == 2 * LINES // BATCH
            out.append((res["loss"],
                        t.metrics.get_metric_msg("auc")["auc"]))
    for (gl, ga), (wl, wa) in zip(got, want, strict=True):
        np.testing.assert_allclose(gl, wl, rtol=1e-4)
        assert abs(ga - wa) <= 1e-4, (ga, wa)
    assert 0.0 < got[-1][1] <= 1.0
    keys = pt.table.pass_keys
    _assert_rows(pt.table.store.lookup(keys), jt.table.store.lookup(keys),
                 rtol=1e-4)
    pparams = _flat(params_to_numpy(pt.model))
    for k, v in _flat(jt.params).items():
        np.testing.assert_allclose(pparams[k], v, rtol=1e-3, atol=1e-6,
                                   err_msg=k)
    jtest, ptest = _datasets(test_files, jfeed, pfeed)
    for d in (jtest, ptest):
        d.load_into_memory()
    jp, jl = jt.predict_batches(jtest)
    pp, pl = pt.predict_batches(ptest)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_allclose(pp, jp, rtol=1e-4, atol=1e-6)
    pt.close()
    jt.close()


@pytest.mark.parametrize("sorted_segments", [True, False])
def test_the_no_cvm_pool_is_the_cvm_pools_embedding_columns(sorted_segments):
    """fused_seqpool_cvm without CVM is columns 2: of the pool with it, bit
    for bit, and both are the reference's; unsorted segments (the
    reference's default) pool as the same segments sorted."""
    rng = np.random.RandomState(4)
    B, S, K = 8, NUM_SLOTS, 90
    emb = rng.rand(K, 3 + D).astype(np.float32)
    segments = np.sort(rng.randint(0, B * S, K)).astype(np.int32)
    valid = rng.rand(K) < 0.9
    if not sorted_segments:
        perm = rng.permutation(K)
        emb, segments, valid = emb[perm], segments[perm], valid[perm]
    e, s, v = (torch.from_numpy(emb), torch.from_numpy(segments),
               torch.from_numpy(valid))
    pools = {c: seqpool.fused_seqpool_cvm(e, s, v, B, S, c,
                                          sorted_segments=sorted_segments)
             for c in (True, False)}
    assert pools[False].shape == (B, S, 1 + D)
    np.testing.assert_array_equal(pools[False].numpy(),
                                  pools[True][..., 2:].numpy())
    for c in (True, False):
        want = np.asarray(jseqpool.fused_seqpool_cvm(
            jnp.asarray(emb), jnp.asarray(segments), jnp.asarray(valid), B,
            S, c, sorted_segments=sorted_segments))
        np.testing.assert_allclose(pools[c].numpy(), want, rtol=1e-6,
                                   atol=1e-7)


def test_flagship_no_cvm_configuration(tmp_path):
    """FLAGSHIP_NO_CVM: FLAGSHIP's table, batch and files, CtrDnn 512-256-
    128 without data_norm over slots of 1 + embedx columns; the trainer
    build_trainer makes of it pools without CVM (at a narrow replace, one
    pass)."""
    cfg = flagship.FLAGSHIP_NO_CVM
    assert (cfg.model, cfg.use_cvm, cfg.hidden) == ("ctr_dnn", False,
                                                    (512, 256, 128))
    assert dataclasses.replace(cfg, model="deepfm",
                               use_cvm=True) == flagship.FLAGSHIP
    small = dataclasses.replace(
        cfg, num_slots=NUM_SLOTS, batch=BATCH, max_len=MAX_LEN,
        hidden=HIDDEN, capacity=CAP, num_files=1, lines_per_file=80,
        vocab_per_slot=60, data_seed=7)
    model = flagship.build_model(small)
    assert model.spec.slot_dim == 1 + D and not model.use_data_norm
    files, feed = flagship.write_files(str(tmp_path), small)
    trainer, ds = flagship.build_trainer(files, feed, small, "scatter",
                                         "cpu")
    assert trainer.use_cvm is False
    res = trainer.train_pass(ds)
    assert res["batches"] == 3 and np.isfinite(res["loss"])


# ------------------------------------------------------ the parameters

@pytest.fixture(scope="module")
def cvr_files(tmp_path_factory):
    out = tmp_path_factory.mktemp("label_slot")
    files, feed = write_synthetic_ctr_files(
        str(out), num_files=1, lines_per_file=200, num_slots=3,
        vocab_per_slot=40, max_len=2, seed=11, conversion=True)
    slots = tuple((s.name, s.type, s.dim, s.is_used, s.max_len)
                  for s in feed.slots)
    pfeed = DataFeedConfig(slots=tuple(SlotConfig(*s) for s in slots),
                           batch_size=BATCH)
    jfeed = JFeed(slots=tuple(JSlot(*s) for s in slots), batch_size=BATCH)
    return files[0], pfeed, jfeed


@pytest.mark.parametrize("label_slot", ["click", "label_cvr"])
def test_parsers_take_label_slot(cvr_files, label_slot):
    """Both parsers read the click label from ``label_slot`` (an unused
    float slot), as the reference's: the record parser's labels and the
    native parser's block labels bit for bit."""
    path, pfeed, jfeed = cvr_files
    got = [r.label for r in MultiSlotParser(pfeed, label_slot)
           .parse_file(path)]
    want = [r.label for r in JParser(jfeed, label_slot).parse_file(path)]
    assert got == want and len(got) == 200
    block = NativeMultiSlotParser(pfeed, label_slot).parse_file_columnar(path)
    jblock = JNativeParser(jfeed, label_slot).parse_file_columnar(path)
    np.testing.assert_array_equal(block.labels, jblock.labels)
    np.testing.assert_array_equal(block.labels, got)
    clicks = [r.label for r in MultiSlotParser(pfeed).parse_file(path)]
    assert (got == clicks) == (label_slot == "click")


def test_streaming_dataset_positional_read_threads_and_shuffler(tmp_path,
                                                               data):
    """StreamingDataset(feed, source_dir, ledger_dir, read_threads,
    shuffler): the reference's positions; each window's BoxDataset reads
    with them, and dataset_kwargs still reach it."""
    files, _, jfeed, pfeed = data
    shuffler = LocalShuffleGroup(1).members[0]
    flags = StreamFlags(streaming_micro_pass_instances=LINES,
                        streaming_poll_secs=0.05,
                        streaming_stable_polls=1)
    src = tmp_path / "src"
    s = StreamingDataset(pfeed, str(src), str(tmp_path), 3, shuffler,
                         flags=flags)
    j = JStream(jfeed, str(tmp_path / "jsrc"), str(tmp_path / "j"), 3,
                shuffler)
    assert (s.read_threads, s.shuffler) == (j.read_threads, j.shuffler)
    assert s.micro_pass_instances == LINES
    with open(files[0]) as fh, open(src / "part-0", "w") as out:
        out.write(fh.read())
    import time
    win = s.next_window(deadline=time.time() + 30)
    assert win is not None and win.instances == LINES
    assert win.dataset.read_threads == 3 and win.dataset.shuffler is shuffler
    s2 = StreamingDataset(pfeed, str(tmp_path / "src2"), str(tmp_path), 3,
                          dataset_kwargs={"read_threads": 5}, flags=flags)
    with open(files[0]) as fh, open(tmp_path / "src2" / "part-0", "w") as o:
        o.write(fh.read())
    win = s2.next_window(deadline=time.time() + 30)
    assert win.dataset.read_threads == 5 and win.dataset.shuffler is None


def test_pack_with_rank_offset_false_on_a_rank_offset_feed():
    """pack(records, with_rank_offset=False) on a rank_offset feed leaves
    the matrix out, None follows the feed, True builds it: each as the
    reference's."""
    rng = np.random.RandomState(6)
    slots = tuple(("s%d" % i, "uint64", 1, True, MAX_LEN)
                  for i in range(NUM_SLOTS))
    pfeed = DataFeedConfig(slots=tuple(SlotConfig(*s) for s in slots),
                           batch_size=BATCH, rank_offset=True)
    jfeed = JFeed(slots=tuple(JSlot(*s) for s in slots), batch_size=BATCH,
                  rank_offset=True)
    ours, theirs = [], []
    for i in range(20):
        sl = {s: rng.randint(1, 50, rng.randint(1, MAX_LEN + 1))
              .astype(np.uint64) for s in range(NUM_SLOTS)}
        kw = dict(label=int(rng.rand() < 0.4), rank=1 + i % 3, cmatch=222,
                  search_id=1 + i // 3)
        ours.append(SlotRecord(uint64_slots=dict(sl), **kw))
        theirs.append(JRecord(uint64_slots=dict(sl), **kw))
    p, j = BatchPacker(pfeed), JPacker(jfeed)
    for flag in (False, None, True):
        got, want = p.pack(ours, flag), j.pack(theirs, flag)
        assert (got.rank_offset is None) == (flag is False)
        if want.rank_offset is None:
            assert got.rank_offset is None
        else:
            np.testing.assert_array_equal(got.rank_offset, want.rank_offset)
        np.testing.assert_array_equal(got.keys, want.keys)


def test_deepfm_takes_embedx_dim():
    """DeepFM(spec, hidden, embedx_dim): the FM term reads that many embedx
    columns after a slot's embed_w (the rest feed the deep tower only), as
    the reference's."""
    spec, hidden = (NUM_SLOTS, 3 + D), (16,)
    jm = JDeepFM(JSpec(*spec), hidden, 5)
    jp = jm.init(jax.random.PRNGKey(2))
    m = DeepFM(ModelSpec(*spec), hidden, 5)
    assert m.embedx_dim == 5 and DeepFM(ModelSpec(*spec)).embedx_dim == D
    m.load_state_dict(params_from_jax({k: np.asarray(v)
                                       for k, v in jp.items()}))
    pooled = np.random.RandomState(3).randn(BATCH, *spec).astype(np.float32)
    want = np.asarray(jm.apply(jp, jnp.asarray(pooled)))
    with torch.no_grad():
        got = m(torch.from_numpy(pooled)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        full = DeepFM(ModelSpec(*spec), hidden)
        full.load_state_dict(m.state_dict())
        assert not np.allclose(full(torch.from_numpy(pooled)).numpy(), got)
