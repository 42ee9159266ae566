"""The join phase's pv feed, rank_attention, JoinPvDnn and the cmatch-rank
metrics against the JAX package on the CPU.

The same seeded numpy inputs go through both packages: data/pv.py and the
packer's rank_offset / cmatch_rank (bit for bit), ops/rank_attention.py
and JoinPvDnn (forward and gradients from weights carried by convert.py),
two train_passes of a narrow JoinPvDnn over a rank-offset feed against
the JAX BoxTrainer (``use_pallas_push``, its kernel interpreted, as
tests/test_torch_zoo.py runs it; the records' pv fields from
flagship.assign_pv, the same in both packages), a sparse_chunk_sync pass,
CmatchRankMetricMsg and MultiTaskMetricMsg. Tolerances:

  * the pv feed, the packer's leaves, the metric masks and bucket tables:
    exact;
  * rank_attention, batch_fc and JoinPvDnn forward and gradients: rtol
    1e-5 / atol 1e-6 (f32 products summed in another order: the port
    sums each peer's projection, the reference one einsum over peers and
    features); rows with no valid rank exactly 0;
  * two passes: per-pass loss rtol 1e-4, AUCs 1e-4 absolute, rank_param
    and the MLP rtol 1e-4 / atol 1e-6, the store's integer columns exact
    and its rows rtol 1e-4 / atol 1e-7, as the zoo's tests hold them.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.config import flags as jflags
from paddlebox_tpu.config.configs import (DataFeedConfig as JFeed,
                                          SlotConfig as JSlot,
                                          SparseOptimizerConfig as JSparse,
                                          TableConfig as JTable,
                                          TrainerConfig as JTrainerCfg)
from paddlebox_tpu.data import pv as jpv
from paddlebox_tpu.data.dataset import BoxDataset as JDataset
from paddlebox_tpu.data.packer import BatchPacker as JPacker
from paddlebox_tpu.data.slot_record import SlotRecord as JRecord
from paddlebox_tpu.metrics import auc as jauc
from paddlebox_tpu.models import MODEL_ZOO as J_ZOO
from paddlebox_tpu.models.base import ModelSpec as JSpec
from paddlebox_tpu.models.join_pv import JoinPvDnn as JJoinPv
from paddlebox_tpu.train.trainer import BoxTrainer as JTrainer
from paddlebox_tpu.train.trainer import \
    model_accepts_rank_offset as j_accepts_rank_offset

from paddlebox_tpu_torch.config.configs import (DataFeedConfig, SlotConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.convert import params_from_jax, params_to_numpy
from paddlebox_tpu_torch.data import pv
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.data.generator import write_synthetic_ctr_files
from paddlebox_tpu_torch.data.packer import BatchPacker
from paddlebox_tpu_torch.data.slot_record import SlotRecord
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.metrics import auc as pauc
from paddlebox_tpu_torch.models import MODEL_ZOO
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.join_pv import JoinPvDnn
from paddlebox_tpu_torch.models.mmoe import MMoE
from paddlebox_tpu_torch.ops import rank_attention as pra
from paddlebox_tpu_torch.train import flagship
from paddlebox_tpu_torch.train.trainer import (BoxTrainer,
                                               model_accepts_rank_offset,
                                               model_logits)

# paddlebox_tpu.ops re-exports the function rank_attention under the
# module's name
jra = importlib.import_module("paddlebox_tpu.ops.rank_attention")

D = 8
SLOT_DIM = 3 + D
NUM_SLOTS = 4
BATCH = 32
LINES = 96
MAX_LEN = 3
HIDDEN = (16, 8)
ATT = 8
CAP = 1024
LR = 5e-3
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
INT_COLS = [acc.SLOT, acc.SHOW, acc.CLICK, acc.UNSEEN_DAYS, acc.MF_SIZE]
N_STEPS = (2 * LINES + BATCH - 1) // BATCH
GROUP = "222_1,222_2,222_3,223_1"


# ------------------------------------------------------------ the pv feed

def _pv_columns(n, seed, max_ads=4):
    """ranks, cmatchs and pv offsets of n ads in pvs of 1..max_ads, with
    ranks past 3, other channels and a zero rank."""
    rng = np.random.RandomState(seed)
    sizes, t = [], 0
    while t < n:
        s = min(int(rng.randint(1, max_ads + 1)), n - t)
        sizes.append(s)
        t += s
    ranks = np.concatenate([np.arange(1, s + 1) for s in sizes]).astype(
        np.int32)
    ranks[rng.rand(n) < 0.05] = 0
    cmatchs = rng.choice([222, 223, 100, 0], size=n,
                         p=[0.4, 0.4, 0.1, 0.1]).astype(np.int32)
    return ranks, cmatchs, np.cumsum([0] + sizes).astype(np.int64)


@pytest.mark.parametrize("max_rank", [2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_build_rank_offset_matches_jax(seed, max_rank):
    ranks, cmatchs, offs = _pv_columns(57, seed)
    got = pv.build_rank_offset(ranks, cmatchs, offs, max_rank)
    want = jpv.build_rank_offset(ranks, cmatchs, offs, max_rank)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == -1).any() and (got[:, 0] > 0).any()


def _record_pair(n, seed, num_slots=NUM_SLOTS, vocab=50):
    """The same n records in both packages: slots, labels, pv fields
    (search ids shuffled so a pv's ads are not contiguous), ins_ids,
    q-values and cache indices."""
    rng = np.random.RandomState(seed)
    ranks, cmatchs, offs = _pv_columns(n, seed + 10)
    sids = np.repeat(np.arange(len(offs) - 1), np.diff(offs)) * 7 + 3
    perm = rng.permutation(n)
    ours, theirs = [], []
    for i in perm:
        slots = {s: rng.randint(1, vocab, rng.randint(1, MAX_LEN + 2))
                 .astype(np.uint64) for s in range(num_slots)}
        kw = dict(label=int(rng.rand() < 0.4), ins_id="id%d" % i,
                  rank=int(ranks[i]), cmatch=int(cmatchs[i]),
                  qvalue=float(np.float32(rng.rand())),
                  search_id=int(sids[i]), cache_idx=int(i))
        ours.append(SlotRecord(uint64_slots=dict(slots), **kw))
        theirs.append(JRecord(uint64_slots=dict(slots), **kw))
    return ours, theirs


@pytest.mark.parametrize("merge_by_sid", [True, False])
def test_preprocess_instance_and_pack_pv_batch_match_jax(merge_by_sid):
    ours, theirs = _record_pair(40, 3)
    got = pv.preprocess_instance(ours, merge_by_sid)
    want = jpv.preprocess_instance(theirs, merge_by_sid)
    assert got == want
    assert len(got) < 40 if merge_by_sid else len(got) == 40
    for max_rank in (2, 3):
        order, mat = pv.pack_pv_batch(ours, got, max_rank)
        jorder, jmat = jpv.pack_pv_batch(theirs, want, max_rank)
        assert order == jorder
        np.testing.assert_array_equal(mat, jmat)


def _feed_pair(rank_offset=True, batch=BATCH):
    slots = tuple((f"s{i}", "uint64", True, MAX_LEN)
                  for i in range(NUM_SLOTS))
    ours = DataFeedConfig(slots=tuple(SlotConfig(n, t, is_used=u,
                                                 max_len=m)
                                      for n, t, u, m in slots),
                          batch_size=batch, rank_offset=rank_offset)
    theirs = JFeed(slots=tuple(JSlot(name=n, type=t, is_used=u, max_len=m)
                               for n, t, u, m in slots),
                   batch_size=batch, rank_offset=rank_offset)
    return ours, theirs


BATCH_FIELDS = ("keys", "slots", "segments", "valid", "labels", "ins_valid",
                "qvalues", "cmatch_rank", "rank_offset")


def _assert_packed_equal(got, want):
    for f in BATCH_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is not None:
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, f)
    assert got.ins_ids == want.ins_ids and got.n_ins == want.n_ins


@pytest.mark.parametrize("n", [BATCH, 21])
@pytest.mark.parametrize("rank_offset", [True, False])
def test_packer_rank_offset_and_cmatch_rank_match_jax(rank_offset, n):
    """A full and a short batch, from a feed with and without
    rank_offset: every leaf bit for bit."""
    ours, theirs = _record_pair(n, 5)
    pfeed, jfeed = _feed_pair(rank_offset)
    got = BatchPacker(pfeed).pack(ours)
    want = JPacker(jfeed).pack(theirs)
    _assert_packed_equal(got, want)
    assert (got.rank_offset is None) == (not rank_offset)
    if got.rank_offset is not None:
        assert got.rank_offset.shape == (BATCH, 7)
        assert (got.rank_offset[n:] == -1).all()
        # peers share a batch: some row sees another row of its pv
        ro = got.rank_offset
        assert (ro[:, 2::2] >= 0).sum() > (ro[:, 0] > 0).sum()
    cm, rk = pauc.parse_cmatch_rank(got.cmatch_rank)
    np.testing.assert_array_equal(cm[:n], [r.cmatch for r in ours])
    np.testing.assert_array_equal(rk[:n], [r.rank & 0xFF for r in ours])
    assert not got.cmatch_rank[n:].any()


def test_columnar_and_record_paths_carry_the_extras(tmp_path):
    """The columnar path packs all-zero cmatch_rank and qvalues, as the
    reference's does; a rank_offset feed takes the record path in both
    packages."""
    files, feed = write_synthetic_ctr_files(
        str(tmp_path), num_files=1, lines_per_file=40, num_slots=NUM_SLOTS,
        vocab_per_slot=30, max_len=MAX_LEN)
    feed = dataclasses.replace(feed, batch_size=16)
    jfeed = _jfeed(feed)
    for ro in (False, True):
        pds = BoxDataset(dataclasses.replace(feed, rank_offset=ro))
        jds = JDataset(dataclasses.replace(jfeed, rank_offset=ro),
                       read_threads=1)
        assert pds.columnar == jds.columnar == (not ro)
        for ds in (pds, jds):
            ds.set_filelist(files)
            ds.load_into_memory()
        got, want = pds.split_batches(1)[0], jds.split_batches(1)[0]
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            _assert_packed_equal(g, w)
            assert not g.cmatch_rank.any() and not g.qvalues.any()
            if ro:
                # every record in the default pv (search_id 0, rank 0):
                # no row joins
                assert (g.rank_offset == -1).all()


def _jfeed(feed):
    """The JAX package's DataFeedConfig of a port feed."""
    return JFeed(slots=tuple(JSlot(name=s.name, type=s.type,
                                   is_used=s.is_used, max_len=s.max_len,
                                   dim=s.dim) for s in feed.slots),
                 batch_size=feed.batch_size, rank_offset=feed.rank_offset,
                 parse_ins_id=feed.parse_ins_id,
                 task_label_slots=feed.task_label_slots)


# --------------------------------------------------------- rank_attention

def _ra_inputs(n, F, out, max_rank, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, F).astype(np.float32)
    param = rng.randn(max_rank * max_rank * F, out).astype(np.float32)
    ranks, cmatchs, offs = _pv_columns(n, seed + 20, max_ads=max_rank + 1)
    ro = jpv.build_rank_offset(ranks, cmatchs, offs, max_rank)
    return x, param, ro


def _weights(out):
    return np.linspace(-1.0, 2.0, out, dtype=np.float32)


@pytest.mark.parametrize("max_rank", [2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_rank_attention_matches_jax(seed, max_rank):
    """Forward, ins_rank and the gradients of x and rank_param; a row
    with no valid rank gives exactly 0."""
    x, param, ro = _ra_inputs(48, 20, 6, max_rank, seed)
    w = _weights(6)

    def jf(x, p):
        o, r = jra.rank_attention(x, jnp.asarray(ro), p, max_rank)
        return (o * w).sum(), (o, r)

    (_, (jo, jr)), (jdx, jdp) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(param))
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = torch.from_numpy(param).requires_grad_(True)
    o, r = pra.rank_attention(tx, torch.from_numpy(ro), tp, max_rank)
    (o * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jdp), rtol=1e-5,
                               atol=1e-6)
    invalid = ro[:, 0] <= 0
    assert invalid.any() and (~invalid).any()
    assert (o.detach().numpy()[invalid] == 0).all()
    # a row no valid instance reads gets no gradient
    read = np.zeros(48, bool)
    for k in range(max_rank):
        idx = ro[:, 2 * k + 2]
        read[idx[(ro[:, 0] > 0) & (ro[:, 2 * k + 1] > 0)]] = True
    assert (tx.grad.numpy()[~read] == 0).all()


def test_rank_attention_gradient_of_a_shared_peer_repeats():
    """Many instances read one peer row (every ad of a pv reads every
    peer): its gradient is summed in one order, the same on every call."""
    x, param, _ = _ra_inputs(30, 12, 4, 3, 4)
    ro = np.full((30, 7), -1, np.int32)
    ro[:, 0] = 1 + np.arange(30) % 3
    for k in range(3):
        ro[:, 2 * k + 1] = k + 1
        ro[:, 2 * k + 2] = k            # rows 0, 1, 2 are everyone's peers
    grads = []
    for _ in range(2):
        tx = torch.from_numpy(x).requires_grad_(True)
        o, _ = pra.rank_attention(tx, torch.from_numpy(ro),
                                  torch.from_numpy(param), 3)
        o.sum().backward()
        grads.append(tx.grad.numpy().copy())
    np.testing.assert_array_equal(grads[0], grads[1])
    jdx = jax.grad(lambda x: jra.rank_attention(
        x, jnp.asarray(ro), jnp.asarray(param), 3)[0].sum())(jnp.asarray(x))
    np.testing.assert_allclose(grads[0], np.asarray(jdx), rtol=1e-5,
                               atol=1e-6)
    assert (grads[0][3:] == 0).all() and (grads[0][:3] != 0).all()


def test_batch_fc_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(5, 17, 9).astype(np.float32)
    w = rng.randn(5, 9, 4).astype(np.float32)
    b = rng.randn(5, 4).astype(np.float32)
    got = pra.batch_fc(*map(torch.from_numpy, (x, w, b)))
    want = jra.batch_fc(*map(jnp.asarray, (x, w, b)))
    assert tuple(got.shape) == (5, 17, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------------- JoinPvDnn

def _join_pair(dense_dim=0):
    spec = ModelSpec(NUM_SLOTS, SLOT_DIM, dense_dim)
    jspec = JSpec(NUM_SLOTS, SLOT_DIM, dense_dim)
    kw = dict(max_rank=3, att_dim=ATT, hidden=HIDDEN)
    return JJoinPv(jspec, **kw), JoinPvDnn(spec, **kw)


@pytest.mark.parametrize("name", sorted(MODEL_ZOO))
def test_rank_offset_predicate_matches_jax(name):
    """The port's use_rank_offset attribute picks the models whose JAX
    counterpart's apply takes rank_offset, on the class and on a model
    (BstSeqCtr's counterpart has no apply: it runs on the seq trainer)."""
    want = (hasattr(J_ZOO[name], "apply")
            and j_accepts_rank_offset(J_ZOO[name]))
    assert model_accepts_rank_offset(MODEL_ZOO[name]) is want
    if name == "join_pv_dnn":
        assert model_accepts_rank_offset(_join_pair(0)[1]) is want


@pytest.mark.parametrize("feed", ["rank_offset", "none"])
@pytest.mark.parametrize("dense", [0, 5], ids=["sparse", "dense"])
def test_join_pv_forward_and_grads_match_jax(dense, feed):
    jm, pm = _join_pair(dense)
    jp = jm.init(jax.random.PRNGKey(1))
    pm.load_state_dict(params_from_jax(jp))
    assert model_accepts_rank_offset(pm)
    assert tuple(pm.rank_param.shape) == (9 * NUM_SLOTS * SLOT_DIM, ATT)
    rng = np.random.RandomState(7)
    pooled = rng.randn(BATCH, NUM_SLOTS, SLOT_DIM).astype(np.float32)
    dn = rng.randn(BATCH, dense).astype(np.float32) if dense else None
    ro = None
    if feed == "rank_offset":
        ranks, cmatchs, offs = _pv_columns(BATCH, 8)
        ro = jpv.build_rank_offset(ranks, cmatchs, offs, 3)
    jd = None if dn is None else jnp.asarray(dn)
    jro = None if ro is None else jnp.asarray(ro)

    def jf(p, x):
        return jm.apply(p, x, jd, rank_offset=jro).sum()

    want = jm.apply(jp, jnp.asarray(pooled), jd, rank_offset=jro)
    jdp, jdx = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(pooled))
    x = torch.from_numpy(pooled).requires_grad_(True)
    got = pm(x, None if dn is None else torch.from_numpy(dn),
             rank_offset=None if ro is None else torch.from_numpy(ro))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-6)
    flat = params_from_jax(jdp)
    for name, p in pm.named_parameters():
        # without the matrix the attention is zero: rank_param gets no
        # gradient (JAX's is zeros)
        assert (p.grad is None) == (ro is None and name == "rank_param")
        g = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(g.numpy(), flat[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_bf16_forward_keeps_rank_offset_int32():
    """Under compute_dtype bfloat16 the float inputs and parameters are
    cast, the rank-offset matrix reaches the model as int32, and the
    result is the f32 forward's within bf16's rounding."""
    _, pm = _join_pair()
    seen = {}
    forward = pm.forward

    def spy(pooled, dense=None, rank_offset=None):
        seen["pooled"], seen["ro"] = pooled.dtype, rank_offset.dtype
        seen["param"] = pm.rank_param.dtype
        return forward(pooled, dense, rank_offset)

    pm.forward = spy
    rng = np.random.RandomState(3)
    pooled = torch.from_numpy(
        rng.randn(BATCH, NUM_SLOTS, SLOT_DIM).astype(np.float32))
    ranks, cmatchs, offs = _pv_columns(BATCH, 9)
    ro = torch.from_numpy(jpv.build_rank_offset(ranks, cmatchs, offs, 3))
    got = model_logits(pm, pooled, "bfloat16", feed={"rank_offset": ro})
    assert seen == {"pooled": torch.bfloat16, "ro": torch.int32,
                    "param": torch.bfloat16}
    assert got.dtype == torch.float32
    want = model_logits(pm, pooled, "float32", feed={"rank_offset": ro})
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=0.1, atol=0.1)
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    # the gradients reach the f32 masters through the casts
    got.sum().backward()
    assert pm.rank_param.grad.dtype == torch.float32
    assert torch.isfinite(pm.rank_param.grad).all()
    assert bool((pm.rank_param.grad != 0).any())


# ------------------------------------------------ two passes against JAX

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_join_data")
    files, feed = write_synthetic_ctr_files(
        str(out), num_files=2, lines_per_file=LINES, num_slots=NUM_SLOTS,
        vocab_per_slot=60, max_len=MAX_LEN, seed=11)
    pfeed = dataclasses.replace(feed, batch_size=BATCH, rank_offset=True)
    return files, _jfeed(pfeed), pfeed


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
    """The push seeds of JAX train_passes from PRNGKey(0): next_prng, then
    one split a step (a chunk under chunk sync)."""
    key, seeds = jax.random.PRNGKey(0), []
    for _ in range(passes):
        key, prng = jax.random.split(key)
        s = []
        for _ in range(n_draws):
            prng, sub = jax.random.split(prng)
            s.append(int(jax.random.randint(sub, (), 0,
                                            jnp.int32(2**31 - 1))))
        seeds.append(s)
    return seeds


def _metrics(trainer):
    trainer.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    trainer.metrics.init_cmatch_rank_metric("cm", "label", "pred", GROUP,
                                            table_size=1 << 14)


def feed_pv_pass(trainer, ds):
    """One pass's feed in either package, then the records' pv fields."""
    trainer.table.begin_feed_pass()
    ds.load_into_memory(add_keys_fn=trainer.table.add_keys)
    trainer.table.end_feed_pass()
    flagship.assign_pv(ds.records, seed=0)


def _run(trainer, ds, seeds=None, n=2):
    _metrics(trainer)
    out = []
    for p in range(n):
        if seeds is not None:
            trainer.seed_fn = iter(seeds[p]).__next__
        feed_pv_pass(trainer, ds)
        res = trainer.train_pass(ds, preloaded=True)
        out.append((res["loss"],
                    {m: trainer.metrics.get_metric_msg(m)["auc"]
                     for m in ("auc", "cm")},
                    trainer.metrics.get_metric_msg("cm")["size"]))
    return out


def _table(cls, sparse_cls):
    return cls(embedx_dim=D, pass_capacity=CAP,
               optimizer=sparse_cls(**OPT))


def _assert_passes(got, want):
    for (gl, ga, gn), (wl, wa, wn) in zip(got, want, strict=True):
        np.testing.assert_allclose(gl, wl, rtol=1e-4)
        assert gn == wn > 0
        for m in wa:
            assert abs(ga[m] - wa[m]) <= 1e-4, (m, ga[m], wa[m])
            assert 0.0 < ga[m] <= 1.0


def _assert_stores(pt, jt):
    jk, jrows = jt.table.store.state_items()
    pk, prows = pt.table.store.state_items()
    jo, po = np.argsort(jk), np.argsort(pk)
    np.testing.assert_array_equal(pk[po], jk[jo])
    np.testing.assert_array_equal(prows[po][:, INT_COLS],
                                  jrows[jo][:, INT_COLS])
    np.testing.assert_allclose(prows[po], jrows[jo], rtol=1e-4, atol=1e-7)


def _assert_dense(pt, jt):
    got = pt.params
    for k, v in jax.tree.map(np.asarray, jt.params).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def _trainers(files, jfeed, pfeed, **cfg):
    jm, pm = _join_pair()
    jt = JTrainer(jm, _table(JTable, JSparse), jfeed,
                  JTrainerCfg(dense_lr=LR, **cfg), seed=0)
    params = jax.tree.map(np.asarray, jt.params)
    pm.load_state_dict(params_from_jax(params))
    pt = BoxTrainer(pm, _table(TableConfig, SparseOptimizerConfig), pfeed,
                    TrainerConfig(dense_lr=LR, **cfg), seed=0, device="cpu")
    jds = JDataset(jfeed, read_threads=1)
    pds = BoxDataset(pfeed)
    for ds in (jds, pds):
        ds.set_filelist(files)
    return jt, pt, jds, pds, params


@pytest.mark.parametrize("scan_chunk", [1, 4])
def test_two_passes_match_jax(scan_chunk, data, pallas_module):
    """Two passes of 6 batches, per step and in a chunk of 4 and a tail of
    2: losses, AUC and the cmatch-rank AUC and its instance count,
    rank_param and the MLP, the store."""
    jt, pt, jds, pds, params = _trainers(*data, scan_chunk=scan_chunk)
    assert not pds.columnar and not jds.columnar
    want = _run(jt, jds)
    got = _run(pt, pds, _pass_seeds(N_STEPS))
    _assert_passes(got, want)
    _assert_dense(pt, jt)
    assert not np.allclose(pt.params["rank_param"], params["rank_param"])
    _assert_stores(pt, jt)
    # the quality plane holds the join channels' streams
    tags = pt.quality.report()["tags"]
    assert {"cmatch:222", "cmatch:223", "cmatch:100"} <= set(tags)
    pt.close()
    jt.close()


def test_sparse_chunk_sync_pass_matches_jax(data, pallas_module):
    """One pass of 6 batches at scan_chunk=4 under sparse_chunk_sync: each
    batch's dense step reads its own rank-offset rows."""
    jt, pt, jds, pds, _ = _trainers(*data, scan_chunk=4,
                                    sparse_chunk_sync=True)
    want = _run(jt, jds, n=1)
    got = _run(pt, pds, _pass_seeds(3, 1), n=1)
    _assert_passes(got, want)
    _assert_dense(pt, jt)
    _assert_stores(pt, jt)
    pt.close()
    jt.close()


def test_ring_leaves_carry_rank_offset(data):
    """The chunk's host staging: the rank-offset leaf after dense, int32
    [C, B, 7], beside the main path's 7."""
    files, _, pfeed = data
    _, pm = _join_pair()
    pt = BoxTrainer(pm, _table(TableConfig, SparseOptimizerConfig), pfeed,
                    TrainerConfig(dense_lr=LR, scan_chunk=4), seed=0,
                    device="cpu")
    ds = BoxDataset(pfeed)
    ds.set_filelist(files)
    feed_pv_pass(pt, ds)
    pt.table.begin_pass()
    chunk = pt._stack_batches_host(ds.split_batches(1)[0][:4])
    spec = chunk.spec()
    assert set(spec) == {"ids", "segments", "ins_valid", "labels", "uids",
                         "perm", "offsets", "rank_offset"}
    assert spec["rank_offset"] == ((4, BATCH, 7), np.dtype(np.int32))
    pt.table.end_pass()
    pt.close()


# ---------------------------------------------------------------- metrics

def _metric_tensors(n=600, seed=0):
    rng = np.random.RandomState(seed)
    cm = rng.choice([222, 223, 100], size=n).astype(np.uint64)
    rk = rng.randint(0, 5, size=n).astype(np.uint64)
    return {"label": (rng.rand(n) < 0.3).astype(np.int32),
            "pred": rng.rand(n).astype(np.float32),
            "mask": rng.rand(n) < 0.8,
            "cmatch_rank": (cm << np.uint64(32)) | rk}


@pytest.mark.parametrize("mask_var", ["", "mask"])
@pytest.mark.parametrize("group,ignore_rank", [
    (GROUP, False), ("222_2 223_4", False), ("222,223", True),
    ("222_1,100", True)])
def test_cmatch_rank_metric_matches_jax(group, ignore_rank, mask_var):
    ours = pauc.CmatchRankMetricMsg("label", "pred", "m", group,
                                    ignore_rank=ignore_rank,
                                    table_size=1 << 12, mask_var=mask_var)
    theirs = jauc.CmatchRankMetricMsg("label", "pred", "m", group,
                                      ignore_rank=ignore_rank,
                                      table_size=1 << 12, mask_var=mask_var)
    assert ours.pairs == theirs.pairs
    for seed in (0, 1):
        t = _metric_tensors(seed=seed)
        np.testing.assert_array_equal(ours.match_mask(t),
                                      theirs._match_mask(t))
        ours.add_from(t)
        theirs.add_from(t)
    np.testing.assert_array_equal(ours.calculator._table,
                                  theirs.calculator._table)
    got, want = ours.get_msg(), theirs.get_msg()
    assert got["size"] > 0
    for k, v in got.items():
        assert v == want[k], k


def test_parse_cmatch_rank_and_groups_match_jax():
    x = np.array([(222 << 32) | 3, (223 << 32) | 0xFF, 7, 0], np.uint64)
    for g, w in zip(pauc.parse_cmatch_rank(x), jauc.parse_cmatch_rank(x)):
        assert g.dtype == w.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    for spec, ign in (("222_1, 223_2", False), ("222 223_1", True)):
        assert pauc._parse_group(spec, ign) == jauc._parse_group(spec, ign)
    for mod in (pauc, jauc):
        with pytest.raises(ValueError, match="illegal"):
            mod._parse_group("222", False)


def test_multi_task_metric_over_mmoe_preds_matches_jax():
    """MMoE's two heads read per (cmatch, rank) pair: the first pair an
    instance matches picks its prediction."""
    spec = ModelSpec(NUM_SLOTS, SLOT_DIM)
    model = MMoE(spec, num_experts=2, expert_dim=8, tower=(8,),
                 generator=torch.Generator().manual_seed(0))
    t = _metric_tensors(n=BATCH * 4, seed=3)
    pooled = torch.from_numpy(np.random.RandomState(4).randn(
        BATCH * 4, NUM_SLOTS, SLOT_DIM).astype(np.float32))
    with torch.no_grad():
        logits = model(pooled)
    for task, lg in logits.items():
        t["pred_" + task] = torch.sigmoid(lg).numpy()
    group = "222_1 223_1 222_2 100_1"
    preds = ["pred_ctr", "pred_cvr", "pred_cvr", "pred_ctr"]
    ours = pauc.MultiTaskMetricMsg("label", preds, "mt", group,
                                   table_size=1 << 12, mask_var="mask")
    theirs = jauc.MultiTaskMetricMsg("label", " ".join(preds), "mt", group,
                                     table_size=1 << 12, mask_var="mask")
    ours.add_from(t)
    theirs.add_from(t)
    np.testing.assert_array_equal(ours.calculator._table,
                                  theirs.calculator._table)
    got, want = ours.get_msg(), theirs.get_msg()
    assert got == want and got["size"] > 0
    with pytest.raises(ValueError, match="pred list"):
        pauc.MultiTaskMetricMsg("label", preds[:2], "mt", group)


def test_registry_inits_the_join_metrics_and_refuses_a_phase():
    """The cmatch-rank and multi-task kinds take metric_phase 0 and 1 (the
    refusal of any phase but -1 is gone), and add_batch feeds them by the
    reference's join/update filter: the same counts as the JAX registry's
    at each phase."""
    regs = [pauc.MetricRegistry(), jauc.MetricRegistry()]
    for reg in regs:
        reg.init_cmatch_rank_metric("cm", "label", "pred", GROUP)
        reg.init_multi_task_metric("mt", "label", "pred pred", "222_1 223_1")
        reg.init_cmatch_rank_metric("cm_join", "label", "pred", GROUP,
                                    metric_phase=0)
        reg.init_multi_task_metric("mt_update", "label", "pred pred",
                                   "222_1 223_1", metric_phase=1)
    assert regs[0].metric_names() == ["cm", "mt", "cm_join", "mt_update"]
    assert [regs[0].get(n).metric_phase for n in regs[0].metric_names()] \
        == [-1, -1, 0, 1]
    for step, phase in enumerate((-1, 0, 1, 0)):
        t = _metric_tensors(seed=step)
        for reg in regs:
            reg.phase = phase
            reg.add_batch(t)
    sizes = {}
    for name in regs[0].metric_names():
        got, want = (r.get_metric_msg(name) for r in regs)
        assert got == want, name
        sizes[name] = got["size"]
    # steps at phase -1 and 0 fed the join metric, -1 and 1 the update one
    assert 0 < sizes["cm_join"] < sizes["cm"]
    assert 0 < sizes["mt_update"] < sizes["mt"]


# --------------------------------------------------------- the flagship

def test_flagship_join_pv_at_its_widths():
    """FLAGSHIP_JOIN_PV's model at the JAX defaults: rank_param [9 * 352,
    64] and the MLP 416-512-256-128-1, over FLAGSHIP's table."""
    cfg = flagship.FLAGSHIP_JOIN_PV
    m = flagship.build_model(cfg)
    assert isinstance(m, JoinPvDnn)
    assert tuple(m.rank_param.shape) == (9 * 352, 64)
    assert [tuple(getattr(m, "dnn_w%d" % i).shape) for i in range(4)] == [
        (416, 512), (512, 256), (256, 128), (128, 1)]
    assert (cfg.table(), cfg.batch, cfg.max_len) == (
        flagship.FLAGSHIP.table(), 1024, 4)


def test_assign_pv_gives_pvs_of_one_to_four_ads():
    recs = [SlotRecord() for _ in range(1000)]
    flagship.assign_pv(recs, seed=5)
    sid = np.array([r.search_id for r in recs])
    rank = np.array([r.rank for r in recs])
    cm = np.array([r.cmatch for r in recs])
    assert sid[0] == 1 and (np.diff(sid) >= 0).all()
    sizes = np.bincount(sid)[1:]
    assert sizes.min() >= 1 and sizes.max() == 4
    # ranks count 1.. inside each pv
    starts = np.r_[True, np.diff(sid) > 0]
    assert (rank[starts] == 1).all() and (np.diff(rank)[~starts[1:]]
                                          == 1).all()
    assert set(cm) == {222, 223, 100}
    assert 0.85 < np.isin(cm, (222, 223)).mean() < 0.95
    again = [SlotRecord() for _ in range(1000)]
    flagship.assign_pv(again, seed=5)
    assert [(r.search_id, r.rank, r.cmatch) for r in again] == list(
        zip(sid.tolist(), rank.tolist(), cm.tolist()))


# -------------------------------------------------------------- the card

@pytest.mark.cuda
def test_cuda_join_pv_matches_cpu(tmp_path):
    """On the card: two passes of a narrow FLAGSHIP_JOIN_PV give the
    CPU's losses and AUCs (rtol 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch finds no CUDA device")
    cfg = dataclasses.replace(flagship.FLAGSHIP_JOIN_PV, num_slots=4,
                              batch=32, capacity=4096, num_files=2,
                              lines_per_file=64, vocab_per_slot=80,
                              hidden=(16, 8))
    files, feed = flagship.write_files(str(tmp_path), cfg)
    out = {}
    for dev in ("cpu", "cuda"):
        t, ds = flagship.build_trainer(files, feed, cfg, device=dev)
        out[dev] = []
        for _ in range(2):
            flagship.load_pass(t, ds)
            r = t.train_pass(ds, preloaded=True)
            out[dev].append((r["loss"],
                             t.metrics.get_metric_msg("auc")["auc"]))
        t.close()
    np.testing.assert_allclose(np.array(out["cuda"]), np.array(out["cpu"]),
                               rtol=1e-4)
