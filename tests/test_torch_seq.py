"""The behavior-sequence path of the port against the JAX package: the
attention primitives at one shard, BstSeqCtr and the single-GPU
SeqCtrTrainer.

The same seeded numpy inputs go through both packages on the CPU. The JAX
trainer runs with ``use_pallas_push`` (its Pallas adagrad kernel
interpreted, as tests/test_torch_train.py wires it), whose semantics the
port's push follows, and its push seeds are replayed into the port's
``seed_fn``. Tolerances:

  * the attention's block update and one-shard forms: rtol 1e-5 / atol
    1e-6 (einsums and exponentials in another library's order);
  * BstSeqCtr's logits and gradients from carried weights: rtol 1e-5 /
    atol 1e-6;
  * seq_ids_of, the concatenated dedup and its offsets: bit for bit;
  * two passes: per-pass loss rtol 1e-4 and AUC 1e-4 absolute, the dense
    parameters rtol 1e-4 / atol 1e-6, the store's integer columns exact
    and its rows rtol 1e-4; predictions rtol 1e-4 / atol 1e-6.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from paddlebox_tpu.config import flags as jflags
from paddlebox_tpu.config.configs import (SparseOptimizerConfig as JSparse,
                                          TableConfig as JTable,
                                          TrainerConfig as JTrainerCfg)
from paddlebox_tpu.data.dataset import BoxDataset as JDataset
from paddlebox_tpu.data.generator import write_synthetic_ctr_files
from paddlebox_tpu.models.base import ModelSpec as JSpec
from paddlebox_tpu.models.bst import BstSeqCtr as JBst
from paddlebox_tpu.parallel import ring_attention as jring
from paddlebox_tpu.parallel.mesh import device_mesh_1d
from paddlebox_tpu.parallel.seq_trainer import SeqCtrTrainer as JSeqTrainer

from paddlebox_tpu_torch.config.configs import (DataFeedConfig, SlotConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.convert import params_from_jax
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.models import MODEL_ZOO
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.bst import BstSeqCtr
from paddlebox_tpu_torch.parallel import ring_attention as pring
from paddlebox_tpu_torch.parallel.seq_trainer import SeqCtrTrainer
from paddlebox_tpu_torch.parallel.tensor_parallel import LOCAL
from paddlebox_tpu_torch.train.trainer import BoxTrainer

D = 4
NUM_SLOTS = 4
BATCH = 16
MAX_LEN = 6
SEQ_LEN = 4           # shorter than MAX_LEN: long histories are cut
SEQ_SLOT = 1
CAP = 1024
LR = 5e-3
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
INT_COLS = [acc.SLOT, acc.SHOW, acc.CLICK, acc.UNSEEN_DAYS, acc.MF_SIZE]
BST = dict(heads=2, d_head=4, d_seq=8, hidden=(16, 8))


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


# ------------------------------------------------------------ attention
def _qkv(T, seed=0, B=2, H=8, Dh=8):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, H, Dh).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
def test_block_attn_update_matches_reference(causal):
    """One block update from the empty state and from a carried one; with
    k_pos ahead of q_pos the causal mask empties the first rows, which
    the guard keeps at m = -inf, l = 0, o = 0, never NaN."""
    q, k, v = _qkv(6, seed=1)
    B, T, H, Dh = q.shape
    q_pos = np.arange(T)
    k_pos = np.arange(T) + 2
    scale = 1.0 / Dh ** 0.5
    rng = np.random.RandomState(2)
    states = [
        (np.full((B, H, T), -np.inf, np.float32),
         np.zeros((B, H, T), np.float32), np.zeros_like(q)),
        (rng.randn(B, H, T).astype(np.float32),
         rng.rand(B, H, T).astype(np.float32) + 0.5,
         rng.randn(*q.shape).astype(np.float32))]
    for m, l, o in states:
        want = jring._block_attn_update(
            *(jnp.asarray(x) for x in (q, k, v, m, l, o, k_pos, q_pos)),
            causal, scale)
        got = pring._block_attn_update(
            *(torch.from_numpy(np.asarray(x)) for x in (q, k, v, m, l, o,
                                                        k_pos, q_pos)),
            causal, scale)
        for g, w, name in zip(got, want, "mlo"):
            g = g.numpy()
            assert not np.isnan(g).any(), name
            np.testing.assert_array_equal(np.isfinite(g),
                                          np.isfinite(np.asarray(w)))
            fin = np.isfinite(g)
            _close(g[fin], np.asarray(w)[fin], msg=name)
    if causal:
        # from the empty state, rows 0 and 1 see no key
        _, l_new, o_new = pring._block_attn_update(
            *(torch.from_numpy(np.asarray(x)) for x in (
                q, k, v, *states[0], k_pos, q_pos)), causal, scale)
        assert (l_new[:, :, :2] == 0).all() and (o_new[:, :2] == 0).all()


def _shard_mapped(impl, n, causal):
    if n == 1:
        mesh, axis = Mesh(np.array(jax.devices()[:1]), ("sp",)), "sp"
    else:
        mesh, axis = device_mesh_1d(n), "dp"
    spec = P(None, axis)
    return jax.jit(jax.shard_map(
        lambda q, k, v: impl(q, k, v, axis, causal=causal), mesh=mesh,
        in_specs=(spec, spec, spec), out_specs=spec))


@pytest.mark.parametrize("name", ["ring_attention", "ulysses_attention"])
@pytest.mark.parametrize("causal", [False, True])
def test_one_shard_attention_matches_reference(name, causal):
    """The port's one-shard forms against the reference's in a 1-device
    shard_map and against its 8-device sequence-sharded run of the same
    full sequence."""
    q, k, v = _qkv(16, seed=3)
    got = getattr(pring, name)(*(torch.from_numpy(x) for x in (q, k, v)),
                               causal=causal).numpy()
    for n in (1, 8):
        want = _shard_mapped(getattr(jring, name), n, causal)(
            *(jnp.asarray(x) for x in (q, k, v)))
        _close(got, want, msg="%s over %d devices" % (name, n))


# -------------------------------------------------------------- the model
def _bst_pair(attn="ring", seed=3, spec=(NUM_SLOTS, 3 + D), T=SEQ_LEN):
    jm = JBst(JSpec(*spec), seq_len=T, n_shards=1, attn=attn, **BST)
    params, _ = jm.host_init(seed)
    pm = BstSeqCtr(ModelSpec(*spec), seq_len=T, attn=attn, **BST)
    pm.load_state_dict(params_from_jax(params))
    return jm, params, pm


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_bst_forward_and_grads_match_oracle(attn):
    """Logits and gradients (every parameter, the pooled input and the
    sequence embeddings) from carried weights: the port's forward (its
    attention ``attn``) and its oracle against the reference's
    oracle_logits, and its forward against the reference's
    seq_feature_local in a 1-device shard_map; rows with 0, 1, T and a
    random count of valid positions."""
    jm, params, pm = _bst_pair(attn)
    B, S, Din, T = 6, NUM_SLOTS, 3 + D, SEQ_LEN
    rng = np.random.RandomState(4)
    pooled = rng.randn(B, S, Din).astype(np.float32)
    emb_seq = rng.randn(B, T, Din).astype(np.float32)
    valid = rng.rand(B, T) < 0.5
    valid[0] = False
    valid[1] = [True] + [False] * (T - 1)
    valid[2] = True
    w = rng.randn(B).astype(np.float32)

    def jloss(p, pooled, emb_seq):
        return (jm.oracle_logits(p, pooled, emb_seq,
                                 jnp.asarray(valid)) * w).sum()

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jlogits = jm.oracle_logits(jp, jnp.asarray(pooled), jnp.asarray(emb_seq),
                               jnp.asarray(valid))
    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jp, jnp.asarray(pooled), jnp.asarray(emb_seq))

    mesh = Mesh(np.array(jax.devices()[:1]), ("sp",))
    local = jax.shard_map(
        lambda e, m: jm.seq_feature_local(jp, e, m, "sp"), mesh=mesh,
        in_specs=(P(None, "sp"), P(None, "sp")), out_specs=P())
    jlocal = jm.head_apply(jp, jnp.asarray(pooled),
                           local(jnp.asarray(emb_seq), jnp.asarray(valid)))

    for fn in (pm.forward, pm.oracle_logits):
        pm.zero_grad()
        x = torch.from_numpy(pooled).requires_grad_(True)
        e = torch.from_numpy(emb_seq).requires_grad_(True)
        logits = fn(x, e, torch.from_numpy(valid))
        _close(logits.detach(), jlogits, msg=fn.__name__)
        (logits * torch.from_numpy(w)).sum().backward()
        _close(x.grad, jgrads[1], msg="d pooled")
        _close(e.grad, jgrads[2], msg="d emb_seq")
        for name, p in pm.named_parameters():
            _close(p.grad, jgrads[0][name], msg=name)
        if fn == pm.forward:
            _close(logits.detach(), jlocal, msg="seq_feature_local")
    # a row with no valid position pools to zero: its feature is 0
    feat = pm.seq_feature_local(torch.from_numpy(emb_seq),
                                torch.from_numpy(valid), LOCAL)
    assert torch.equal(feat[0], torch.zeros_like(feat[0]))


def test_bst_in_the_zoo_and_refused_by_box_trainer():
    assert MODEL_ZOO["bst_seq_ctr"] is BstSeqCtr
    model = BstSeqCtr(ModelSpec(NUM_SLOTS, 3 + D), seq_len=8, **BST)
    names = [n for n, _ in model.named_parameters()]
    assert names[:6] == ["pos_emb", "wq", "wk", "wv", "wo", "bo"]
    assert names[6:] == ["dnn_w0", "dnn_b0", "dnn_w1", "dnn_b1", "dnn_w2",
                         "dnn_b2"]
    feed = DataFeedConfig(slots=(SlotConfig("s0"),), batch_size=4)
    with pytest.raises(ValueError, match="SeqCtrTrainer"):
        BoxTrainer(model, TableConfig(embedx_dim=D, pass_capacity=CAP),
                   feed, device="cpu")


# ------------------------------------------------------------ host side
@pytest.fixture(scope="module")
def data(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_seq_data")
    files, feed = write_synthetic_ctr_files(
        str(out), num_files=2, lines_per_file=96, num_slots=NUM_SLOTS,
        vocab_per_slot=60, max_len=MAX_LEN, seed=13)
    jfeed = type(feed)(slots=feed.slots, batch_size=BATCH)
    pfeed = DataFeedConfig(
        slots=tuple(SlotConfig(s.name, s.type, is_used=s.is_used,
                               max_len=s.max_len)
                    for s in feed.slots), batch_size=BATCH)
    return files, jfeed, pfeed


def _tables():
    return (JTable(embedx_dim=D, pass_capacity=CAP, optimizer=JSparse(**OPT)),
            TableConfig(embedx_dim=D, pass_capacity=CAP,
                        optimizer=SparseOptimizerConfig(**OPT)))


def _trainers(pfeed, jfeed, seed=0):
    jtab, ptab = _tables()
    jm = JBst(JSpec(NUM_SLOTS, 3 + D), seq_len=SEQ_LEN, n_shards=1, **BST)
    jt = JSeqTrainer(jm, jtab, jfeed, JTrainerCfg(dense_lr=LR),
                     seq_slot=SEQ_SLOT, seed=seed)
    pm = BstSeqCtr(ModelSpec(NUM_SLOTS, 3 + D), seq_len=SEQ_LEN, **BST)
    pm.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in jt.params.items()}))
    pt = SeqCtrTrainer(pm, ptab, pfeed, TrainerConfig(dense_lr=LR),
                       seq_slot=SEQ_SLOT, seed=seed, device="cpu")
    return jt, pt


def _open_pass(t, ds, files):
    ds.set_filelist(files)
    t.table.begin_feed_pass()
    ds.load_into_memory(add_keys_fn=t.table.add_keys)
    t.table.end_feed_pass()
    t.table.begin_pass()
    return ds.split_batches(num_workers=1)[0]


@pytest.mark.parametrize("columnar", [False, True])
def test_seq_ids_and_push_dedup_bit_equal(data, columnar):
    """seq_ids_of on the port's host tier ``columnar`` (the native
    columnar packer, or the record path) against the reference's on the
    same tier, bit for bit, histories over SEQ_LEN cut; the concatenated
    push dedup against a host recompute: uids, perm, the offsets of each
    unique's real occurrences and n_uniq, the trash row sorting last."""
    files, jfeed, pfeed = data
    jt, pt = _trainers(pfeed, jfeed)
    jb = _open_pass(jt, JDataset(jfeed, read_threads=1, columnar=columnar),
                    files)
    pb = _open_pass(pt, BoxDataset(pfeed, columnar=columnar), files)
    cut = 0
    pad = CAP - 1
    for a, b in zip(jb, pb, strict=True):
        jids = jt.table.lookup_ids(a.keys, a.valid)
        pids = pt.table.lookup_ids(b.keys, b.valid)
        np.testing.assert_array_equal(pids, jids)
        jseq, jvalid = jt.seq_ids_of(a, jids)
        pseq, pvalid = pt.seq_ids_of(b, pids)
        np.testing.assert_array_equal(pseq, jseq)
        np.testing.assert_array_equal(pvalid, jvalid)
        assert pseq.dtype == jseq.dtype
        runs = np.bincount(b.segments[(b.slots == SEQ_SLOT) & b.valid]
                           // NUM_SLOTS, minlength=BATCH)
        cut += int((runs > SEQ_LEN).sum())
        np.testing.assert_array_equal(pvalid.sum(1),
                                      np.minimum(runs, SEQ_LEN))

        h = pt.host_batch(b)
        push_ids = np.concatenate([pids, pseq.reshape(-1)])
        np.testing.assert_array_equal(
            push_ids, np.asarray(jt.host_batch(a)["push_ids"]))
        real = push_ids != pad
        assert h["n_valid"] == int(b.valid.sum())
        uniq = np.unique(push_ids[real])
        assert h["n_uniq"] == uniq.size + int((~real).any())
        order = np.argsort(push_ids, kind="stable")
        np.testing.assert_array_equal(h["perm"], order)
        np.testing.assert_array_equal(h["uids"][:h["n_uniq"]],
                                      np.unique(push_ids))
        n_real = int(real.sum())
        sorted_ids = push_ids[order][:n_real]
        starts = np.flatnonzero(np.r_[True, sorted_ids[1:]
                                      != sorted_ids[:-1]])
        want = np.full(push_ids.size + 1, n_real, np.int32)
        want[:starts.size] = starts
        np.testing.assert_array_equal(h["offsets"], want)
    assert cut > 0, "no history longer than SEQ_LEN"
    pt.table.end_pass()
    jt.table.end_pass()


# ------------------------------------------------------------ the trainer
@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX trainers with use_pallas_push, its kernel interpreted."""
    import paddlebox_tpu.embedding.pallas_push as pp
    jflags.set_flag("use_pallas_push", True)
    monkeypatch.setattr(pp, "pallas_apply_push",
                        functools.partial(pp.pallas_apply_push,
                                          interpret=True))


def _replay_seeds(seed):
    """The reference seq trainer's push seeds: PRNGKey(seed + 29), one
    split a step carried across passes, randint of the split-off key."""
    key = [jax.random.PRNGKey(seed + 29)]

    def next_seed():
        key[0], sub = jax.random.split(key[0])
        return int(jax.random.randint(sub, (), 0, jnp.int32(2**31 - 1)))
    return next_seed


def test_two_passes_match_jax(data, pallas_interpret):
    """Two train_passes of a narrow BST (history slot 1 cut at 4) against
    the reference's SeqCtrTrainer(n_shards=1), then predict_batches."""
    files, jfeed, pfeed = data
    jt, pt = _trainers(pfeed, jfeed)
    pt.seed_fn = _replay_seeds(0)
    for t in (jt, pt):
        t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    got, want = [], []
    for _ in range(2):
        jds = JDataset(jfeed, read_threads=1, columnar=False)
        jds.set_filelist(files)
        pds = BoxDataset(pfeed)
        pds.set_filelist(files)
        want.append((jt.train_pass(jds)["loss"],
                     jt.metrics.get_metric_msg("auc")["auc"]))
        res = pt.train_pass(pds)
        got.append((res["loss"], pt.metrics.get_metric_msg("auc")["auc"]))
        assert res["batches"] == 12 and res["instances"] == 192
    for (gl, ga), (wl, wa) in zip(got, want):
        np.testing.assert_allclose(gl, wl, rtol=1e-4)
        assert abs(ga - wa) <= 1e-4, (ga, wa)
    pparams = pt.params
    for k, v in jt.params.items():
        _close(pparams[k], v, rtol=1e-4, atol=1e-6, msg=k)
    keys = pt.table.pass_keys
    prow, jrow = pt.table.store.lookup(keys), jt.table.store.lookup(keys)
    np.testing.assert_array_equal(prow[:, INT_COLS], jrow[:, INT_COLS])
    np.testing.assert_allclose(prow, jrow, rtol=1e-4, atol=1e-7)
    # the store's shows count each pooled occurrence once: the history's
    # sequence rows push gradient only
    pds = BoxDataset(pfeed)
    pds.set_filelist(files)
    pds.load_into_memory()
    occ = sum(int(b.valid.sum()) for b in pds.split_batches(1)[0])
    _, vals = pt.table.store.state_items()
    assert vals[:, acc.SHOW].sum() == 2 * occ

    jds = JDataset(jfeed, read_threads=1, columnar=False)
    jds.set_filelist(files)
    pds = BoxDataset(pfeed)
    pds.set_filelist(files)
    jp, jl = jt.predict_batches(jds)
    shows = vals[:, acc.SHOW].sum()
    pp, pl = pt.predict_batches(pds)
    np.testing.assert_array_equal(pl, jl)
    _close(pp, jp, rtol=1e-4, atol=1e-6)
    assert pt.table.store.state_items()[1][:, acc.SHOW].sum() == shows


def test_trainer_refusals(data):
    files, _, pfeed = data
    _, ptab = _tables()
    model = BstSeqCtr(ModelSpec(NUM_SLOTS, 3 + D), seq_len=SEQ_LEN, **BST)
    for field, value in [("dense_optimizer", "sgd"),
                         ("compute_dtype", "bfloat16"), ("scan_chunk", 4),
                         ("sparse_chunk_sync", True),
                         ("check_nan_inf", True)]:
        with pytest.raises(ValueError, match="adam.*%s" % field):
            SeqCtrTrainer(model, ptab, pfeed,
                          TrainerConfig(**{field: value}), device="cpu")
    SeqCtrTrainer(model, ptab, pfeed, TrainerConfig(dense_lr=0.01),
                  device="cpu")
    with pytest.raises(ValueError, match="seq_slot"):
        SeqCtrTrainer(model, ptab, pfeed, seq_slot=NUM_SLOTS, device="cpu")
    with pytest.raises(ValueError, match="expand"):
        SeqCtrTrainer(BstSeqCtr(ModelSpec(NUM_SLOTS, 3 + D),
                                seq_len=SEQ_LEN, **BST),
                      dataclasses.replace(ptab, expand_embed_dim=8), pfeed,
                      device="cpu")
