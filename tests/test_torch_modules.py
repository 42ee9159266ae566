"""The port's modules against their JAX counterparts on the same inputs.

Inputs come from numpy seeds and go through both packages on the CPU.
Tolerances: host products (ids, dedup, batches, store rows, generated
files) are exact; the pool and the push merge add in the same order as the
JAX sorted segment sums and are held to rtol 1e-6; DeepFM forward and
gradients, whose float32 matmuls and reductions XLA and ATen order
differently, to rtol 1e-5; the AUC bundle, float64 host math, to 1e-12.
"""

import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.config.configs import (SparseOptimizerConfig as JSparse,
                                          TableConfig as JTable)
from paddlebox_tpu.data.dataset import BoxDataset as JDataset
from paddlebox_tpu.data.generator import (
    write_synthetic_ctr_files as jax_write_files)
from paddlebox_tpu.embedding.accessor import ValueLayout as JLayout
from paddlebox_tpu.embedding.host_store import (
    HostEmbeddingStore as JHostStore)
from paddlebox_tpu.embedding.native_store import make_host_store
from paddlebox_tpu.embedding.pass_table import (
    dedup_ids as jax_dedup_ids, first_occurrence_idx as jax_first_idx)
from paddlebox_tpu.metrics.auc import BasicAucCalculator as JAuc
from paddlebox_tpu.models.base import ModelSpec as JSpec
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.ops import seqpool as jseqpool
from paddlebox_tpu.ops import sparse as jsparse

from paddlebox_tpu_torch.config.configs import (DataFeedConfig, SlotConfig,
                                                SparseOptimizerConfig,
                                                TableConfig)
from paddlebox_tpu_torch.convert import params_from_jax
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.data.generator import write_synthetic_ctr_files
from paddlebox_tpu_torch.embedding.accessor import ValueLayout
from paddlebox_tpu_torch.embedding.host_store import HostEmbeddingStore
from paddlebox_tpu_torch.embedding.pass_table import (PassTable, dedup_ids,
                                                      segment_offsets)
from paddlebox_tpu_torch.embedding.push_kernels import merge_push_grads
from paddlebox_tpu_torch.metrics.auc import BasicAucCalculator
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.ops import seqpool, sparse

D = 8
NUM_SLOTS = 4
BATCH = 32
MAX_LEN = 3


def _port_feed(jfeed, batch_size=BATCH):
    return DataFeedConfig(
        slots=tuple(SlotConfig(s.name, s.type, is_used=s.is_used,
                               max_len=s.max_len)
                    for s in jfeed.slots), batch_size=batch_size)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_modules_data")
    jfiles, jfeed = jax_write_files(str(out / "jax"), num_files=2,
                                    lines_per_file=80, num_slots=NUM_SLOTS,
                                    vocab_per_slot=40, max_len=MAX_LEN,
                                    seed=5)
    pfiles, _ = write_synthetic_ctr_files(str(out / "port"), num_files=2,
                                          lines_per_file=80,
                                          num_slots=NUM_SLOTS,
                                          vocab_per_slot=40,
                                          max_len=MAX_LEN, seed=5)
    return jfiles, pfiles, type(jfeed)(slots=jfeed.slots, batch_size=BATCH)


def test_generator_writes_the_jax_files(files):
    jfiles, pfiles, _ = files
    for a, b in zip(jfiles, pfiles):
        assert filecmp.cmp(a, b, shallow=False)


@pytest.mark.parametrize("kw", [
    dict(num_slots=32, vocab_per_slot=20000, max_len=4, seed=0),
    dict(num_slots=5, vocab_per_slot=3, max_len=1, seed=2),
    dict(num_slots=3, vocab_per_slot=70000, max_len=9, seed=3),
], ids=["flagship-widths", "one-key-slots", "wide-vocab-long-slots"])
def test_generator_writes_the_jax_files_at_other_shapes(tmp_path, kw):
    """The port's generator is byte-equal to the JAX generator beyond the
    default shape: at the flagship's widths, where a vocabulary or slot
    length is off a power of two, where a slot holds one key, and across
    files."""
    jfiles, _ = jax_write_files(str(tmp_path / "jax"), num_files=2,
                                lines_per_file=150, **kw)
    pfiles, _ = write_synthetic_ctr_files(str(tmp_path / "port"),
                                          num_files=2, lines_per_file=150,
                                          **kw)
    for a, b in zip(jfiles, pfiles, strict=True):
        assert filecmp.cmp(a, b, shallow=False)


def test_dataset_batches_equal_jax(files):
    jfiles, _, jfeed = files
    jds = JDataset(jfeed, read_threads=1, columnar=False)
    pds = BoxDataset(_port_feed(jfeed))
    jkeys, pkeys = [], []
    jds.set_filelist(jfiles)
    pds.set_filelist(jfiles)
    jds.load_into_memory(add_keys_fn=jkeys.append)
    pds.load_into_memory(add_keys_fn=pkeys.append)
    np.testing.assert_array_equal(np.unique(np.concatenate(jkeys)),
                                  np.unique(np.concatenate(pkeys)))
    jds.local_shuffle(123)
    pds.local_shuffle(123)
    jb = jds.split_batches(1)[0]
    pb = pds.split_batches(1)[0]
    assert len(jb) == len(pb) == 5
    for a, b in zip(jb, pb):
        for f in ("keys", "slots", "segments", "valid", "labels",
                  "ins_valid"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.n_ins == b.n_ins


def test_new_rows_and_host_store_match_jax():
    conf = dict(initial_range=0.05)
    jtable = JTable(embedx_dim=D, pass_capacity=1024,
                    optimizer=JSparse(**conf))
    ptable = TableConfig(embedx_dim=D, pass_capacity=1024,
                         optimizer=SparseOptimizerConfig(**conf))
    rng_a, rng_b = np.random.RandomState(9), np.random.RandomState(9)
    np.testing.assert_array_equal(
        ValueLayout(D).new_rows(50, rng_a, ptable.optimizer),
        JLayout(D, "adagrad").new_rows(50, rng_b, jtable.optimizer))
    layout = JLayout(D, "adagrad")
    stores = [HostEmbeddingStore(ValueLayout(D), ptable, seed=4),
              JHostStore(layout, jtable, seed=4),
              make_host_store(layout, jtable, 4)]
    rng = np.random.RandomState(0)
    k1 = np.unique(rng.randint(0, 1 << 40, 300).astype(np.uint64))
    k2 = np.unique(np.concatenate(
        [k1[::3], rng.randint(0, 1 << 40, 200).astype(np.uint64)]))
    got = [[s.lookup_or_create(k1) for s in stores]]
    upd = got[0][0] + 1.0
    for s in stores:
        s.write_back(k1, upd)
    got.append([s.lookup_or_create(k2) for s in stores])
    got.append([s.lookup(np.concatenate([k2[:5], np.uint64([7, 8])]))
                for s in stores])
    for rows in got:
        for other in rows[1:]:
            np.testing.assert_array_equal(rows[0], other)
    assert len(stores[0]) == len(np.union1d(k1, k2))


def test_pass_table_ids_and_dedup_match_jax():
    rng = np.random.RandomState(1)
    table = PassTable(TableConfig(embedx_dim=D, pass_capacity=256),
                      device="cpu")
    keys = rng.randint(0, 1 << 40, 100).astype(np.uint64)
    table.begin_feed_pass()
    table.add_keys(keys[:60])
    table.add_keys(keys[40:])
    table.end_feed_pass()
    batch = rng.choice(keys, 90)
    valid = rng.rand(90) > 0.2
    ids = table.lookup_ids(batch, valid)
    np.testing.assert_array_equal(
        ids, np.where(valid, np.searchsorted(np.unique(keys), batch), 255))
    with pytest.raises(KeyError):
        table.lookup_ids(np.uint64([3]))
    uids, perm, inv, n_uniq = dedup_ids(ids, 256)
    ju, jp, ji = jax_dedup_ids(ids, 256, sort=True)
    for a, b in ((uids, ju), (perm, jp), (inv, ji)):
        np.testing.assert_array_equal(a, b)
    assert n_uniq == np.unique(ids).size and (np.diff(uids) > 0).all()
    # the push's runs over the real occurrences: searchsorted of each
    # unique in inv[:n_valid], each run starting at the JAX first_idx
    n_valid = int(valid.sum())
    offsets = segment_offsets(inv, n_valid)
    np.testing.assert_array_equal(
        offsets, np.searchsorted(inv[:n_valid], np.arange(ids.size + 1)))
    live = np.flatnonzero(np.diff(offsets) > 0)
    assert live.size == np.unique(ids[valid]).size
    np.testing.assert_array_equal(perm[offsets[live]],
                                  jax_first_idx(jp, ji)[live])


def _grads_case(pad_frac, seed=2, K=96, cap=1024):
    """Per-occurrence push rows; about pad_frac of the occurrences are
    padding (trash-row id, all-zero grads), as the train step builds them."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 40, K).astype(np.int32)
    ids[rng.rand(K) < pad_frac] = cap - 1
    grads = rng.randn(K, 4 + D).astype(np.float32)
    grads[ids == cap - 1] = 0.0
    uids, perm, inv, _ = dedup_ids(ids, cap)
    return ids, grads, uids, perm, inv


@pytest.mark.parametrize("pad_frac", [0.0, 0.25])
def test_merge_matches_jax_segment_sum(pad_frac):
    """The merge skips the padding occurrences; JAX's segment_sum adds all
    of them, and the two agree (with no padding, and with a quarter)."""
    ids, grads, uids, perm, inv = _grads_case(pad_frac)
    want = np.asarray(jax.ops.segment_sum(
        jnp.asarray(grads)[jnp.asarray(perm)], jnp.asarray(inv),
        num_segments=uids.shape[0], indices_are_sorted=True))
    offsets = segment_offsets(inv, int((ids != 1023).sum()))
    got = merge_push_grads(torch.from_numpy(grads), torch.from_numpy(perm),
                           torch.from_numpy(offsets)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    n_real = np.unique(ids[ids != 1023]).size
    assert not got[n_real:].any()  # trash row and padding tail: zero


def _pool_case(tail, seed=3):
    """One packed batch's pull view, segments and validity, with a padding
    tail of `tail` keys pinned to the last segment."""
    rng = np.random.RandomState(seed)
    B, S = 6, 3
    counts = rng.randint(0, 4, B * S)
    segments = np.repeat(np.arange(B * S, dtype=np.int32), counts)
    K = segments.size + tail
    segments = np.concatenate([segments, np.full(tail, B * S - 1, np.int32)])
    valid = np.arange(K) < K - tail
    emb = rng.rand(K, 3 + D).astype(np.float32)
    emb[:, :2] = rng.randint(0, 5, (K, 2))
    return B, S, emb, segments, valid


@pytest.mark.parametrize("use_cvm,tail", [(True, 7), (False, 7), (True, 0)])
def test_fused_seqpool_cvm_forward_and_grad(use_cvm, tail):
    """The pool skips the padding tail; JAX's masked segment_sum adds it as
    zeros, and the two agree (tail 0: every key is real)."""
    B, S, emb, segments, valid = _pool_case(tail)
    cot = np.random.RandomState(4).randn(
        B, S, 3 + D if use_cvm else 1 + D).astype(np.float32)

    def jf(e):
        out = jseqpool.fused_seqpool_cvm(e, jnp.asarray(segments),
                                         jnp.asarray(valid), B, S,
                                         use_cvm=use_cvm,
                                         sorted_segments=True)
        return (out * cot).sum(), out
    (_, jout), jgrad = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(emb))
    e = torch.from_numpy(emb).requires_grad_(True)
    out = seqpool.fused_seqpool_cvm(
        e, torch.from_numpy(segments), torch.from_numpy(valid), B, S,
        use_cvm=use_cvm, sorted_segments=True, n_valid=int(valid.sum()))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-6, atol=1e-7)


def test_pull_view_and_push_grads_match_jax():
    rng = np.random.RandomState(6)
    layout = ValueLayout(D)
    slab = rng.rand(64, layout.width).astype(np.float32)
    ids = rng.randint(0, 64, 40).astype(np.int32)
    rows = sparse.gather_slab_rows(torch.from_numpy(slab),
                                   torch.from_numpy(ids))
    jrows = jsparse.gather_slab_rows(jnp.asarray(slab), jnp.asarray(ids),
                                     JLayout(D, "adagrad"))
    np.testing.assert_array_equal(
        sparse.pull_view_from_rows(rows, layout).numpy(),
        np.asarray(jsparse.pull_view_from_rows(jrows, JLayout(D, "adagrad"))))
    demb = rng.randn(40, 3 + D).astype(np.float32)
    slots = rng.randint(0, 4, 40).astype(np.int32)
    clicks = rng.randint(0, 2, 40).astype(np.int32)
    valid = rng.rand(40) > 0.3
    np.testing.assert_array_equal(
        sparse.build_push_grads(*map(torch.from_numpy,
                                     (demb, slots, clicks, valid))).numpy(),
        np.asarray(jsparse.build_push_grads(*map(jnp.asarray,
                                                 (demb, slots, clicks,
                                                  valid)))))


def test_deepfm_forward_and_grads_with_carried_weights():
    spec = (NUM_SLOTS, 3 + D)
    jm = JDeepFM(JSpec(*spec), hidden=(16, 8))
    params = jm.init(jax.random.PRNGKey(2))
    pm = DeepFM(ModelSpec(*spec), hidden=(16, 8))
    pm.load_state_dict(params_from_jax({k: np.asarray(v)
                                        for k, v in params.items()}))
    pooled = np.random.RandomState(7).randn(BATCH, *spec).astype(np.float32)

    def jf(p, x):
        return jm.apply(p, x).sum() * 0.5, jm.apply(p, x)
    (_, jlogits), (jdp, jdx) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(params, jnp.asarray(pooled))
    x = torch.from_numpy(pooled).requires_grad_(True)
    logits = pm(x)
    (logits.sum() * 0.5).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-6)
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jdp[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_auc_calculator_matches_jax():
    rng = np.random.RandomState(8)
    jc, pc = JAuc(1 << 12), BasicAucCalculator(1 << 12)
    for _ in range(3):
        pred = rng.rand(200)
        label = (rng.rand(200) < pred).astype(np.int32)
        mask = rng.rand(200) > 0.1
        jc.add_data(pred, label, mask)
        pc.add_data(pred, label, mask)
    jc.compute()
    pc.compute()
    for f in ("auc", "bucket_error", "mae", "rmse", "actual_ctr",
              "predicted_ctr", "size"):
        assert abs(getattr(pc, f)() - getattr(jc, f)()) <= 1e-12, f
