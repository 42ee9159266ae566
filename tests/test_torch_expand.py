"""The expand block (NN-cross) and the other in-table rules through the
port's trainer, against the JAX package on the CPU.

Modules: pull_sparse_extended, build_push_grads_extended, seqpool_sum and
CtrDnnExpand (forward and input gradients, with converted params), the
expand contract's errors and the sparse_chunk_sync refusal. Then two
train_passes of a small CtrDnnExpand on an adagrad table with an expand
block, and of a small DeepFM on each of the adam, adam_shared and naive
tables, against the JAX BoxTrainer on the same files, weights and
per-step seeds, with a test pass (predict_batches) of the expand model
after them. The JAX trainer runs these rules in XLA (apply_push), whose
creation draws are threefry; the port keeps the Pallas kernel's hash, so
``optimizers._fresh_uniform`` is replaced by that hash here
(tests/test_torch_rules.py says how).

Tolerances: the pulls and push rows are exact (gathers and masks); the
pool and the model's forward and gradients rtol 1e-5 (f32 sums and
matmuls in other orders); per-pass loss rtol 1e-4 and AUC 1e-4 absolute
after two passes, the store's rows rtol 1e-4 with the integer columns
exact (last-bit differences, among them XLA's contracted adam moments,
fed back through the embeddings). An entry near zero is held to atol 1e-5
of its column's largest magnitude (at least 1e-7): adam's steps move
embedx by about the learning rate, so a column spans 0.4 while an entry
crossing zero keeps the column's absolute rounding (3.9e-7 seen at 2e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlebox_tpu.embedding.optimizers as jopt
from paddlebox_tpu.config.configs import (SparseOptimizerConfig as JSparse,
                                          TableConfig as JTable,
                                          TrainerConfig as JTrainerCfg)
from paddlebox_tpu.data.dataset import BoxDataset as JDataset
from paddlebox_tpu.data.generator import write_synthetic_ctr_files
from paddlebox_tpu.embedding import accessor as jacc
from paddlebox_tpu.models.base import ModelSpec as JSpec
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.models.nn_cross import CtrDnnExpand as JCtrDnnExpand
from paddlebox_tpu.ops import seqpool as jseqpool
from paddlebox_tpu.ops import sparse as jsparse
from paddlebox_tpu.train.trainer import BoxTrainer as JTrainer

from paddlebox_tpu_torch.config.configs import (DataFeedConfig, SlotConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.convert import params_from_jax, params_to_numpy
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.embedding.accessor import ValueLayout
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.models.nn_cross import CtrDnnExpand
from paddlebox_tpu_torch.ops.seqpool import seqpool_sum
from paddlebox_tpu_torch.ops.sparse import (build_push_grads_extended,
                                            pull_sparse_extended)
from paddlebox_tpu_torch.train.trainer import BoxTrainer, check_expand_config

D, E = 4, 3
NUM_SLOTS = 4
BATCH = 32
MAX_LEN = 3
HIDDEN = (16, 8)
CAP = 1024
LR = 5e-3
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
INT_COLS = [acc.SLOT, acc.SHOW, acc.CLICK, acc.UNSEEN_DAYS, acc.MF_SIZE]
LINES = 96


def hash_fresh(d):
    """_fresh_uniform as the port creates columns: the Pallas kernel's
    hash of (row id, column, seed), the seed the one _dispatch_apply_push
    would hand that kernel, expand column e (stream 1) hashing d + e."""

    def fresh(prng, row_ids, shape, dtype, maxval, stream=0):
        seed = jax.random.randint(prng, (), 0, jnp.int32(2**31 - 1))
        r = jnp.asarray(row_ids).astype(jnp.uint32)[:, None]
        c = (jnp.arange(shape[1], dtype=jnp.uint32)[None, :]
             + jnp.uint32(d if stream else 0))
        bits = (r * jnp.uint32(2654435761)) ^ (c * jnp.uint32(40503)
                                               + seed.astype(jnp.uint32))
        bits = bits * jnp.uint32(747796405) + jnp.uint32(2891336453)
        bits ^= bits >> 16
        u01 = ((bits >> 8).astype(jnp.int32).astype(jnp.float32)
               * (1.0 / (1 << 24)))
        return (u01 * maxval).astype(dtype)

    return fresh


# ------------------------------------------------------------- the modules

def test_extended_pull_and_push_grads_match_jax():
    rng = np.random.RandomState(0)
    for dt in acc.EMBED_DTYPES:
        layout = ValueLayout(D, "adagrad", E, dt)
        rows = rng.randn(64, layout.width).astype(np.float32)
        slab = acc.slab_rows_np(rows, layout)
        ids = rng.randint(0, 64, 200).astype(np.int32)
        jl = jacc.ValueLayout(D, "adagrad", E, dt)
        jslab = jacc.encode_slab_rows_np(rows, jl)
        want = jsparse.pull_sparse_extended(jnp.asarray(jslab),
                                            jnp.asarray(ids), jl)
        got = pull_sparse_extended(torch.from_numpy(slab),
                                   torch.from_numpy(ids), layout)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="no expand block"):
        pull_sparse_extended(torch.zeros(4, 17),
                             torch.zeros(2, dtype=torch.int32),
                             ValueLayout(8))
    K = 50
    d_emb = rng.randn(K, 3 + D).astype(np.float32)
    d_exp = rng.randn(K, E).astype(np.float32)
    slots = rng.randint(0, NUM_SLOTS, K).astype(np.int32)
    clicks = rng.randint(0, 2, K).astype(np.int32)
    valid = rng.rand(K) < 0.8
    want = jsparse.build_push_grads_extended(
        jnp.asarray(d_emb), jnp.asarray(d_exp), jnp.asarray(slots),
        jnp.asarray(clicks), jnp.asarray(valid))
    got = build_push_grads_extended(*(torch.from_numpy(x) for x in (
        d_emb, d_exp, slots, clicks, valid)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _pool_inputs(rng, K=300, n_valid=260):
    segments = np.sort(rng.randint(0, BATCH * NUM_SLOTS, K)).astype(np.int32)
    segments[n_valid:] = BATCH * NUM_SLOTS - 1
    valid = rng.rand(K) < 0.9
    valid[n_valid:] = False
    return segments, valid, n_valid


def test_seqpool_sum_matches_jax():
    rng = np.random.RandomState(1)
    emb = rng.randn(300, E).astype(np.float32)
    segments, valid, n_valid = _pool_inputs(rng)
    want = jseqpool.seqpool_sum(jnp.asarray(emb), jnp.asarray(segments),
                                jnp.asarray(valid), BATCH, NUM_SLOTS)
    got = seqpool_sum(torch.from_numpy(emb), torch.from_numpy(segments),
                      torch.from_numpy(valid), BATCH, NUM_SLOTS, n_valid)
    assert got.shape == (BATCH, NUM_SLOTS, E)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_ctr_dnn_expand_forward_and_grads_match_jax():
    spec, jspec = ModelSpec(NUM_SLOTS, 3 + D), JSpec(NUM_SLOTS, 3 + D)
    jm = JCtrDnnExpand(jspec, expand_dim=E, hidden=HIDDEN)
    jp = jm.init(jax.random.PRNGKey(3))
    # a cross branch that matters: lin_w and fm_scale away from their init
    jp["cross"]["lin_w"] = jp["cross"]["lin_w"] * 50.0
    jp["cross"]["fm_scale"] = jnp.float32(1.7)
    m = CtrDnnExpand(spec, E, hidden=HIDDEN)
    m.load_state_dict(params_from_jax(jp))
    got_params = params_to_numpy(m)
    assert set(got_params["cross"]) == {"lin_w", "lin_b", "fm_scale"}
    np.testing.assert_array_equal(got_params["cross"]["lin_w"],
                                  np.asarray(jp["cross"]["lin_w"]))
    rng = np.random.RandomState(2)
    pooled = rng.randn(BATCH, NUM_SLOTS, 3 + D).astype(np.float32)
    expand = rng.randn(BATCH, NUM_SLOTS, E).astype(np.float32)

    def jloss(p, e):
        return jm.apply(jp, p, expand=e).sum()

    want = jm.apply(jp, jnp.asarray(pooled), expand=jnp.asarray(expand))
    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(pooled),
                                         jnp.asarray(expand))
    tp = torch.from_numpy(pooled).requires_grad_(True)
    te = torch.from_numpy(expand).requires_grad_(True)
    out = m(tp, te)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg[0]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jg[1]),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="expand input"):
        m(tp)
    with pytest.raises(ValueError, match="expand_dim > 0"):
        CtrDnnExpand(spec, 0)


def _feed():
    return DataFeedConfig(slots=(SlotConfig("s0"), SlotConfig("s1")),
                          batch_size=4)


def _table(e=E, rule="adagrad"):
    return TableConfig(embedx_dim=D, expand_embed_dim=e, pass_capacity=CAP,
                       optimizer=SparseOptimizerConfig(optimizer=rule, **OPT))


def test_expand_contract_errors():
    spec = ModelSpec(2, 3 + D)
    with pytest.raises(ValueError, match="expand_embed_dim == 0"):
        BoxTrainer(CtrDnnExpand(spec, E), _table(0), _feed(), device="cpu")
    with pytest.raises(ValueError, match="model.expand_dim=5 != "
                                         "TableConfig.expand_embed_dim=3"):
        BoxTrainer(CtrDnnExpand(spec, 5), _table(), _feed(), device="cpu")
    with pytest.raises(ValueError, match="does not consume the expand"):
        BoxTrainer(DeepFM(spec, hidden=(4,)), _table(), _feed(),
                   device="cpu")
    with pytest.raises(ValueError, match="adagrad/naive"):
        BoxTrainer(CtrDnnExpand(spec, E), _table(rule="adam"), _feed(),
                   device="cpu")
    # the contract alone, as the reference's check_expand_config words it
    check_expand_config(CtrDnnExpand(spec, E), ValueLayout(D, "naive", E),
                        True)
    check_expand_config(DeepFM(spec, hidden=(4,)), ValueLayout(D), False)


def test_sparse_chunk_sync_refuses_an_expand_model():
    with pytest.raises(ValueError, match="sparse_chunk_sync is unsupported"):
        BoxTrainer(CtrDnnExpand(ModelSpec(2, 3 + D), E), _table(), _feed(),
                   TrainerConfig(sparse_chunk_sync=True), device="cpu")


# ------------------------------------------- two passes against the JAX one

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_expand_data")
    files, feed = write_synthetic_ctr_files(
        str(out), num_files=2, lines_per_file=LINES, num_slots=NUM_SLOTS,
        vocab_per_slot=60, max_len=MAX_LEN, seed=7)
    jfeed = type(feed)(slots=feed.slots, batch_size=BATCH)
    pfeed = DataFeedConfig(
        slots=tuple(SlotConfig(s.name, s.type, s.is_used, s.max_len)
                    for s in feed.slots), batch_size=BATCH)
    return files, jfeed, pfeed


def _jax_pass_seeds(table_key, n_steps):
    """(the push seeds of one JAX train_pass, the next table key): the
    table's next_prng, then one split a step, each step's seed the
    randint the Pallas push would take (tests/test_torch_train.py)."""
    table_key, prng = jax.random.split(table_key)
    seeds = []
    for _ in range(n_steps):
        prng, sub = jax.random.split(prng)
        seeds.append(int(jax.random.randint(sub, (), 0,
                                            jnp.int32(2**31 - 1))))
    return seeds, table_key


# (model, rule, expand width): the expand model on adagrad, DeepFM on each
# other rule
CASES = {"expand": ("expand", "adagrad", E), "adam": ("deepfm", "adam", 0),
         "adam_shared": ("deepfm", "adam_shared", 0),
         "naive": ("deepfm", "naive", 0)}


def _models(kind):
    spec, jspec = ModelSpec(NUM_SLOTS, 3 + D), JSpec(NUM_SLOTS, 3 + D)
    if kind == "expand":
        return (JCtrDnnExpand(jspec, expand_dim=E, hidden=HIDDEN),
                CtrDnnExpand(spec, E, hidden=HIDDEN))
    return JDeepFM(jspec, hidden=HIDDEN), DeepFM(spec, hidden=HIDDEN)


def _run(trainer, files, feed, cls, seeds=None, **ds_kw):
    trainer.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    ds = cls(feed, **ds_kw)
    ds.set_filelist(files)
    out = []
    for p in range(2):
        if seeds is not None:
            trainer.seed_fn = iter(seeds[p]).__next__
        res = trainer.train_pass(ds)
        out.append((res["loss"], trainer.metrics.get_metric_msg("auc")["auc"]))
    test = cls(feed, **ds_kw)
    test.set_filelist(files[1:])
    test.load_into_memory()
    return out, trainer.predict_batches(test)


@pytest.fixture(scope="module")
def jax_runs(data):
    """The JAX trainer's two passes and test pass of every case, with the
    port's creation hash, run once for the module."""
    files, jfeed, _ = data
    mp = pytest.MonkeyPatch()
    mp.setattr(jopt, "_fresh_uniform", hash_fresh(D))
    runs = {}
    try:
        for name, (kind, rule, e) in CASES.items():
            jm, _ = _models(kind)
            jt = JTrainer(jm, JTable(embedx_dim=D, expand_embed_dim=e,
                                     pass_capacity=CAP,
                                     optimizer=JSparse(optimizer=rule,
                                                       **OPT)),
                          jfeed, JTrainerCfg(dense_lr=LR), seed=0)
            params = jax.tree.map(np.asarray, jt.params)
            passes, test = _run(jt, files, jfeed, JDataset, read_threads=1,
                                columnar=False)
            keys, rows = jt.table.store.state_items()
            order = np.argsort(keys)
            runs[name] = (params, passes, test, keys[order], rows[order])
            jt.close()
    finally:
        mp.undo()
    return runs


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_passes_match_jax(name, data, jax_runs):
    files, _, pfeed = data
    kind, rule, e = CASES[name]
    params, want, (jpreds, jlabels), keys, jrows = jax_runs[name]
    _, model = _models(kind)
    model.load_state_dict(params_from_jax(params))
    pt = BoxTrainer(model, _table(e, rule), pfeed,
                    TrainerConfig(dense_lr=LR), seed=0, device="cpu")
    n_steps = (2 * LINES + BATCH - 1) // BATCH
    key, seeds = jax.random.PRNGKey(0), []
    for _ in range(2):
        s, key = _jax_pass_seeds(key, n_steps)
        seeds.append(s)
    got, (preds, labels) = _run(pt, files, pfeed, BoxDataset, seeds=seeds)
    for (gl, ga), (wl, wa) in zip(got, want):
        np.testing.assert_allclose(gl, wl, rtol=1e-4)
        assert abs(ga - wa) <= 1e-4, (ga, wa)
    assert 0.0 < got[-1][1] <= 1.0
    pkeys, _ = pt.table.store.state_items()
    np.testing.assert_array_equal(np.sort(pkeys), keys)
    rows = pt.table.store.lookup(keys)
    assert rows.shape[1] == pt.table.layout.width == jrows.shape[1]
    np.testing.assert_array_equal(rows[:, INT_COLS], jrows[:, INT_COLS])
    # near zero, an entry is held to its column's scale
    atol = np.maximum(1e-5 * np.abs(jrows).max(axis=0), 1e-7)
    assert (np.abs(rows - jrows) <= atol + 1e-4 * np.abs(jrows)).all()
    # the test pass after them (predict_batches): nothing written back
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_allclose(preds, jpreds, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(pt.table.store.lookup(keys), rows)
    if kind == "expand":
        lay = pt.table.layout
        assert np.abs(rows[:, lay.expand_w:lay.expand_w + E]).max() > 0
        assert (rows[:, lay.expand_state] > 0).any()
