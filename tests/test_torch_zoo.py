"""The model zoo's dense and multi-task heads against the JAX package on the
CPU: ops/data_norm.py, the five models (CtrDnn with and without data_norm,
Wide&Deep, DLRM, MMoE, ESMM) and DeepFM over dense input, the multi-task
loss, and two train_passes of each model on a hybrid feed (dense columns
and a conversion label) against the JAX BoxTrainer from the same weights,
data and per-step seeds; then the trainer's modes: sparse_chunk_sync
refusing data_norm and training a multi-task model, bf16 compute with f32
summaries, the dense state's round trip, and a day of the flagship
CtrDnn's small twin read by serving.

The JAX reference trainer runs with ``use_pallas_push`` (the Pallas
adagrad kernel interpreted on the CPU), as tests/test_torch_train.py sets
it up. Tolerances:

  * data_norm's five functions: rtol 1e-6 (elementwise, and column sums
    of positive values over 40 rows);
  * a model's forward and gradients with carried weights: rtol 1e-5 /
    atol 1e-6 (f32 matmuls and einsums reduced in another order);
  * the multi-task loss, its predictions and its logit gradients: rtol
    1e-6;
  * two passes: per-pass loss rtol 1e-4 and AUCs 1e-4 absolute, the
    data_norm summaries rtol 1e-5 (column sums over a batch reduced in
    another order, fed back through the embeddings; batch_sum, whose
    signed columns can cancel to near zero, with an absolute floor of
    1e-6), the store's integer columns exact and its rows rtol 1e-4.
"""

import dataclasses
import functools
import importlib
import os
import pickle

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
from paddlebox_tpu.models.base import ModelSpec as JSpec
from paddlebox_tpu.models.ctr_dnn import CtrDnn as JCtrDnn
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.models.dlrm import DLRM as JDLRM
from paddlebox_tpu.models.esmm import ESMM as JESMM
from paddlebox_tpu.models.mmoe import MMoE as JMMoE
from paddlebox_tpu.models.wide_deep import WideDeep as JWideDeep
from paddlebox_tpu.serving import store as jserving
from paddlebox_tpu.train.trainer import BoxTrainer as JTrainer
from paddlebox_tpu.train.trainer import _multi_task_loss

from paddlebox_tpu_torch.config.configs import (CheckpointConfig,
                                                DataFeedConfig, SlotConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.convert import (adam_state_from_optax,
                                         params_from_jax, params_to_numpy)
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.models import MODEL_ZOO
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.ctr_dnn import CtrDnn
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.models.dlrm import DLRM
from paddlebox_tpu_torch.models.esmm import ESMM
from paddlebox_tpu_torch.models.mmoe import MMoE
from paddlebox_tpu_torch.models.wide_deep import WideDeep
from paddlebox_tpu_torch.ops import data_norm as pdn
from paddlebox_tpu_torch.serving import store as pserving
from paddlebox_tpu_torch.train import checkpoint as pckpt
from paddlebox_tpu_torch.train import flagship
from paddlebox_tpu_torch.train.trainer import BoxTrainer, multi_task_loss

# paddlebox_tpu.ops re-exports the function data_norm under the module's
# name
jdn = importlib.import_module("paddlebox_tpu.ops.data_norm")

D = 8
SLOT_DIM = 3 + D
NUM_SLOTS = 4
DENSE = 5
BATCH = 32
LINES = 96
MAX_LEN = 3
HIDDEN = (16, 8)
CAP = 1024
LR = 5e-3
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
INT_COLS = [acc.SLOT, acc.SHOW, acc.CLICK, acc.UNSEEN_DAYS, acc.MF_SIZE]
N_STEPS = (2 * LINES + BATCH - 1) // BATCH


# ------------------------------------------------------------- data_norm

def _dn_inputs(slot_dim):
    """x [40, 2 * 11 + 5] of positive values with dead blocks (show 0) in
    some rows, a mask, and a state away from its init."""
    rng = np.random.RandomState(5 + slot_dim)
    x = (rng.rand(40, 2 * SLOT_DIM + DENSE) * 2.0 + 0.25).astype(np.float32)
    x[rng.rand(40) < 0.3, 0] = 0.0
    x[rng.rand(40) < 0.3, SLOT_DIM] = 0.0
    mask = rng.rand(40) < 0.6
    C = x.shape[1]
    state = (rng.uniform(50, 200, C).astype(np.float32),
             rng.uniform(10, 90, C).astype(np.float32),
             rng.uniform(100, 400, C).astype(np.float32))
    return x, mask, state


def _dn_states(state):
    return (jdn.DataNormState(*map(jnp.asarray, state)),
            pdn.DataNormState(*map(torch.from_numpy, state)))


def _close_states(got, want, rtol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol)


@pytest.mark.parametrize("slot_dim", [0, SLOT_DIM])
def test_data_norm_matches_jax(slot_dim):
    x, mask, state = _dn_inputs(slot_dim)
    js, ps = _dn_states(state)
    jx, px = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_allclose(
        pdn.data_norm(px, ps, slot_dim=slot_dim).numpy(),
        np.asarray(jdn.data_norm(jx, js, slot_dim=slot_dim)), rtol=1e-6)
    _close_states(
        pdn.data_norm_summary_update(ps, px, slot_dim=slot_dim, decay=0.99),
        jdn.data_norm_summary_update(js, jx, slot_dim=slot_dim, decay=0.99),
        rtol=1e-6)
    np.testing.assert_allclose(
        pdn.masked_data_norm(px, torch.from_numpy(mask), ps).numpy(),
        np.asarray(jdn.masked_data_norm(jx, jnp.asarray(mask), js)),
        rtol=1e-6)
    for m in (mask, np.zeros_like(mask)):
        _close_states(
            pdn.masked_data_norm_stat_update(ps, px, torch.from_numpy(m)),
            jdn.masked_data_norm_stat_update(js, jx, jnp.asarray(m)),
            rtol=1e-6)
    init_j, init_p = jdn.DataNormState.init(7), pdn.DataNormState.init(7)
    _close_states(init_p, init_j, rtol=0)


def test_data_norm_show_skip_and_count():
    """slot_dim 11 over 27 columns: the last block is 5 wide; a dead block
    gives zeros and adds nothing; without slot_dim every row counts."""
    x, _, _ = _dn_inputs(SLOT_DIM)
    ps = pdn.DataNormState.init(x.shape[1])   # integer counts: exact
    px = torch.from_numpy(x)
    y = pdn.data_norm(px, ps, slot_dim=SLOT_DIM)
    dead = x[:, 0] == 0
    assert dead.any() and (y[torch.from_numpy(dead), :SLOT_DIM] == 0).all()
    new = pdn.data_norm_summary_update(ps, px, decay=1.0, slot_dim=SLOT_DIM)
    grew = (new.batch_size - ps.batch_size).numpy()
    np.testing.assert_array_equal(grew[:SLOT_DIM], (~dead).sum())
    all_rows = pdn.data_norm_summary_update(ps, px, decay=1.0)
    np.testing.assert_array_equal(
        (all_rows.batch_size - ps.batch_size).numpy(), x.shape[0])


# ---------------------------------------------------------------- models

MODEL_NAMES = ("ctr_dnn", "ctr_dnn_dn0", "ctr_dnn_dn", "wide_deep", "dlrm",
               "mmoe", "esmm", "deepfm")


def _pair(name, dense_dim=DENSE):
    """(JAX model, port model) of one zoo entry at a small width."""
    spec = ModelSpec(NUM_SLOTS, SLOT_DIM, dense_dim)
    jspec = JSpec(NUM_SLOTS, SLOT_DIM, dense_dim)
    if name.startswith("ctr_dnn"):
        kw = dict(hidden=HIDDEN)
        if name != "ctr_dnn":
            kw.update(use_data_norm=True,
                      dn_slot_dim=0 if name == "ctr_dnn_dn0" else SLOT_DIM)
        return JCtrDnn(jspec, **kw), CtrDnn(spec, **kw)
    if name == "wide_deep":
        return JWideDeep(jspec, hidden=HIDDEN), WideDeep(spec, hidden=HIDDEN)
    if name == "dlrm":
        kw = dict(bottom=(16,), top=HIDDEN)
        return JDLRM(jspec, **kw), DLRM(spec, **kw)
    if name == "mmoe":
        kw = dict(num_experts=3, expert_dim=8, tower=(8,))
        return JMMoE(jspec, **kw), MMoE(spec, **kw)
    if name == "esmm":
        return JESMM(jspec, tower=HIDDEN), ESMM(spec, tower=HIDDEN)
    return JDeepFM(jspec, hidden=HIDDEN), DeepFM(spec, hidden=HIDDEN)


def _moved_summary(params, seed=4):
    """The JAX params with data_norm summaries away from their init."""
    if "dn_summary" not in params:
        return params
    rng = np.random.RandomState(seed)
    C = params["dn_summary"]["batch_size"].shape[0]
    return dict(params, dn_summary={
        "batch_size": jnp.asarray(rng.uniform(50, 200, C), jnp.float32),
        "batch_sum": jnp.asarray(rng.randn(C) * 10, jnp.float32),
        "batch_square_sum": jnp.asarray(rng.uniform(100, 400, C),
                                        jnp.float32)})


def _total(out):
    return (sum(v.sum() for v in out.values()) if isinstance(out, dict)
            else out.sum())


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "sparse"])
@pytest.mark.parametrize("name", MODEL_NAMES)
def test_model_forward_and_grads_match_jax(name, dense):
    jm, pm = _pair(name, DENSE if dense else 0)
    jp = _moved_summary(jm.init(jax.random.PRNGKey(3)))
    pm.load_state_dict(params_from_jax(jp))
    rng = np.random.RandomState(11)
    pooled = rng.randn(BATCH, NUM_SLOTS, SLOT_DIM).astype(np.float32)
    pooled[rng.rand(BATCH) < 0.25, 1, 0] = 0.0   # dead blocks
    dn = rng.randn(BATCH, DENSE).astype(np.float32) if dense else None
    jd = None if dn is None else jnp.asarray(dn)

    def jf(p, x):
        return _total(jm.apply(p, x, jd))

    want = jm.apply(jp, jnp.asarray(pooled), jd)
    jdp, jdx = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(pooled))
    x = torch.from_numpy(pooled).requires_grad_(True)
    got = pm(x, None if dn is None else torch.from_numpy(dn))
    _total(got).backward()
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(pm.task_names)
        assert set(got) == set(want)
        pairs = [(got[t], want[t]) for t in want]
    else:
        pairs = [(got, want)]
    for g, w in pairs:
        assert tuple(g.shape) == (BATCH,)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-6)
    flat = params_from_jax(jdp)
    for pname, p in pm.named_parameters():
        assert p.grad is not None and bool((p.grad != 0).any()), pname
        np.testing.assert_allclose(p.grad.numpy(), flat[pname].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=pname)
    # the summaries are buffers: no gradient, in the JAX params' nesting
    assert all(not n.startswith("dn_summary") for n, _ in
               pm.named_parameters())
    if "dn_summary" in jp:
        got_p = params_to_numpy(pm)
        for k, v in jp["dn_summary"].items():
            np.testing.assert_array_equal(got_p["dn_summary"][k],
                                          np.asarray(v))


def test_model_zoo_names():
    assert set(MODEL_ZOO) == {"deepfm", "ctr_dnn_expand", "ctr_dnn",
                              "wide_deep", "dlrm", "mmoe", "esmm",
                              "join_pv_dnn", "ctr_dnn_aux", "bst_seq_ctr",
                              "tp_deepfm", "ep_mmoe"}
    for name, cls in MODEL_ZOO.items():
        assert cls.name == name


def test_dlrm_pairs_are_row_major():
    """torch.triu_indices and jnp.triu_indices give the same pairs in the
    same order."""
    for S in (2, 5, 9):
        iu, ju = torch.triu_indices(S, S, 1)
        jiu, jju = jnp.triu_indices(S, k=1)
        np.testing.assert_array_equal(iu.numpy(), np.asarray(jiu))
        np.testing.assert_array_equal(ju.numpy(), np.asarray(jju))


@pytest.mark.parametrize("mode", ["sum", "esmm"])
def test_multi_task_loss_matches_jax(mode):
    rng = np.random.RandomState(9)
    logits = {t: (rng.randn(BATCH) * 3).astype(np.float32)
              for t in ("ctr", "cvr")}
    logits["ctr"][:3] = (40.0, -40.0, 0.0)   # the clip's edges
    labels = {t: (rng.rand(BATCH) < 0.4).astype(np.int32)
              for t in ("ctr", "cvr")}
    valid = rng.rand(BATCH) < 0.8

    def jf(lg):
        return _multi_task_loss(lg, {t: jnp.asarray(v)
                                     for t, v in labels.items()},
                                jnp.asarray(valid), mode)

    (jloss, jpreds), jgrad = jax.value_and_grad(jf, has_aux=True)(
        {t: jnp.asarray(v) for t, v in logits.items()})
    tl = {t: torch.from_numpy(v).requires_grad_(True)
          for t, v in logits.items()}
    loss, preds = multi_task_loss(tl, {t: torch.from_numpy(v)
                                       for t, v in labels.items()},
                                  torch.from_numpy(valid), mode)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert set(preds) == set(jpreds) == (
        {"ctr", "cvr", "ctcvr"} if mode == "esmm" else {"ctr", "cvr"})
    for t in jpreds:
        np.testing.assert_allclose(preds[t].detach().numpy(),
                                   np.asarray(jpreds[t]), rtol=1e-6)
    for t in logits:
        np.testing.assert_allclose(tl[t].grad.numpy(),
                                   np.asarray(jgrad[t]), rtol=1e-6,
                                   atol=1e-9)


# ---------------------------------------------- two passes against the JAX

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_zoo_data")
    files, feed = write_synthetic_ctr_files(
        str(out), num_files=2, lines_per_file=LINES, num_slots=NUM_SLOTS,
        vocab_per_slot=60, max_len=MAX_LEN, dense_dim=DENSE, seed=7,
        conversion=True)
    jfeed = dataclasses.replace(feed, batch_size=BATCH)
    pfeed = DataFeedConfig(
        slots=tuple(SlotConfig(s.name, s.type, is_used=s.is_used,
                               max_len=s.max_len, dim=s.dim)
                    for s in feed.slots), batch_size=BATCH,
        task_label_slots=feed.task_label_slots)
    return files, jfeed, pfeed


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


def _jax_seeds(key, n):
    """(the push seeds of one JAX train_pass with n key splits, the next
    table key): next_prng, then one split a step (a chunk under chunk
    sync)."""
    key, prng = jax.random.split(key)
    seeds = []
    for _ in range(n):
        prng, sub = jax.random.split(prng)
        seeds.append(int(jax.random.randint(sub, (), 0,
                                            jnp.int32(2**31 - 1))))
    return seeds, key


def _metrics(trainer, name):
    """'auc' on the click, and the conversion head's AUC: ESMM's ctcvr,
    MMoE's cvr."""
    trainer.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    if name == "esmm":
        trainer.metrics.init_metric("task_auc", "label_cvr", "pred_ctcvr",
                                    table_size=1 << 14)
    elif name == "mmoe":
        trainer.metrics.init_metric("task_auc", "label_cvr", "pred_cvr",
                                    table_size=1 << 14)


def _aucs(trainer):
    return {n: trainer.metrics.get_metric_msg(n)["auc"]
            for n in trainer.metrics.metric_names()}


def _table(cls, sparse_cls):
    return cls(embedx_dim=D, pass_capacity=CAP,
               optimizer=sparse_cls(**OPT))


def _run_passes(trainer, ds, name, seeds=None, n=2):
    _metrics(trainer, name)
    out = []
    for p in range(n):
        if seeds is not None:
            trainer.seed_fn = iter(seeds[p]).__next__
        res = trainer.train_pass(ds)
        out.append((res["loss"], _aucs(trainer)))
    return out


TRAIN_NAMES = ("ctr_dnn_dn", "ctr_dnn_dn0", "wide_deep", "dlrm", "mmoe",
               "esmm", "deepfm")


@pytest.fixture(scope="module")
def jax_runs(data, pallas_module):
    """The JAX trainer's two passes of every model, run once."""
    files, jfeed, _ = data
    runs = {}
    for name in TRAIN_NAMES:
        jm, _ = _pair(name)
        jt = JTrainer(jm, _table(JTable, JSparse), jfeed,
                      JTrainerCfg(dense_lr=LR), seed=0)
        params = jax.tree.map(np.asarray, jt.params)
        ds = JDataset(jfeed, read_threads=1, columnar=False)
        ds.set_filelist(files)
        passes = _run_passes(jt, ds, name)
        keys, rows = jt.table.store.state_items()
        order = np.argsort(keys)
        runs[name] = (params, passes, jax.tree.map(np.asarray, jt.params),
                      keys[order], rows[order])
        jt.close()
    return runs


def _port_trainer(name, params, pfeed, **cfg):
    _, model = _pair(name)
    model.load_state_dict(params_from_jax(params))
    return BoxTrainer(model, _table(TableConfig, SparseOptimizerConfig),
                      pfeed, TrainerConfig(dense_lr=LR, **cfg), seed=0,
                      device="cpu")


def _pass_seeds(n_draws, passes=2):
    key, seeds = jax.random.PRNGKey(0), []
    for _ in range(passes):
        s, key = _jax_seeds(key, n_draws)
        seeds.append(s)
    return seeds


def _assert_passes(got, want):
    for (gl, ga), (wl, wa) in zip(got, want, strict=True):
        np.testing.assert_allclose(gl, wl, rtol=1e-4)
        assert set(ga) == set(wa)
        for m in wa:
            assert abs(ga[m] - wa[m]) <= 1e-4, (m, ga[m], wa[m])
            assert 0.0 < ga[m] <= 1.0


@pytest.mark.parametrize("name", TRAIN_NAMES)
def test_two_passes_match_jax(name, data, jax_runs):
    files, _, pfeed = data
    params, want, jparams, keys, jrows = jax_runs[name]
    pt = _port_trainer(name, params, pfeed)
    ds = BoxDataset(pfeed)
    ds.set_filelist(files)
    got = _run_passes(pt, ds, name, _pass_seeds(N_STEPS))
    _assert_passes(got, want)
    pk, prows = pt.table.store.state_items()
    order = np.argsort(pk)
    np.testing.assert_array_equal(pk[order], keys)
    np.testing.assert_array_equal(prows[order][:, INT_COLS],
                                  jrows[:, INT_COLS])
    np.testing.assert_allclose(prows[order], jrows, rtol=1e-4, atol=1e-7)
    if "dn_summary" in jparams:
        got_dn = pt.params["dn_summary"]
        for k, v in jparams["dn_summary"].items():
            assert got_dn[k].dtype == np.float32
            # batch_sum sums signed values (embed_w, embedx), which can
            # cancel to near zero: its floor is atol 1e-6, the f32 rounding
            # of a sum of ~400 terms of ~0.03
            np.testing.assert_allclose(got_dn[k], v, rtol=1e-5,
                                       atol=1e-6 if k == "batch_sum" else 0,
                                       err_msg=k)
        # the summaries moved: every row counts without slot_dim, so the
        # count is the batch, padding rows included
        if name == "ctr_dnn_dn0":
            bs, d = np.float64(1e4), np.float64(pt.model.dn_decay)
            for _ in range(2 * N_STEPS):
                bs = bs * d + BATCH
            np.testing.assert_allclose(got_dn["batch_size"], bs, rtol=1e-6)
    pt.close()


# ----------------------------------------------------------- trainer modes

def test_sparse_chunk_sync_refuses_data_norm(data):
    _, _, pfeed = data
    _, model = _pair("ctr_dnn_dn")
    with pytest.raises(ValueError, match="data_norm"):
        BoxTrainer(model, _table(TableConfig, SparseOptimizerConfig), pfeed,
                   TrainerConfig(scan_chunk=4, sparse_chunk_sync=True),
                   device="cpu")


def test_model_spec_must_match_the_feed(data):
    _, _, pfeed = data
    _, model = _pair("wide_deep", dense_dim=0)
    with pytest.raises(ValueError, match="dense_dim"):
        BoxTrainer(model, _table(TableConfig, SparseOptimizerConfig), pfeed,
                   device="cpu")


@pytest.mark.parametrize("name", ["esmm", "mmoe"])
def test_multi_task_chunk_sync_matches_jax(name, data, pallas_module):
    """Two passes of 6 batches at scan_chunk=4 under sparse_chunk_sync (a
    chunk and a tail of 2) in both packages: the dense model per batch on
    each task's label, one merged push on the main task's clicks."""
    files, jfeed, pfeed = data
    jm, _ = _pair(name)
    cfg = dict(dense_lr=LR, scan_chunk=4, sparse_chunk_sync=True)
    jt = JTrainer(jm, _table(JTable, JSparse), jfeed, JTrainerCfg(**cfg),
                  seed=0)
    pt = _port_trainer(name, jax.tree.map(np.asarray, jt.params), pfeed,
                       scan_chunk=4, sparse_chunk_sync=True)
    jds = JDataset(jfeed, read_threads=1, columnar=False)
    pds = BoxDataset(pfeed)
    for ds in (jds, pds):
        ds.set_filelist(files)
    want = _run_passes(jt, jds, name)
    got = _run_passes(pt, pds, name, _pass_seeds(3))
    _assert_passes(got, want)
    pt.close()
    jt.close()


def test_bf16_compute_keeps_the_summary_f32(data):
    """Under compute_dtype bfloat16 the data_norm summaries stay f32
    buffers (functional_call casts parameters only), move every step, and
    normalize in f32."""
    files, _, pfeed = data
    _, model = _pair("ctr_dnn_dn")
    pt = BoxTrainer(model, _table(TableConfig, SparseOptimizerConfig), pfeed,
                    TrainerConfig(dense_lr=LR, compute_dtype="bfloat16"),
                    seed=0, device="cpu")
    before = {n: b.clone() for n, b in pt.model.named_buffers()}
    ds = BoxDataset(pfeed)
    ds.set_filelist(files)
    res = pt.train_pass(ds)
    assert np.isfinite(res["loss"])
    for n, b in pt.model.named_buffers():
        assert b.dtype == torch.float32, n
        assert not torch.equal(b, before[n]), n
    assert all(p.dtype == torch.float32 for p in pt.model.parameters())
    pt.close()


def test_dense_state_round_trips_with_the_summary(data, jax_runs):
    """params / opt_state / restore_dense carry dn_summary as the JAX
    params nest it; its Adam moments are zeros, as optax's are."""
    files, _, pfeed = data
    params, _, jparams, _, _ = jax_runs["ctr_dnn_dn"]
    pt = _port_trainer("ctr_dnn_dn", params, pfeed)
    ds = BoxDataset(pfeed)
    ds.set_filelist(files)
    pt.seed_fn = iter(_pass_seeds(N_STEPS, 1)[0]).__next__
    pt.train_pass(ds)
    p, o = pt.params, pt.opt_state
    assert set(p["dn_summary"]) == {"batch_size", "batch_sum",
                                    "batch_square_sum"}
    assert set(p) == set(params)
    for m in ("mu", "nu"):
        assert set(o[m]) == set(params)
        for v in o[m]["dn_summary"].values():
            assert not v.any()
    fresh = _port_trainer("ctr_dnn_dn", params, pfeed)
    fresh.restore_dense(p, o)
    again = fresh.params
    for k, v in p.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                np.testing.assert_array_equal(again[k][kk], vv)
        else:
            np.testing.assert_array_equal(again[k], v)
    assert fresh.opt_state["count"] == o["count"] == N_STEPS
    # the optax state of the JAX trainer crosses with the same nesting
    mu = adam_state_from_optax(_jax_opt_state(params, jparams), jparams)
    assert set(mu["mu"]["dn_summary"]) == set(p["dn_summary"])
    pt.close()
    fresh.close()


def _jax_opt_state(params, jparams):
    """A flattened optax.adam state over ``jparams`` (as the JAX trainer
    keeps one under flatten_dense_opt)."""
    import optax
    return optax.flatten(optax.adam(LR)).init(jparams)


def test_flagship_ctr_dnn_day_is_served(tmp_path):
    """A day of FLAGSHIP_CTR_DNN's small twin (CtrDnn with data_norm over
    the hybrid files): run_day's base dense.pkl holds the trainer's
    summaries and zero moments at them, both packages' serving readers
    read its xbox view, and load_base into a fresh trainer restores the
    summaries bit for bit."""
    cfg = dataclasses.replace(flagship.FLAGSHIP_CTR_DNN, num_slots=4,
                              batch=32, capacity=4096, num_files=4,
                              lines_per_file=48, vocab_per_slot=80,
                              hidden=(16, 8))
    files, feed = flagship.write_files(str(tmp_path / "data"), cfg)
    trainer, _ = flagship.build_trainer(files, feed, cfg, device="cpu")
    dss = []
    for w in (files[:2], files[2:]):
        ds = BoxDataset(feed)
        ds.set_filelist(w)
        dss.append(ds)
    ckpt = CheckpointConfig(batch_model_dir=str(tmp_path / "batch"),
                            xbox_model_dir=str(tmp_path / "xbox"))
    cm = pckpt.CheckpointManager(ckpt, trainer.table)
    stats, (batch_dir, xbox_dir) = pckpt.run_day(trainer, dss, cm, "d0")
    assert len(stats) == 2 and all(np.isfinite(s["loss"]) for s in stats)
    with open(os.path.join(batch_dir, "dense.pkl"), "rb") as f:
        dense = pickle.load(f)
    want = trainer.params["dn_summary"]
    for k, v in want.items():
        np.testing.assert_array_equal(dense["params"]["dn_summary"][k], v)
        assert not dense["opt_state"]["mu"]["dn_summary"][k].any()
    assert (want["batch_size"] > 1e4).all()
    kp, rp = pserving.read_xbox_view(xbox_dir)
    kj, rj = jserving.read_xbox_view(xbox_dir)
    np.testing.assert_array_equal(kp, kj)
    np.testing.assert_array_equal(rp, rj)
    assert kp.size > 0 and rp.shape == (kp.size, 1 + cfg.embedx)
    fresh, _ = flagship.build_trainer(files, feed, cfg, device="cpu",
                                      seed=1)
    params, opt_state, _ = pckpt.CheckpointManager(
        dataclasses.replace(ckpt, async_save=False), fresh.table).load_base(
            "d0")
    fresh.restore_dense(params, opt_state)
    for k, v in want.items():
        np.testing.assert_array_equal(fresh.params["dn_summary"][k], v)
    trainer.close()
    fresh.close()


# -------------------------------------------------------------- the card

@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(flagship.ZOO_FLAGSHIPS))
def test_cuda_zoo_matches_cpu(name, tmp_path):
    """On the card: two passes of a small twin of each zoo configuration
    give the CPU's losses and AUCs (rtol 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch finds no CUDA device")
    cfg = dataclasses.replace(flagship.ZOO_FLAGSHIPS[name], num_slots=4,
                              batch=32, capacity=4096, num_files=2,
                              lines_per_file=64, vocab_per_slot=80)
    files, feed = flagship.write_files(str(tmp_path), cfg)
    out = {}
    for dev in ("cpu", "cuda"):
        t, ds = flagship.build_trainer(files, feed, cfg, device=dev)
        out[dev] = [(r["loss"], t.metrics.get_metric_msg("auc")["auc"])
                    for r in (t.train_pass(ds), t.train_pass(ds))]
        t.close()
    np.testing.assert_allclose(np.array(out["cuda"]), np.array(out["cpu"]),
                               rtol=1e-4)
