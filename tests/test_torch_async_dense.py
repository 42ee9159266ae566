"""The port's async dense table and BoxTrainer's async mode against the JAX
package's: AsyncDenseTable bit for bit (single pushes, the same bursts
handed to ``_apply``, the summary mask, state and load_state), the flat
vector against ``jax.flatten_util.ravel_pytree`` on the zoo's models, the
async step's flat grads and two async passes against the JAX BoxTrainer's
(each push waits for the drain, so both tables apply the same bursts), the
refusals, and a RecoverableRunner resume in async mode.

The JAX reference trainer runs with ``use_pallas_push`` (the Pallas kernel
interpreted on the CPU), as tests/test_torch_train.py sets it up.
Tolerances: the table and the flat vector bit for bit (the same numpy
arithmetic; the same f32 values moved); the first step's flat grad rtol
1e-5 / atol 1e-6 (the same gradients reduced in another order), the rest
rtol 1e-3 / atol 1e-5 (they start from parameters already apart by f32
rounding); the passes loss rtol 1e-4 and AUC 1e-4 absolute, store rows
rtol 1e-4 with the integer columns exact (tests/test_torch_zoo.py's).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from paddlebox_tpu.config import flags as jflags
from paddlebox_tpu.config.configs import (SparseOptimizerConfig as JSparse,
                                          TableConfig as JTable,
                                          TrainerConfig as JTrainerCfg)
from paddlebox_tpu.data.dataset import BoxDataset as JDataset
from paddlebox_tpu.data.generator import write_synthetic_ctr_files
from paddlebox_tpu.models.base import ModelSpec as JSpec
from paddlebox_tpu.models.ctr_dnn import CtrDnn as JCtrDnn
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.models.join_pv import JoinPvDnn as JJoinPv
from paddlebox_tpu.models.mmoe import MMoE as JMMoE
from paddlebox_tpu.models.nn_cross import CtrDnnExpand as JCtrDnnExpand
from paddlebox_tpu.train.async_dense import AsyncDenseTable as JTable_
from paddlebox_tpu.train.trainer import BoxTrainer as JTrainer
from paddlebox_tpu.train.trainer import _flat_summary_mask

from paddlebox_tpu_torch.config.configs import (CheckpointConfig,
                                                DataFeedConfig, SlotConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.config.flags import CkptFlags
from paddlebox_tpu_torch.convert import (flatten_params, params_from_jax,
                                         unflatten_params)
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.ctr_dnn import CtrDnn
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.models.join_pv import JoinPvDnn
from paddlebox_tpu_torch.models.mmoe import MMoE
from paddlebox_tpu_torch.models.nn_cross import CtrDnnExpand
from paddlebox_tpu_torch.train import checkpoint as pckpt
from paddlebox_tpu_torch.train.async_dense import AsyncDenseTable
from paddlebox_tpu_torch.train.recovery import RecoverableRunner
from paddlebox_tpu_torch.train.trainer import BoxTrainer, summary_mask
from paddlebox_tpu_torch.utils.stats import stat_get

D = 8
SLOT_DIM = 3 + D
NUM_SLOTS = 4
DENSE = 5
BATCH = 32
LINES = 96
HIDDEN = (16, 8)
CAP = 1024
LR = 5e-3
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
INT_COLS = [acc.SLOT, acc.SHOW, acc.CLICK, acc.UNSEEN_DAYS, acc.MF_SIZE]
N_STEPS = (2 * LINES + BATCH - 1) // BATCH


def bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def assert_bits_equal(a, b):
    np.testing.assert_array_equal(bits(a), bits(b))


# ----------------------------------------------------------------- the table

def _tables(n=300, mask=True, **kw):
    rng = np.random.RandomState(0)
    init = rng.randn(n).astype(np.float32)
    m = (rng.rand(n) < 0.1) if mask else None
    return (AsyncDenseTable(init, lr=1e-2, summary_mask=m, **kw),
            JTable_(init, lr=1e-2, summary_mask=m, **kw))


def _grads(k, n=300, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randn(n).astype(np.float32) * 0.1 for _ in range(k)]


def test_table_single_pushes_match_jax():
    """Each push drained before the next: the same single-grad applies,
    bit for bit, with the summary slots taking the raw grad."""
    port, ref = _tables()
    try:
        before = stat_get("async_dense_applies")
        for g in _grads(6):
            for t in (port, ref):
                t.push(g)
                t.wait_drained()
            assert_bits_equal(port.pull(), ref.pull())
        assert port.steps_applied == ref.steps_applied == 6
        assert stat_get("async_dense_applies") - before == 6
    finally:
        port.stop()
        ref.stop()


@pytest.mark.parametrize("mask", [True, False], ids=["summary", "plain"])
def test_table_bursts_match_jax(mask):
    """The same bursts handed to ``_apply``: Adam on the burst's mean, the
    summary slots on its raw sum, bit for bit."""
    port, ref = _tables(mask=mask)
    g = _grads(8, seed=2)
    try:
        for burst in (g[:3], g[3:4], g[4:8]):
            port._apply(list(burst))
            ref._apply(list(burst))
            assert_bits_equal(port.pull(), ref.pull())
        sp, sr = port.state(), ref.state()
        assert sp["t"] == sr["t"] == 3
        for k in ("params", "mom1", "mom2"):
            assert_bits_equal(sp[k], sr[k])
    finally:
        port.stop()
        ref.stop()


def test_table_state_round_trips():
    """load_state puts a table where state() was taken: the next applies
    give the same bits as on the table it came from."""
    a, ref = _tables()
    b, _ = _tables()
    try:
        for g in _grads(3):
            a._apply([g])
            ref._apply([g])
        b.load_state(ref.state())
        for g in _grads(2, seed=5):
            a._apply([g])
            b._apply([g])
        assert_bits_equal(a.pull(), b.pull())
        assert a.steps_applied == b.steps_applied == 5
    finally:
        for t in (a, b, ref):
            t.stop()


def test_table_merges_queued_bursts_and_stops():
    """Pushes queued while the thread is held merge into bursts of at most
    merge_limit; stop applies what is queued and ends the thread."""
    port, _ = _tables(merge_limit=3)
    _.stop()
    with port._lock:          # the thread waits to apply its first burst
        for g in _grads(7):
            port.push(g)
    port.wait_drained()
    assert 3 <= port.steps_applied <= 7
    port.stop()
    assert not port._thread.is_alive()


# --------------------------------------------------------- the flat vector

def _pair(name):
    """(JAX model, port model) of one zoo entry at a small width."""
    spec = ModelSpec(NUM_SLOTS, SLOT_DIM, DENSE)
    jspec = JSpec(NUM_SLOTS, SLOT_DIM, DENSE)
    if name == "ctr_dnn_dn":
        kw = dict(hidden=HIDDEN, use_data_norm=True, dn_slot_dim=SLOT_DIM)
        return JCtrDnn(jspec, **kw), CtrDnn(spec, **kw)
    if name == "ctr_dnn_expand":
        spec, jspec = ModelSpec(NUM_SLOTS, SLOT_DIM), JSpec(NUM_SLOTS,
                                                            SLOT_DIM)
        return (JCtrDnnExpand(jspec, expand_dim=4, hidden=HIDDEN),
                CtrDnnExpand(spec, 4, hidden=HIDDEN))
    if name == "mmoe":
        kw = dict(num_experts=3, expert_dim=8, tower=(8,))
        return JMMoE(jspec, **kw), MMoE(spec, **kw)
    if name == "join_pv":
        spec, jspec = ModelSpec(NUM_SLOTS, SLOT_DIM), JSpec(NUM_SLOTS,
                                                            SLOT_DIM)
        kw = dict(max_rank=3, att_dim=8, hidden=HIDDEN)
        return JJoinPv(jspec, **kw), JoinPvDnn(spec, **kw)
    return JDeepFM(jspec, hidden=HIDDEN), DeepFM(spec, hidden=HIDDEN)


@pytest.mark.parametrize("name", ["deepfm", "ctr_dnn_dn", "ctr_dnn_expand",
                                  "mmoe", "join_pv"])
def test_flatten_params_matches_ravel_pytree(name):
    """flatten_params over the port's model carrying the JAX params is
    ravel_pytree of those params, bit for bit (nested dicts, data_norm's
    summary buffers in their place); the summary mask is the reference's;
    unflatten_params writes a vector back."""
    jm, pm = _pair(name)
    jparams = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    if "dn_summary" in jparams:
        rng = np.random.RandomState(4)
        jparams["dn_summary"] = {k: (v + rng.rand(*v.shape)).astype(
            np.float32) for k, v in jparams["dn_summary"].items()}
    pm.load_state_dict(params_from_jax(jparams))
    want = np.asarray(ravel_pytree(jparams)[0])
    got = flatten_params(pm)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert_bits_equal(got, want)
    jmask = _flat_summary_mask(jax.tree.map(jnp.asarray, jparams))
    pmask = summary_mask(pm)
    if jmask is None:
        assert pmask is None
    else:
        np.testing.assert_array_equal(pmask, jmask)
        assert pmask.any() and not pmask.all()
    unflatten_params(pm, want * 2)
    assert_bits_equal(flatten_params(pm), want * 2)
    with pytest.raises(ValueError):
        unflatten_params(pm, want[:-1])


# ------------------------------------------------------------- the trainer

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_async_data")
    files, feed = write_synthetic_ctr_files(
        str(out), num_files=2, lines_per_file=LINES, num_slots=NUM_SLOTS,
        vocab_per_slot=60, max_len=3, dense_dim=DENSE, seed=7)
    jfeed = dataclasses.replace(feed, batch_size=BATCH)
    pfeed = DataFeedConfig(
        slots=tuple(SlotConfig(s.name, s.type, s.is_used, s.max_len, s.dim)
                    for s in feed.slots), batch_size=BATCH)
    return files, jfeed, pfeed


@pytest.fixture
def pallas_interpret(monkeypatch):
    import paddlebox_tpu.embedding.pallas_push as pp
    jflags.set_flag("use_pallas_push", True)
    monkeypatch.setattr(pp, "pallas_apply_push",
                        functools.partial(pp.pallas_apply_push,
                                          interpret=True))


def _pass_seeds(passes=2):
    """The JAX trainer's push seeds of each pass (next_prng, then one key
    split a step)."""
    key, out = jax.random.PRNGKey(0), []
    for _ in range(passes):
        key, prng = jax.random.split(key)
        seeds = []
        for _ in range(N_STEPS):
            prng, sub = jax.random.split(prng)
            seeds.append(int(jax.random.randint(sub, (), 0,
                                                jnp.int32(2**31 - 1))))
        out.append(seeds)
    return out


def drained(table, log):
    """Patch ``table.push`` to record each grad and wait for its apply:
    every burst is one grad, so two tables given the same grads apply the
    same bursts."""
    push = table.push

    def push_and_drain(g):
        log.append(np.array(g, np.float32))
        push(g)
        table.wait_drained()

    table.push = push_and_drain


def _port_trainer(name, params, pfeed, **cfg):
    _, model = _pair(name)
    model.load_state_dict(params_from_jax(params))
    return BoxTrainer(model, TableConfig(embedx_dim=D, pass_capacity=CAP,
                                         optimizer=SparseOptimizerConfig(
                                             **OPT)),
                      pfeed, TrainerConfig(**{"dense_lr": LR,
                                              "sync_mode": "async", **cfg}),
                      seed=0, device="cpu")


@pytest.mark.parametrize("name", ["deepfm", "ctr_dnn_dn"])
def test_async_passes_match_jax(name, data, pallas_interpret):
    """Two async passes of each trainer, every push drained: the flat
    grads (the first bit-close, from the same parameters), the losses, the
    AUC, the table's parameters and the store against the JAX trainer's;
    the module holds the table's parameters after each pass."""
    files, jfeed, pfeed = data
    jm, _ = _pair(name)
    jt = JTrainer(jm, JTable(embedx_dim=D, pass_capacity=CAP,
                             optimizer=JSparse(**OPT)), jfeed,
                  JTrainerCfg(dense_lr=LR, sync_mode="async"), seed=0)
    params = jax.tree.map(np.asarray, jt.params)
    pt = _port_trainer(name, params, pfeed)
    assert pt.async_mode and jt.async_mode
    logs = {"port": [], "jax": []}
    drained(pt.async_table, logs["port"])
    drained(jt.async_table, logs["jax"])
    jds = JDataset(jfeed, read_threads=1, columnar=False)
    pds = BoxDataset(pfeed)
    for t, ds in ((jt, jds), (pt, pds)):
        ds.set_filelist(files)
        t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    for p, seeds in enumerate(_pass_seeds()):
        pt.seed_fn = iter(seeds).__next__
        want, got = jt.train_pass(jds)["loss"], pt.train_pass(pds)["loss"]
        np.testing.assert_allclose(got, want, rtol=1e-4)
        ja = jt.metrics.get_metric_msg("auc")["auc"]
        pa = pt.metrics.get_metric_msg("auc")["auc"]
        assert abs(pa - ja) <= 1e-4, (p, pa, ja)
        assert_bits_equal(flatten_params(pt.model), pt.async_table.pull())
    assert len(logs["port"]) == len(logs["jax"]) == 2 * N_STEPS
    np.testing.assert_allclose(logs["port"][0], logs["jax"][0], rtol=1e-5,
                               atol=1e-6)
    for g, w in zip(logs["port"], logs["jax"]):
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-5)
    assert pt.async_table.steps_applied == jt.async_table.steps_applied
    np.testing.assert_allclose(pt.async_table.pull(),
                               jt.async_table.pull(), rtol=1e-4, atol=1e-6)
    pk, pv = pt.table.store.state_items()
    jk, jv = jt.table.store.state_items()
    po, jo = np.argsort(pk), np.argsort(jk)
    np.testing.assert_array_equal(pk[po], jk[jo])
    np.testing.assert_array_equal(pv[po][:, INT_COLS], jv[jo][:, INT_COLS])
    np.testing.assert_allclose(pv[po], jv[jo], rtol=1e-4, atol=1e-7)
    # the async step never moves torch.optim.Adam's state
    assert pt.opt_state["count"] == 0
    pt.close()
    jt.close()
    assert pt.async_table is None


def test_async_refusals(data):
    """Async mode runs adam only and refuses sparse_chunk_sync; the
    multi-device sync modes are refused by the single-device trainer."""
    _, _, pfeed = data
    params = jax.tree.map(np.asarray, _pair("deepfm")[0].init(
        jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="adam only"):
        _port_trainer("deepfm", params, pfeed, dense_optimizer="sgd")
    with pytest.raises(ValueError, match="sparse_chunk_sync"):
        _port_trainer("deepfm", params, pfeed, sparse_chunk_sync=True)
    for kw in (dict(sync_mode="k_step"), dict(sync_mode="sharding"),
               dict(sharding=True)):
        with pytest.raises(ValueError, match="multi-device"):
            BoxTrainer(_pair("deepfm")[1], TableConfig(embedx_dim=D),
                       pfeed, TrainerConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match="sync_mode"):
        TrainerConfig(sync_mode="bogus")
    t = _port_trainer("deepfm", params, pfeed, sync_mode="step",
                      async_mode=True)
    assert t.async_mode and t.async_table is not None
    t.close()


def _runner(trainer, root, day="d"):
    cm = pckpt.CheckpointManager(
        CheckpointConfig(batch_model_dir=str(root / "batch"),
                         xbox_model_dir=str(root / "xbox"),
                         async_save=False), trainer.table, CkptFlags())
    return RecoverableRunner(trainer, cm, day)


def test_async_runner_resume_is_continue(data, tmp_path):
    """RecoverableRunner in async mode (pushes drained): the save carries
    async_dense_state; a fresh trainer resuming after pass 1 ends pass 2
    where the uninterrupted run does, bit for bit; a checkpoint without
    the table's state is refused."""
    files, jfeed, pfeed = data
    params = jax.tree.map(np.asarray, _pair("deepfm")[0].init(
        jax.random.PRNGKey(0)))

    def datasets():
        out = []
        for fs in (files[:1], files[1:], files):
            ds = BoxDataset(pfeed)
            ds.set_filelist(fs)
            out.append(ds)
        return out

    def trainer():
        t = _port_trainer("deepfm", params, pfeed)
        drained(t.async_table, [])
        return t

    whole = trainer()
    _runner(whole, tmp_path / "a").run(datasets())
    first = trainer()
    runner = _runner(first, tmp_path / "b")
    runner.run(datasets()[:2])
    first.close()
    again = trainer()
    stats = _runner(again, tmp_path / "b").run(datasets())
    assert len(stats) == 1
    assert_bits_equal(again.async_table.pull(), whole.async_table.pull())
    assert_bits_equal(flatten_params(again.model),
                      flatten_params(whole.model))
    (ak, av), (wk, wv) = (again.table.store.state_items(),
                          whole.table.store.state_items())
    np.testing.assert_array_equal(np.sort(ak), np.sort(wk))
    assert_bits_equal(av[np.argsort(ak)], wv[np.argsort(wk)])
    # a checkpoint of a sync trainer has no table state: refused
    sync = BoxTrainer(_pair("deepfm")[1], TableConfig(
        embedx_dim=D, pass_capacity=CAP,
        optimizer=SparseOptimizerConfig(**OPT)), pfeed,
        TrainerConfig(dense_lr=LR), seed=0, device="cpu")
    _runner(sync, tmp_path / "c").run(datasets()[:1])
    late = trainer()
    with pytest.raises(ValueError, match="async dense state"):
        _runner(late, tmp_path / "c").resume()
    for t in (whole, again, sync, late):
        t.close()
