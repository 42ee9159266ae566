"""The port's dense optimizers sgd and adagrad against the JAX package's.

make_dense_optimizer's adagrad is written by hand in optax's form
(train/dense_optim.py OptaxAdagrad); sgd is torch.optim.SGD. Tolerances:

  * one optimizer over several steps of the same gradients against
    optax.adagrad / optax.sgd: rtol 1e-6 / atol 1e-8 (rsqrt against
    1 / sqrt, and a multiply-add that may be fused in one library and
    not in the other, round differently in the last bit);
  * two train_passes of a narrow DeepFM under each optimizer against the
    JAX trainer (use_pallas_push, its kernel interpreted, its push seeds
    replayed), at the test's rate and at the flagship's DENSE_LR:
    per-pass loss rtol 1e-4, AUC 1e-4 absolute, dense parameters and
    accumulators rtol 1e-4 / atol 1e-6, the store's integer columns exact
    and its rows rtol 1e-4;
  * two passes at the flagship's widths and DENSE_LR on a cut of its
    data, per-pass loss and AUC as above, and the JAX trainer's own loss
    trend: it falls under adam and rises under sgd and adagrad;
  * the state's round trips and resume = continue: bit for bit.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from paddlebox_tpu.config import flags as jflags
from paddlebox_tpu.config.configs import (SparseOptimizerConfig as JSparse,
                                          TableConfig as JTable,
                                          TrainerConfig as JTrainerCfg)
from paddlebox_tpu.data.dataset import BoxDataset as JDataset
from paddlebox_tpu.data.generator import write_synthetic_ctr_files
from paddlebox_tpu.models.base import ModelSpec as JSpec
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.train.trainer import BoxTrainer as JTrainer

from paddlebox_tpu_torch.config.configs import (CheckpointConfig,
                                                DataFeedConfig, SlotConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.convert import (adagrad_state_from_optax,
                                         params_from_jax)
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.train import checkpoint as pckpt
from paddlebox_tpu_torch.train import flagship
from paddlebox_tpu_torch.train.dense_optim import (OptaxAdagrad,
                                                   adagrad_update_,
                                                   make_dense_optimizer)
from paddlebox_tpu_torch.train.recovery import RecoverableRunner
from paddlebox_tpu_torch.train.trainer import BoxTrainer

D = 8
NUM_SLOTS = 4
BATCH = 32
MAX_LEN = 3
HIDDEN = (16, 8)
CAP = 1024
LR = 5e-2
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
INT_COLS = [acc.SLOT, acc.SHOW, acc.CLICK, acc.UNSEEN_DAYS, acc.MF_SIZE]


# ------------------------------------------------------- the update rules
def _steps(name, n=6, seed=0):
    """(the port's params after n steps, optax's) over the same grads:
    three tensors, one with entries whose gradient is always 0."""
    rng = np.random.RandomState(seed)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 2)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) * (1 + 3 * i)
              for k, s in shapes.items()} for i in range(n)]
    for g in grads:
        g["b"][:2] = 0.0
    tx = getattr(optax, name)(LR)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = make_dense_optimizer(TrainerConfig(dense_lr=LR,
                                             dense_optimizer=name),
                               tp.values())
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st,
                            jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in g.items():
            tp[k].grad = torch.from_numpy(v.copy())
        opt.step()
    return tp, jp, opt, st, p0


@pytest.mark.parametrize("name", ["sgd", "adagrad"])
def test_update_matches_optax(name):
    tp, jp, opt, st, p0 = _steps(name)
    for k in jp:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-8, err_msg=k)
        assert not np.array_equal(tp[k].detach().numpy(), p0[k])
    # the zero-gradient entries never move
    np.testing.assert_array_equal(tp["b"].detach().numpy()[:2], p0["b"][:2])
    if name == "adagrad":
        assert isinstance(opt, OptaxAdagrad)
        rss = st[0].sum_of_squares
        for k in jp:
            np.testing.assert_allclose(
                opt.state[tp[k]]["sum_of_squares"].numpy(),
                np.asarray(rss[k]), rtol=1e-6, err_msg=k)
    else:
        assert isinstance(opt, torch.optim.SGD) and not opt.state


def test_adagrad_from_a_zero_accumulator():
    """The update rule from an accumulator at 0: an entry whose gradient
    stays 0 keeps acc = 0 and takes no step (optax's where(acc > 0)), the
    others match optax.adagrad(initial_accumulator_value=0)."""
    g = torch.tensor([0.0, 0.5, -2.0])
    p, acc = torch.ones(3), torch.zeros(3)
    tx = optax.adagrad(LR, initial_accumulator_value=0.0)
    jp = jnp.ones(3)
    st = tx.init(jp)
    for _ in range(3):
        adagrad_update_(p, g, acc, LR)
        upd, st = tx.update(jnp.asarray(g.numpy()), st, jp)
        jp = optax.apply_updates(jp, upd)
    assert float(p[0]) == 1.0 and float(acc[0]) == 0.0
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-8)


def test_config_refuses_unknown_optimizer():
    with pytest.raises(ValueError, match="dense_optimizer"):
        TrainerConfig(dense_optimizer="momentum")
    assert flagship.FLAGSHIP_SGD.dense_optimizer == "sgd"
    assert flagship.FLAGSHIP_DENSE_ADAGRAD.dense_optimizer == "adagrad"
    assert dataclasses.replace(flagship.FLAGSHIP_SGD,
                               dense_optimizer="adam") == flagship.FLAGSHIP


# ------------------------------------------------------------ two passes
@pytest.fixture(scope="module")
def data(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_dense_opt_data")
    files, feed = write_synthetic_ctr_files(
        str(out), num_files=2, lines_per_file=96, num_slots=NUM_SLOTS,
        vocab_per_slot=60, max_len=MAX_LEN, seed=7)
    jfeed = type(feed)(slots=feed.slots, batch_size=BATCH)
    pfeed = DataFeedConfig(
        slots=tuple(SlotConfig(s.name, s.type, is_used=s.is_used,
                               max_len=s.max_len)
                    for s in feed.slots), batch_size=BATCH)
    return files, jfeed, pfeed


@pytest.fixture
def pallas_interpret(monkeypatch):
    import paddlebox_tpu.embedding.pallas_push as pp
    jflags.set_flag("use_pallas_push", True)
    monkeypatch.setattr(pp, "pallas_apply_push",
                        functools.partial(pp.pallas_apply_push,
                                          interpret=True))


def _table(cap=CAP):
    return TableConfig(embedx_dim=D, pass_capacity=cap,
                       optimizer=SparseOptimizerConfig(**OPT))


def _port_trainer(pfeed, name, jparams=None, seed=0, lr=LR,
                  num_slots=NUM_SLOTS, hidden=HIDDEN, cap=CAP):
    model = DeepFM(ModelSpec(num_slots=num_slots, slot_dim=3 + D),
                   hidden=hidden,
                   generator=torch.Generator().manual_seed(seed))
    if jparams is not None:
        model.load_state_dict(params_from_jax(
            {k: np.asarray(v) for k, v in jparams.items()}))
    t = BoxTrainer(model, _table(cap), pfeed,
                   TrainerConfig(dense_lr=lr, dense_optimizer=name),
                   seed=seed, device="cpu")
    t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    return t


def _pass_seeds(n_steps, n_passes=2):
    """The JAX trainer's push seeds a pass: next_prng, then a split a
    step (tests/test_torch_train.py)."""
    key, out = jax.random.PRNGKey(0), []
    for _ in range(n_passes):
        key, prng = jax.random.split(key)
        seeds = []
        for _ in range(n_steps):
            prng, sub = jax.random.split(prng)
            seeds.append(int(jax.random.randint(
                sub, (), 0, jnp.int32(2**31 - 1))))
        out.append(seeds)
    return out


def _two_passes(files, jfeed, pfeed, name, lr, n_lines=2 * 96,
                num_slots=NUM_SLOTS, hidden=HIDDEN, cap=CAP):
    """(JAX trainer, port trainer, [(JAX loss, port loss) a pass]) after
    two train_passes of DeepFM from the same weights, the port's loss and
    AUC held to the JAX trainer's each pass."""
    jt = JTrainer(JDeepFM(JSpec(num_slots=num_slots, slot_dim=3 + D),
                          hidden=hidden),
                  JTable(embedx_dim=D, pass_capacity=cap,
                         optimizer=JSparse(**OPT)), jfeed,
                  JTrainerCfg(dense_lr=lr, dense_optimizer=name), seed=0)
    pt = _port_trainer(pfeed, name, jt.params, lr=lr, num_slots=num_slots,
                       hidden=hidden, cap=cap)
    jt.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    jds = JDataset(jfeed, read_threads=1, columnar=False)
    pds = BoxDataset(pfeed)
    for ds in (jds, pds):
        ds.set_filelist(files)
    seeds = _pass_seeds(-(-n_lines // jfeed.batch_size))
    losses = []
    for p in range(2):
        want = jt.train_pass(jds)["loss"]
        pt.seed_fn = iter(seeds[p]).__next__
        got = pt.train_pass(pds)["loss"]
        np.testing.assert_allclose(got, want, rtol=1e-4)
        assert abs(pt.metrics.get_metric_msg("auc")["auc"]
                   - jt.metrics.get_metric_msg("auc")["auc"]) <= 1e-4
        losses.append((float(want), float(got)))
    return jt, pt, losses


# the test's rate, and the flagship's (FLAGSHIP_SGD and
# FLAGSHIP_DENSE_ADAGRAD train at DENSE_LR)
@pytest.mark.parametrize("lr", [LR, flagship.DENSE_LR])
@pytest.mark.parametrize("name", ["sgd", "adagrad"])
def test_two_passes_match_jax(data, pallas_interpret, name, lr):
    files, jfeed, pfeed = data
    jt, pt, _ = _two_passes(files, jfeed, pfeed, name, lr)
    jparams = {k: np.asarray(v) for k, v in jt.params.items()}
    for k, v in jparams.items():
        np.testing.assert_allclose(pt.params[k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    if name == "adagrad":
        want = adagrad_state_from_optax(jt.opt_state, jparams)
        got = pt.opt_state["sum_of_squares"]
        assert sorted(got) == sorted(want["sum_of_squares"])
        for k, v in want["sum_of_squares"].items():
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    else:
        assert pt.opt_state == {}
    keys = pt.table.pass_keys
    prow, jrow = pt.table.store.lookup(keys), jt.table.store.lookup(keys)
    np.testing.assert_array_equal(prow[:, INT_COLS], jrow[:, INT_COLS])
    np.testing.assert_allclose(prow, jrow, rtol=1e-4, atol=1e-7)


# a cut of the flagship's data at its widths (32 slots, batch 1024, max_len
# 4, embedx 8, DeepFM 512-256-128, its data seed): 4 files of 1024 lines,
# not 4096, over 10,000 ids a slot, not 20,000, and a 2^19-row slab
FLAGSHIP_CUT = dict(num_files=4, lines_per_file=1024, vocab_per_slot=10000)


@pytest.fixture(scope="module")
def flagship_cut(tmp_path_factory):
    f = flagship.FLAGSHIP
    out = tmp_path_factory.mktemp("torch_dense_opt_flagship_cut")
    files, feed = write_synthetic_ctr_files(
        str(out), num_slots=f.num_slots, max_len=f.max_len,
        seed=f.data_seed, **FLAGSHIP_CUT)
    jfeed = type(feed)(slots=feed.slots, batch_size=f.batch)
    pfeed = DataFeedConfig(
        slots=tuple(SlotConfig(s.name, s.type, is_used=s.is_used,
                               max_len=s.max_len)
                    for s in feed.slots), batch_size=f.batch)
    return files, jfeed, pfeed


@pytest.mark.parametrize("name", ["adam", "sgd", "adagrad"])
def test_flagship_rate_learns_as_jax(flagship_cut, pallas_interpret, name):
    """At the flagship's widths and dense rate (DENSE_LR) on a cut of its
    data, the port follows the JAX trainer pass by pass, and the JAX
    trainer's own loss falls from pass 1 to pass 2 under adam and rises
    under sgd and adagrad: at this rate those two learn nothing in two
    passes in the reference either."""
    files, jfeed, pfeed = flagship_cut
    f = flagship.FLAGSHIP
    _, _, losses = _two_passes(
        files, jfeed, pfeed, name, flagship.DENSE_LR,
        n_lines=FLAGSHIP_CUT["num_files"] * FLAGSHIP_CUT["lines_per_file"],
        num_slots=f.num_slots, hidden=f.hidden, cap=1 << 19)
    (jax1, _), (jax2, _) = losses
    assert (jax2 < jax1) == (name == "adam"), losses


# ------------------------------------------------------- state and resume
@pytest.mark.parametrize("name", ["adam", "sgd", "adagrad"])
def test_opt_state_round_trip_and_mismatch(data, name):
    """opt_state under optax's names restores bit for bit into a fresh
    trainer; a state of any other optimizer is refused before anything
    is set."""
    files, _, pfeed = data
    t = _port_trainer(pfeed, name)
    ds = BoxDataset(pfeed)
    ds.set_filelist(files[:1])
    t.train_pass(ds)
    params, state = t.params, t.opt_state
    fields = {"adam": ["count", "mu", "nu"], "sgd": [],
              "adagrad": ["sum_of_squares"]}[name]
    assert sorted(state) == fields
    fresh = _port_trainer(pfeed, name, seed=1)
    fresh.restore_dense(params, state)
    for k, v in params.items():
        np.testing.assert_array_equal(fresh.params[k], v)
    again = fresh.opt_state
    for f in fields:
        if f == "count":
            assert again[f] == state[f]
            continue
        for k, v in state[f].items():
            np.testing.assert_array_equal(again[f][k], v)
    for other in ("adam", "sgd", "adagrad"):
        if other == name:
            continue
        t2 = _port_trainer(pfeed, other, seed=2)
        before = t2.params
        with pytest.raises(ValueError, match="does not load"):
            t2.restore_dense(params, state)
        for k, v in before.items():
            np.testing.assert_array_equal(t2.params[k], v)


def _runner_run(root, pfeed, windows, name):
    t = _port_trainer(pfeed, name)
    cm = pckpt.CheckpointManager(
        CheckpointConfig(batch_model_dir=os.path.join(root, "batch"),
                         xbox_model_dir=os.path.join(root, "xbox")),
        t.table)
    datasets = []
    for w in windows:
        d = BoxDataset(pfeed)
        d.set_filelist(w)
        datasets.append(d)
    stats = RecoverableRunner(t, cm, "day").run(datasets)
    return t, stats


def test_adagrad_resume_equals_continue(data, tmp_path):
    """RecoverableRunner under the dense adagrad: two passes, then a fresh
    trainer and runner over three resume at pass 2 and end bit-equal to
    an uninterrupted run (loss, dense parameters, accumulators, store); an
    adam checkpoint is refused by an adagrad trainer's resume."""
    files, _, pfeed = data
    windows = [files[:1], files[1:], files]
    ta, sa = _runner_run(str(tmp_path / "a"), pfeed, windows, "adagrad")
    _runner_run(str(tmp_path / "i"), pfeed, windows[:2], "adagrad")
    tb, sb = _runner_run(str(tmp_path / "i"), pfeed, windows, "adagrad")
    assert len(sb) == 1 and sb[0]["loss"] == sa[2]["loss"]
    for k, v in ta.params.items():
        np.testing.assert_array_equal(tb.params[k], v)
    acc_a = ta.opt_state["sum_of_squares"]
    acc_b = tb.opt_state["sum_of_squares"]
    for k, v in acc_a.items():
        np.testing.assert_array_equal(acc_b[k], v)
    ka, va = ta.table.store.state_items()
    kb, vb = tb.table.store.state_items()
    oa, ob = np.argsort(ka), np.argsort(kb)
    np.testing.assert_array_equal(ka[oa], kb[ob])
    np.testing.assert_array_equal(va[oa].view(np.uint32),
                                  vb[ob].view(np.uint32))
    _runner_run(str(tmp_path / "m"), pfeed, windows[:1], "adam")
    with pytest.raises(ValueError, match="optimizer"):
        _runner_run(str(tmp_path / "m"), pfeed, windows, "adagrad")
