"""The model-parallel towers' parity harness, shared by
tests/test_torch_wide_tower.py and tests/test_torch_mesh_tower_cluster.py:
the small configuration, the port's run on one rank of an ``mp`` group and
the JAX MeshTowerTrainer on a P-device mesh of virtual CPU devices
(tests/conftest.py).

The oracle runs with use_pallas_push, its kernel interpreted; the port
replays its push seeds (PRNGKey(seed + 13), one split a step, carried
across passes: ``replay_seeds``). The reference's imports stay inside the
functions that build the oracle, so a spawned rank loads torch and the
port only.
"""

import functools

import numpy as np

from paddlebox_tpu_torch.config.configs import (DataFeedConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.config.flags import PushFlags
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.wide_tower import EpMMoE, TpDeepFM
from paddlebox_tpu_torch.parallel.mesh_tower import MeshTowerTrainer

D = 4
NUM_SLOTS = 4
BATCH = 16
CAP = 1 << 12
LR = 5e-3
SEED = 3
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
INT_COLS = [acc.SLOT, acc.SHOW, acc.CLICK, acc.UNSEEN_DAYS, acc.MF_SIZE]
# small widths (the reference's own tests', tests/test_mesh_tower.py:64,
# 160)
WIDTHS = {"tp_deepfm": dict(d_wide=64, d_mid=16),
          "ep_mmoe": dict(n_experts=8, d_hidden=16, d_out=8)}
MODELS = sorted(WIDTHS)
MAX_STEPS = 64        # push seeds replayed: more than two passes take


def write_data(out, lines=96):
    """(files, the port's feed) of the synthetic CTR data. Its first batch
    has 4 clicks in 16: at a balanced first batch the towers' logits start
    near zero and the head bias's gradient is rounding noise around zero
    (2^-29 in the reference, 0 in the port at data seed 11), which Adam's
    first step, dividing a gradient by its own root mean square, turns
    into an lr-sized difference (7.9e-4 at lr 5e-3) between two correct
    implementations."""
    from paddlebox_tpu_torch.data.generator import write_synthetic_ctr_files
    files, feed = write_synthetic_ctr_files(
        str(out), num_files=2, lines_per_file=lines, num_slots=NUM_SLOTS,
        vocab_per_slot=60, max_len=3, seed=12)
    return files, DataFeedConfig(slots=feed.slots, batch_size=BATCH)


def table_cfg():
    return TableConfig(embedx_dim=D, pass_capacity=CAP,
                       optimizer=SparseOptimizerConfig(**OPT))


def port_model(name, P):
    cls = TpDeepFM if name == "tp_deepfm" else EpMMoE
    return cls(ModelSpec(NUM_SLOTS, 3 + D), n_shards=P, **WIDTHS[name])


def replay_seeds(n=MAX_STEPS, seed=SEED):
    """The reference's push seeds: PRNGKey(seed + 13), one split a step
    carried across passes, randint of the split-off key."""
    import jax
    import jax.numpy as jnp
    key, out = jax.random.PRNGKey(seed + 13), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(int(jax.random.randint(sub, (), 0, jnp.int32(2**31 - 1))))
    return out


def sorted_store(store):
    k, v = store.state_items()
    o = np.argsort(k)
    return k[o], v[o]


def port_trainer(name, P, feed, seeds, group=None, push="scatter"):
    """A MeshTowerTrainer of ``name`` over the mp group ``group`` (None:
    the world), on the CPU, replaying ``seeds``."""
    t = MeshTowerTrainer(port_model(name, P), table_cfg(), feed,
                         TrainerConfig(dense_lr=LR), group=group, seed=SEED,
                         device="cpu", push_flags=PushFlags(push, 64))
    t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    t.seed_fn = iter(seeds).__next__
    return t


def port_run(name, P, feed, files, seeds, group=None, push="scatter",
             passes=2, predict=False):
    """Two passes (``passes``) of a port trainer over ``files``: each
    pass's (loss, AUC, batches) and the store after it, the initial and
    final tensors (this rank's), and with ``predict`` predict_batches'
    (preds, labels) and the store's row count before and after."""
    t = port_trainer(name, P, feed, seeds, group, push)
    out = {"params0": t.params, "passes": [], "stores": [],
           "rank": t.mp_rank, "P": t.P, "sharded": dict(t.sharded)}
    for _ in range(passes):
        ds = BoxDataset(feed)
        ds.set_filelist(files)
        r = t.train_pass(ds)
        out["passes"].append((r["loss"],
                              t.metrics.get_metric_msg("auc")["auc"],
                              r["batches"]))
        out["stores"].append(sorted_store(t.table.store))
    out["params"] = t.params
    if predict:
        ds = BoxDataset(feed)
        ds.set_filelist(files)
        rows = len(t.table.store)
        out["predict"] = t.predict_batches(ds)
        out["rows_around_predict"] = (rows, len(t.table.store))
    return out


# ----------------------------------------------------------------- oracle

def jax_model(name, P):
    from paddlebox_tpu.models.base import ModelSpec as JSpec
    from paddlebox_tpu.models.wide_tower import EpMMoE as JEp
    from paddlebox_tpu.models.wide_tower import TpDeepFM as JTp
    cls = JTp if name == "tp_deepfm" else JEp
    return cls(JSpec(NUM_SLOTS, 3 + D), n_shards=P, **WIDTHS[name])


def jax_feed(pfeed):
    from paddlebox_tpu.config.configs import DataFeedConfig as JFeed
    from paddlebox_tpu.config.configs import SlotConfig as JSlot
    return JFeed(slots=tuple(JSlot(name=s.name, type=s.type, dim=s.dim,
                                   is_used=s.is_used, max_len=s.max_len)
                             for s in pfeed.slots), batch_size=pfeed.batch_size)


def jax_table_cfg():
    from paddlebox_tpu.config.configs import SparseOptimizerConfig as JOpt
    from paddlebox_tpu.config.configs import TableConfig as JTable
    return JTable(embedx_dim=D, pass_capacity=CAP, optimizer=JOpt(**OPT))


def jax_run(name, P, pfeed, files, passes=2, push="scatter"):
    """The reference's MeshTowerTrainer of ``name`` on a P-device mp mesh
    with use_pallas_push (its kernel interpreted) and the push write
    ``push``: its initial params, each pass's (loss, AUC, batches) and
    sorted store, the final params (numpy, sharded leaves [P, ...]) and
    the sharded mask."""
    import jax
    from jax.sharding import Mesh
    import pytest
    from paddlebox_tpu.config import flags as jflags
    from paddlebox_tpu.config.configs import TrainerConfig as JTC
    from paddlebox_tpu.data.dataset import BoxDataset as JDataset
    from paddlebox_tpu.parallel.mesh_tower import MeshTowerTrainer as JTower
    import paddlebox_tpu.embedding.pallas_push as pp
    jfeed = jax_feed(pfeed)
    old = {k: jflags.get_flag(k) for k in ("use_pallas_push", "push_write")}
    jflags.set_flag("use_pallas_push", True)
    jflags.set_flag("push_write", push)
    patch = pytest.MonkeyPatch()
    patch.setattr(pp, "pallas_apply_push",
                  functools.partial(pp.pallas_apply_push, interpret=True))
    try:
        jt = JTower(jax_model(name, P), jax_table_cfg(), jfeed,
                    JTC(dense_lr=LR),
                    mesh=Mesh(np.array(jax.devices()[:P]), ("mp",)),
                    seed=SEED)
        jt.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
        out = {"params0": {k: np.array(v) for k, v in jt.params.items()},
               "sharded": dict(jt.sharded), "passes": [], "stores": []}
        for _ in range(passes):
            ds = JDataset(jfeed, read_threads=1, columnar=False)
            ds.set_filelist(files)
            r = jt.train_pass(ds)
            out["passes"].append((r["loss"],
                                  jt.metrics.get_metric_msg("auc")["auc"],
                                  r["batches"]))
            out["stores"].append(sorted_store(jt.table.store))
        out["params"] = {k: np.array(v) for k, v in jt.params.items()}
    finally:
        for k, v in old.items():
            jflags.set_flag(k, v)
        patch.undo()
    return out


# ------------------------------------------------------------- assertions

def assert_store(got, want):
    """Keys and the integer columns (show and click among them) exact, the
    rows rtol 1e-4 / atol 1e-6."""
    (gk, gv), (wk, wv) = got, want
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gv[:, INT_COLS], wv[:, INT_COLS])
    np.testing.assert_allclose(gv, wv, rtol=1e-4, atol=1e-6)


def assert_matches_jax(got_passes, got_stores, got_params, want):
    """A port run against the JAX run at the reference's own gates
    (tests/test_mesh_tower.py:115-147): each pass's loss rtol 1e-4 and AUC
    within 1e-4, the store after each pass, the dense params (stacked,
    convert.tower_params_to_jax) rtol 2e-4 / atol 1e-6."""
    for (gl, ga, gb), (wl, wa, wb) in zip(got_passes, want["passes"]):
        assert gb == wb
        np.testing.assert_allclose(gl, wl, rtol=1e-4)
        assert abs(ga - wa) <= 1e-4, (ga, wa)
    assert len(got_stores) == len(want["stores"])
    for g, w in zip(got_stores, want["stores"]):
        assert_store(g, w)
    assert set(got_params) == set(want["params"])
    for k, v in want["params"].items():
        np.testing.assert_allclose(got_params[k], v, rtol=2e-4, atol=1e-6,
                                   err_msg=k)


def assert_bits(a, b):
    np.testing.assert_array_equal(np.asarray(a).view(np.uint32),
                                  np.asarray(b).view(np.uint32))


def assert_same_stores(a, b):
    for (ak, av), (bk, bv) in zip(a, b):
        np.testing.assert_array_equal(ak, bk)
        assert_bits(av, bv)
