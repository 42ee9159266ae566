"""The port's chunk driver: run_scan_chunks, the staging pool, the
staged-ahead producer, the chunk step and chunk-synchronous sparse.

On the CPU (plain kernel versions) at a narrow size:

  * run_scan_chunks as the reference's tests hold it
    (tests/test_e2e_train.py:177-242): a staging error, SystemExit
    included, surfaces at the caller, and a consumer error stops the
    stager before it has staged every chunk, leaving no thread alive;
  * the staging pool stages the same arrays with 1 and 4 threads, on both
    host tiers (tests/test_trainer_modes.py:154-190);
  * the chunk path is bit-equal to the per-step path (store rows, dense
    parameters, losses, AUC) over chunk_prefetch_depth 0-2,
    h2d_stack_chunks 1-2, a pass with a tail, and a preloaded run;
  * the port against the JAX trainer, both at scan_chunk=4, the JAX push
    on its Pallas kernel interpreted: integer slab columns exact, rows,
    losses and AUC at tests/test_torch_train.py's tolerances (rtol 1e-4,
    AUC 1e-4 absolute after two passes); the same for sparse_chunk_sync
    against the JAX scan_chunk_fn, seeds replayed one a chunk;
  * the reference's chunk-sync invariants, bit for bit
    (tests/test_sparse_chunk_sync.py:67-127): chunks of one batch equal
    exact mode, and chunks whose batches share no key equal exact mode;
  * check_nan_inf raises FloatingPointError on both paths.

One test needs the card (the ``cuda`` marker): pinned, stream-copied
staging bit-equal to pageable copies.
"""

import dataclasses
import functools
import threading
import time

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
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.train.trainer import BoxTrainer as JTrainer

from paddlebox_tpu_torch.config.configs import (DataFeedConfig, SlotConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.config.flags import PushFlags, StageFlags
from paddlebox_tpu_torch.convert import params_from_jax
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.data.packer import BatchPacker
from paddlebox_tpu_torch.data.slot_record import SlotRecord
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.train import flagship
from paddlebox_tpu_torch.train.preload import run_preloaded_passes
from paddlebox_tpu_torch.train.trainer import BoxTrainer, run_scan_chunks

D = 8
NUM_SLOTS = 4
BATCH = 32
HIDDEN = (16, 8)
CAP = 1024
LR = 5e-3
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
INT_COLS = [acc.SLOT, acc.SHOW, acc.CLICK, acc.UNSEEN_DAYS, acc.MF_SIZE]
# 300 lines a pass: 10 batches of 32, so chunks of 4 leave a tail of 2
SMALL = dataclasses.replace(
    flagship.FLAGSHIP, num_slots=NUM_SLOTS, batch=BATCH, max_len=3,
    hidden=HIDDEN, capacity=CAP, num_files=2, lines_per_file=150,
    vocab_per_slot=60, data_seed=7)


def stagers():
    return [t for t in threading.enumerate() if t.name == "chunk-stager"]


# ------------------------------------------------------------ the driver

@pytest.mark.parametrize("exc", [RuntimeError, SystemExit])
@pytest.mark.parametrize("depth", [0, 1])
def test_staging_error_surfaces_at_the_caller(exc, depth):
    def bad_stack(group):
        raise exc("staging boom")

    with pytest.raises(exc, match="staging boom"):
        run_scan_chunks(lambda c, s: (c, None, None), list(range(8)), 4,
                        bad_stack, (), lambda *a: None,
                        prefetch_depth=depth)
    assert not stagers()


def test_consumer_error_stops_the_stager():
    """A consumer error (the nan guard) stops the producer before it has
    staged every chunk, and the driver joins it."""
    staged = []

    def slow_stack(group):
        staged.append(group)
        time.sleep(0.05)
        return group

    calls = []

    def scan_call(carry, stacked):
        calls.append(stacked)
        if len(calls) == 2:
            raise FloatingPointError("nan guard")
        return carry, np.zeros(4, np.float32), None

    with pytest.raises(FloatingPointError):
        run_scan_chunks(scan_call, list(range(64)), 4, slow_stack, (),
                        lambda *a: None, prefetch_depth=2)
    assert not stagers()
    assert len(staged) < 16


@pytest.mark.parametrize("depth,group", [(0, 1), (2, 3)])
def test_driver_consumes_full_chunks_in_order(depth, group):
    """Each full chunk reaches scan_call once, in order; losses come back
    in step order; the tail is left to the caller."""
    seen, drained = [], []

    def scan_call(carry, staged):
        seen.append(staged)
        return carry + 1, np.asarray(staged, np.float32), None

    def on_chunk(lo, grp, losses, preds):
        drained.append((lo, list(grp)))

    carry, losses, n = run_scan_chunks(
        scan_call, list(range(11)), 3, lambda g: [x * 2 for x in g], 0,
        on_chunk, prefetch_depth=depth, transfer_group=group,
        group_fn=(lambda hs: hs) if group > 1 else None)
    assert n == 9 and carry == 3
    assert drained == [(0, [0, 1, 2]), (3, [3, 4, 5]), (6, [6, 7, 8])]
    assert [float(x) for x in losses] == [2.0 * i for i in range(9)]
    assert run_scan_chunks(scan_call, [0], 1, list, 0, on_chunk)[2] == 0
    assert run_scan_chunks(scan_call, [5], 1, list, 0, on_chunk,
                           chunk1_ok=True)[2] == 1
    # a bounded iterator with n_items: exactly the full chunks are pulled,
    # and the caller's loop goes on from the same iterator
    it = iter(range(11))
    assert run_scan_chunks(scan_call, it, 3, list, 0, on_chunk,
                           n_items=11, prefetch_depth=depth)[2] == 9
    assert list(it) == [9, 10]


def test_stage_flags_and_trainer_config_validate():
    with pytest.raises(ValueError):
        StageFlags(chunk_prefetch_depth=-1)
    with pytest.raises(ValueError):
        StageFlags(h2d_stack_chunks=0)
    with pytest.raises(TypeError):
        StageFlags(stack_threads=2.0)
    cfg = TrainerConfig()
    assert (cfg.scan_chunk, cfg.sparse_chunk_sync, cfg.check_nan_inf) == (
        8, False, False)
    assert StageFlags() == StageFlags(4, 1, 1)
    table = TableConfig(embedx_dim=D, pass_capacity=CAP)
    feed = DataFeedConfig(slots=(SlotConfig("s0"),), batch_size=4)
    with pytest.raises(ValueError, match="scan_chunk"):
        BoxTrainer(DeepFM(ModelSpec(1, 3 + D), hidden=(4,)), table, feed,
                   TrainerConfig(scan_chunk=0), device="cpu")


# ----------------------------------------------------------- the port

@pytest.fixture(scope="module")
def small_files(tmp_path_factory):
    return flagship.write_files(str(tmp_path_factory.mktemp("chunks")),
                                SMALL)


def _state(trainer, out):
    k, v = trainer.table.store.state_items()
    order = np.argsort(k)
    return out, k[order], v[order], trainer.params


def _run(files, feed, passes=2, preloaded=False, plain_host=False,
         stage_flags=StageFlags(), **fields):
    t, ds = flagship.build_trainer(files, feed, SMALL, "scatter", "cpu",
                                   plain_host=plain_host,
                                   stage_flags=stage_flags, **fields)
    out = []
    if preloaded:
        dss = []
        for _ in range(passes):
            dss.append(BoxDataset(feed))
            dss[-1].set_filelist(files)

        def after(i, res):
            out.append((res["loss"], t.metrics.get_metric_msg("auc")["auc"],
                        res["batches"]))
        run_preloaded_passes(t, dss, after_pass=after)
    else:
        for _ in range(passes):
            res = t.train_pass(ds)
            out.append((res["loss"], t.metrics.get_metric_msg("auc")["auc"],
                        res["batches"]))
    t.close()
    return _state(t, out)


def _assert_bit_equal(got, want):
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2].view(np.uint32),
                                  want[2].view(np.uint32))
    for k in want[3]:
        np.testing.assert_array_equal(got[3][k].view(np.uint32),
                                      want[3][k].view(np.uint32), err_msg=k)


@pytest.fixture(scope="module")
def per_step(small_files):
    return _run(*small_files, scan_chunk=1)


@pytest.mark.parametrize("chunk,flags,preloaded", [
    (4, StageFlags(4, 0, 1), False),
    (4, StageFlags(4, 1, 1), False),
    (4, StageFlags(1, 2, 1), False),
    (4, StageFlags(4, 0, 2), False),
    (3, StageFlags(4, 2, 2), False),
    (4, StageFlags(), True),
], ids=["depth0", "depth1", "depth2-serial", "h2d2", "chunk3-depth2-h2d2",
        "preloaded"])
def test_chunk_path_bit_equal_to_per_step(small_files, per_step, chunk,
                                          flags, preloaded):
    got = _run(*small_files, preloaded=preloaded, stage_flags=flags,
               scan_chunk=chunk)
    assert got[0][0][2] == 10   # 10 batches: two chunks of 4 and a tail
    _assert_bit_equal(got, per_step)
    assert not stagers()


def test_chunk_sync_of_one_batch_equals_exact_mode(small_files, per_step):
    """Chunks of one batch through the chunk step: bit for bit the exact
    per-step pass (test_chunk1_bitexact_vs_exact)."""
    _assert_bit_equal(_run(*small_files, scan_chunk=1,
                           sparse_chunk_sync=True), per_step)


def _disjoint_batches(feed):
    """4 batches whose keys share nothing (test_disjoint_key_chunks_
    bitexact's construction)."""
    rng = np.random.RandomState(0)
    packer = BatchPacker(feed)
    out = []
    for b in range(4):
        recs = []
        for _ in range(feed.batch_size):
            slots = {si: (rng.randint(0, 40, rng.randint(1, 4))
                          .astype(np.uint64) + np.uint64(1000 * b + 1))
                     for si in range(NUM_SLOTS)}
            recs.append(SlotRecord(label=int(rng.rand() < 0.3),
                                   uint64_slots=slots))
        out.append(packer.pack(recs))
    return out


@pytest.mark.parametrize("push_write", ["scatter", "blocked"])
def test_disjoint_key_chunks_bit_equal_to_exact(small_files, push_write):
    """Batches of a chunk that share no key: the chunk-synchronous step
    (one pull, one merged push) equals the exact chunk step bit for bit.
    mf_initial_range 0, so the creation draws (one seed a step against one
    a chunk) are zero in both."""
    _, feed = small_files
    batches = _disjoint_batches(feed)

    def run(sync):
        table = TableConfig(embedx_dim=D, pass_capacity=CAP,
                            optimizer=SparseOptimizerConfig(
                                mf_create_thresholds=0.0,
                                mf_initial_range=0.0))
        model = DeepFM(ModelSpec(num_slots=NUM_SLOTS, slot_dim=3 + D),
                       hidden=HIDDEN,
                       generator=torch.Generator().manual_seed(5))
        tr = BoxTrainer(model, table, feed,
                        TrainerConfig(dense_lr=LR, scan_chunk=4,
                                      sparse_chunk_sync=sync),
                        seed=5, flags=PushFlags(push_write, 64),
                        device="cpu")
        tr.table.begin_feed_pass()
        for b in batches:
            tr.table.add_keys(b.keys[b.valid])
        tr.table.end_feed_pass()
        tr.table.begin_pass()
        dc = tr._group_to_device([tr._stack_batches_host(batches)])[0]
        if sync:
            losses, preds = tr.chunk_fn(tr.table.slab, dc.stacked, dc.cpush,
                                        9)
        else:
            losses, preds = tr.scan_steps(tr.table.slab, dc.stacked,
                                          [9, 10, 11, 12])
        tr.close()
        return (tr.table.slab.numpy().copy(), tr.params, losses.numpy(),
                preds.numpy())

    slab_e, params_e, losses_e, preds_e = run(False)
    slab_c, params_c, losses_c, preds_c = run(True)
    np.testing.assert_array_equal(losses_e, losses_c)
    np.testing.assert_array_equal(preds_e, preds_c)
    np.testing.assert_array_equal(slab_e.view(np.uint32),
                                  slab_c.view(np.uint32))
    for k in params_e:
        np.testing.assert_array_equal(params_e[k], params_c[k], err_msg=k)


@pytest.mark.parametrize("plain_host", [False, True],
                         ids=["native", "plain"])
@pytest.mark.parametrize("sync", [False, True], ids=["exact", "sync"])
def test_threaded_staging_matches_serial(small_files, plain_host, sync):
    """The stack_threads pool stages a chunk exactly as the calling thread
    does (an order-preserving map; lookups and dedups only read the pass
    index), on both host tiers and in both chunk modes; a new StageFlags
    takes effect on the same trainer."""
    files, feed = small_files
    t, ds = flagship.build_trainer(files, feed, SMALL, "scatter", "cpu",
                                   plain_host=plain_host,
                                   sparse_chunk_sync=sync)
    t.table.begin_feed_pass()
    ds.load_into_memory(add_keys_fn=t.table.add_keys)
    t.table.end_feed_pass()
    t.table.begin_pass()
    group = ds.split_batches(1)[0][:6]
    staged = {}
    for n in (4, 1):
        t.stage_flags = StageFlags(stack_threads=n)
        staged[n] = t._group_to_device([t._stack_batches_host(group)])[0]
        assert (t._stage_pool[1] is None) == (n == 1)
    for part in ("stacked", "cpush"):
        a, b = getattr(staged[4], part), getattr(staged[1], part)
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], torch.Tensor):
                assert a[k].shape[0] == (6 if part == "stacked"
                                         else a[k].shape[0])
                assert torch.equal(a[k], b[k]), (part, k)
            else:
                assert a[k] == b[k], (part, k)
    want = {"ids", "segments", "ins_valid", "labels", "n_valid"}
    if not sync:
        want |= {"uids", "perm", "offsets", "n_uniq"}
    assert set(staged[4].stacked) == want
    assert set(staged[4].cpush) == (
        {"uids", "perm", "offsets", "n_uniq"} if sync else set())
    t.table.end_pass()
    t.close()


@pytest.mark.parametrize("chunk", [4, 1])
def test_check_nan_inf_raises(small_files, chunk):
    """A non-finite loss raises FloatingPointError at the caller, from the
    chunk driver's drain or from a tail step, and stops the stager."""
    files, feed = small_files
    t, ds = flagship.build_trainer(files, feed, SMALL, "scatter", "cpu",
                                   scan_chunk=chunk, check_nan_inf=True)
    with torch.no_grad():
        next(t.model.parameters()).fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="nan/inf loss"):
        t.train_pass(ds)
    assert not stagers()
    t.close()


# ------------------------------------------------------- against the JAX

@pytest.fixture(scope="module")
def jdata(tmp_path_factory):
    out = tmp_path_factory.mktemp("chunks_jax")
    files, feed = write_synthetic_ctr_files(
        str(out), num_files=2, lines_per_file=96, num_slots=NUM_SLOTS,
        vocab_per_slot=60, max_len=3, seed=7)
    jfeed = type(feed)(slots=feed.slots, batch_size=BATCH)
    pfeed = DataFeedConfig(
        slots=tuple(SlotConfig(s.name, s.type, s.is_used, s.max_len)
                    for s in feed.slots), batch_size=BATCH)
    return files, jfeed, pfeed


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX trainer with use_pallas_push, its kernel interpreted on the
    CPU (as tests/test_torch_train.py wires it)."""
    import paddlebox_tpu.embedding.pallas_push as pp
    jflags.set_flag("use_pallas_push", True)
    monkeypatch.setattr(pp, "pallas_apply_push",
                        functools.partial(pp.pallas_apply_push,
                                          interpret=True))
    yield
    jflags.set_flag("use_pallas_push", False)


def _jax_seeds(key, n):
    """(the seeds of a train_pass that splits its key n times, next table
    key): next_prng, then one split a step (a chunk under chunk sync)."""
    key, prng = jax.random.split(key)
    seeds = []
    for _ in range(n):
        prng, sub = jax.random.split(prng)
        seeds.append(int(jax.random.randint(sub, (), 0,
                                            jnp.int32(2**31 - 1))))
    return seeds, key


@pytest.mark.parametrize("sync", [False, True], ids=["exact", "sync"])
def test_chunks_match_jax(jdata, pallas_interpret, sync):
    """Two passes of 6 batches at scan_chunk=4 (one chunk and a tail of
    2) in the port and the JAX trainer, from the same weights, data and
    seeds."""
    files, jfeed, pfeed = jdata
    table = dict(embedx_dim=D, pass_capacity=CAP)
    jt = JTrainer(JDeepFM(JSpec(num_slots=NUM_SLOTS, slot_dim=3 + D),
                          hidden=HIDDEN),
                  JTable(optimizer=JSparse(**OPT), **table), jfeed,
                  JTrainerCfg(dense_lr=LR, scan_chunk=4,
                              sparse_chunk_sync=sync), seed=0)
    model = DeepFM(ModelSpec(num_slots=NUM_SLOTS, slot_dim=3 + D),
                   hidden=HIDDEN)
    model.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in jt.params.items()}))
    pt = BoxTrainer(model, TableConfig(optimizer=SparseOptimizerConfig(
        **OPT), **table), pfeed,
        TrainerConfig(dense_lr=LR, scan_chunk=4, sparse_chunk_sync=sync),
        seed=0, device="cpu")
    jds = JDataset(jfeed, read_threads=1, columnar=False)
    pds = BoxDataset(pfeed)
    for t, ds in ((jt, jds), (pt, pds)):
        t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
        ds.set_filelist(files)
    draws = 3 if sync else 6   # a chunk and 2 tail steps, or 6 steps
    key = jax.random.PRNGKey(0)
    got, want = [], []
    for _ in range(2):
        seeds, key = _jax_seeds(key, draws)
        pt.seed_fn = iter(seeds).__next__
        for t, ds, out in ((jt, jds, want), (pt, pds, got)):
            res = t.train_pass(ds)
            assert res["batches"] == 6
            out.append((res["loss"],
                        t.metrics.get_metric_msg("auc")["auc"]))
    for (gl, ga), (wl, wa) in zip(got, want):
        np.testing.assert_allclose(gl, wl, rtol=1e-4)
        assert abs(ga - wa) <= 1e-4, (ga, wa)
    keys = pt.table.pass_keys
    p_rows = pt.table.store.lookup(keys)
    j_rows = jt.table.store.lookup(keys)
    np.testing.assert_array_equal(p_rows[:, INT_COLS], j_rows[:, INT_COLS])
    np.testing.assert_allclose(p_rows, j_rows, rtol=1e-4, atol=1e-7)
    pt.close()
    jt.close()


# -------------------------------------------------------------- the card

@pytest.mark.cuda
@pytest.mark.parametrize("sync", [False, True], ids=["exact", "sync"])
def test_cuda_pinned_staging_matches_pageable(small_files, sync):
    """On the card: two chunks staged through the pinned ring as one group
    (one copy a leaf on the copy stream) are bit-equal to the host arrays
    they were staged from, and a chunked pass (pinned copies) equals the
    per-step pass (pageable copies) bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: pinned memory and copy streams "
                    "have no CPU mode; chip_smoke.py runs the chunk path "
                    "on the card")
    files, feed = small_files
    t, ds = flagship.build_trainer(files, feed, SMALL, "scatter", "cuda",
                                   sparse_chunk_sync=sync,
                                   stage_flags=StageFlags(4, 1, 2))
    t.table.begin_feed_pass()
    ds.load_into_memory(add_keys_fn=t.table.add_keys)
    t.table.end_feed_pass()
    t.table.begin_pass()
    groups = [ds.split_batches(1)[0][i:i + 4] for i in (0, 4)]
    hosts = [t._stack_batches_host(g) for g in groups]
    devs = t._group_to_device(hosts)
    assert devs[0].ready is devs[1].ready   # one copy a leaf for both
    torch.cuda.current_stream().wait_event(devs[0].ready)
    for host, dev in zip(hosts, devs):
        for part in ("stacked", "cpush"):
            for k, v in getattr(dev, part).items():
                if not isinstance(v, torch.Tensor):
                    continue
                ref = (host.cpush[k] if part == "cpush" else
                       np.stack([b[k] for b in host.batches]))
                assert torch.equal(v.cpu(), torch.from_numpy(ref)), k
        dev.release()
    t.table.end_pass()
    t.close()
    if not sync:
        _assert_bit_equal(_state_on_card(files, feed, 4),
                          _state_on_card(files, feed, 1))


def _state_on_card(files, feed, chunk):
    t, ds = flagship.build_trainer(files, feed, SMALL, "scatter", "cuda",
                                   scan_chunk=chunk)
    out = []
    for _ in range(2):
        res = t.train_pass(ds)
        out.append((res["loss"], t.metrics.get_metric_msg("auc")["auc"],
                    res["batches"]))
    t.close()
    return _state(t, out)
