"""The port's sharded trainer and table against the JAX package's.

Routing in process: ShardedPassTable.bucketize (the native router and its
numpy twin) gives the reference's native router's buckets, restore and
overflow bit for bit at P = 2, 4 and 8, and stage_push_dedup its
destination's sorted dedup. The slice end to end: the port runs P gloo
ranks, each spawned by the test (torch.multiprocessing, spawn; each rank
one thread, a process group timeout and a wall limit here) and loading
the files the reference's worker r trains on, against the JAX
ShardedBoxTrainer on a P-device mesh of virtual CPU devices
(tests/conftest.py) with use_pallas_push, its kernel interpreted, and
dataset_disable_shuffle; every rank replays its shard's push seeds.
Tolerances:

  * each pass's loss rtol 1e-4; the cluster AUC (the metric allreduce)
    1e-4 absolute;
  * every shard's store: the integer columns (slot, show, click, the
    unseen days, mf_size) bit-equal, the float columns rtol 1e-4 / atol
    1e-6; the dense parameters rtol 1e-4 / atol 1e-6 (float32 reductions
    and matmuls in another order by XLA and ATen, and the dense grads'
    sum over 4 ranks in gloo's order);
  * across the port's ranks the losses and dense parameters are
    bit-identical, and scan_chunk=4 gives scan_chunk=1's run bit for bit;
  * CtrDnn with data_norm at P = 2 (the ranks average their summaries)
    to the same tolerances, its summaries among the dense parameters;
    DeepFM on the bf16 slab at P = 2 to the same tolerances, its 2-byte
    weight columns within one bf16 step (2^-7 relative);
  * predict_batches at P = 2: rtol 1e-5.

A world of one in process (gloo): the sharded trainer equals the
single-device BoxTrainer bit for bit, as the card's world-1 run is held to
the main path. The reference's imports stay inside the functions that
build the oracle, so the spawned ranks load torch and the port only.
"""

import dataclasses

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch.config.configs import TrainerConfig
from paddlebox_tpu_torch.config.flags import PushFlags, ShardFlags
from paddlebox_tpu_torch.embedding.pass_table import segment_offsets
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.parallel.sharded_table import (ShardedPassTable,
                                                        bucketize_plain,
                                                        stage_push_dedup)
from paddlebox_tpu_torch.parallel.sharded_trainer import ShardedBoxTrainer
from paddlebox_tpu_torch.train import factory
from paddlebox_tpu_torch.train.trainer import BoxTrainer
from paddlebox_tpu_torch.utils.stats import stat_get
from sharded_cluster import (D, HIDDEN, LR, NUM_SLOTS, assert_bits,
                             assert_store, flat_leaves, jax_reference,
                             jax_shard_seeds, jax_table_cfg, port_dataset,
                             run_cluster, table_cfg, use_jax_pallas,
                             world_one, worker_order, write_data)

# the routing tests' shard capacity and bucket width (no overflow)
ROUTE_SHARD_CAP = 4096
KB = 4096


# ------------------------------------------------------------------ setup

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_data(tmp_path_factory.mktemp("torch_sharded_data"))


@pytest.fixture
def jax_pallas(monkeypatch):
    use_jax_pallas(monkeypatch)


@pytest.mark.parametrize("P", [2, 4])
def test_cluster_matches_the_jax_sharded_trainer(P, data, jax_pallas,
                                                 tmp_path):
    files, pfeed = data
    refs = {"deepfm": jax_reference(files, pfeed, P, predict=(P == 2))}
    runs = [{"predict": P == 2}]
    if P == 2:
        # chunks of 4; CtrDnn, whose data_norm summaries the ranks average;
        # DeepFM on the bf16 slab
        runs += [{"cfg": {"scan_chunk": 4}}, {"model": "ctr_dnn"},
                 {"model": "bf16", "slab": "bfloat16"}]
        refs["ctr_dnn"] = jax_reference(files, pfeed, P,
                                        model_name="ctr_dnn")
        refs["bf16"] = jax_reference(files, pfeed, P, slab="bfloat16")
    ref = refs["deepfm"]
    n_steps = sum(p[2] for p in ref["passes"])
    seeds = jax_shard_seeds(0, n_steps, P)
    spec = {"feed": pfeed, "files": worker_order(files, P),
            "params0": {m: r["params0"] for m, r in refs.items()},
            "runs": runs, "seeds": {m: seeds for m in refs}}
    got = run_cluster(P, spec, tmp_path)
    steps = ref["passes"][0][2]
    for r, ranks in enumerate(got):
        for run, res in zip(runs, ranks):
            want = refs[run.get("model", "deepfm")]
            for (gl, ga, gb), (wl, wa, wb) in zip(res["passes"],
                                                  want["passes"]):
                assert gb == wb
                np.testing.assert_allclose(gl, wl, rtol=1e-4)
                assert abs(ga - wa) <= 1e-4, (ga, wa)
            assert res["slab_dtype"] == ("torch.int16" if "slab" in run
                                         else "torch.float32")
            assert_store(res["store"], want["stores"][r],
                         run.get("slab", "float32"))
            gp = flat_leaves(res["params"])
            wp = flat_leaves(want["params"])
            assert set(gp) == set(wp)
            for k, v in wp.items():
                np.testing.assert_allclose(gp[k], v, rtol=1e-4, atol=1e-6,
                                           err_msg=k)
        res = ranks[0]
        # three device collectives a step, one host exchange a step
        c = res["collectives"]
        assert (c["a2a_pull"], c["a2a_push"], c["all_reduce"]) == (
            2 * steps, 2 * steps, 2 * steps), c
        assert res["exchanges"] == 2 * steps
    # replicated: the ranks' losses and dense parameters bit-identical
    for i in range(len(runs)):
        first = flat_leaves(got[0][i]["params"])
        for ranks in got[1:]:
            assert [p[0] for p in ranks[i]["passes"]] == [
                p[0] for p in got[0][i]["passes"]]
            for k, v in flat_leaves(ranks[i]["params"]).items():
                assert_bits(v, first[k])
    if P == 2:
        # chunks of 4 = one step at a time, bit for bit
        for ranks in got:
            a, b = ranks[0], ranks[1]
            assert a["passes"] == b["passes"]
            np.testing.assert_array_equal(a["store"][0], b["store"][0])
            assert_bits(a["store"][1], b["store"][1])
            for k, v in flat_leaves(a["params"]).items():
                assert_bits(flat_leaves(b["params"])[k], v)
        # predict_batches: the reference's preds run step by step over the
        # workers; the ranks' own runs interleaved the same way
        wp, wl = ref["predict"]
        gp, gl = [], []
        pos = [0] * P
        for i in range(len(got[0][0]["predict"][2])):
            for r in range(P):
                preds, labels, counts = got[r][0]["predict"]
                n = counts[i]
                gp.append(preds[pos[r]:pos[r] + n])
                gl.append(labels[pos[r]:pos[r] + n])
                pos[r] += n
        np.testing.assert_array_equal(np.concatenate(gl), wl)
        np.testing.assert_allclose(np.concatenate(gp), wp, rtol=1e-5)


# ---------------------------------------------------------------- routing

def jax_table(P, bucket_cap, keys):
    from paddlebox_tpu.parallel.sharded_table import ShardedPassTable as JT
    t = JT(jax_table_cfg(cap=P * ROUTE_SHARD_CAP), num_shards=P,
           bucket_cap=bucket_cap)
    t.begin_feed_pass()
    t.add_keys(keys)
    t.end_feed_pass()
    return t


def port_table(P, bucket_cap, keys, rank=0, strict=False):
    t = ShardedPassTable(
        dataclasses.replace(table_cfg(), pass_capacity=P * ROUTE_SHARD_CAP), P,
        bucket_cap, owned_shards=[rank], device="cpu",
        shard_flags=ShardFlags(strict_bucket_overflow=strict))
    t.begin_feed_pass()
    t.add_keys(keys)
    t.end_feed_pass()
    return t


def jax_native_bucketize(jt, keys, valid):
    from paddlebox_tpu.parallel import sharded_table as jst
    assert jst._route_lib() is not None, "the reference's native router"
    return jt.bucketize(keys, valid)


def batch_keys(seed, n=4096, vocab=1 << 20):
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, vocab, n).astype(np.uint64)
    keys[rng.randint(0, n, n // 4)] = keys[rng.randint(0, n, n // 4)]
    valid = np.ones(n, bool)
    valid[-n // 8:] = False            # a padding tail
    valid[rng.randint(0, n, 64)] = False
    return keys, valid


def assert_same_route(got, gvalid, want, wvalid):
    np.testing.assert_array_equal(got.buckets, want.buckets)
    np.testing.assert_array_equal(got.restore, want.restore)
    assert got.overflow == want.overflow
    np.testing.assert_array_equal(gvalid, wvalid)


@pytest.mark.parametrize("plain", [False, True], ids=["native", "plain"])
@pytest.mark.parametrize("P", [2, 4, 8])
def test_bucketize_matches_the_reference_router(P, plain):
    keys, valid = batch_keys(P)
    jt = jax_table(P, KB, keys)
    wv = valid.copy()
    want = jax_native_bucketize(jt, keys, wv)
    for rank in (0, P - 1):
        t = port_table(P, KB, keys, rank)
        gv = valid.copy()
        got = t.bucketize(keys, gv, plain=plain)
        assert want.overflow == 0
        assert_same_route(got, gv, want, wv)
    # the reference's numpy fallback numbers slots by key order: the same
    # local id and shard for every occurrence
    from paddlebox_tpu.parallel import sharded_table as jst
    orig = jst._route_lib
    jst._route_lib = lambda: None
    try:
        fv = valid.copy()
        fb = jt.bucketize(keys, fv)
    finally:
        jst._route_lib = orig
    np.testing.assert_array_equal(fv, gv)
    live = gv
    np.testing.assert_array_equal(
        got.buckets.reshape(-1)[got.restore][live],
        fb.buckets.reshape(-1)[fb.restore][live])
    np.testing.assert_array_equal(got.restore[live] // KB,
                                  fb.restore[live] // KB)


@pytest.mark.parametrize("plain", [False, True], ids=["native", "plain"])
@pytest.mark.parametrize("P", [2, 4, 8])
def test_bucketize_overflow_matches_and_is_loud(P, plain):
    """Buckets of 8 slots overflow: the same late first occurrences drop,
    with every occurrence, counted; strict_bucket_overflow raises."""
    from paddlebox_tpu.config import flags as jflags
    keys, valid = batch_keys(10 + P, n=512, vocab=400)
    jt = jax_table(P, 8, keys)
    wv = valid.copy()
    want = jax_native_bucketize(jt, keys, wv)
    assert want.overflow > 0
    t = port_table(P, 8, keys)
    before = stat_get("sharded_bucket_overflow")
    gv = valid.copy()
    got = t.bucketize(keys, gv, plain=plain)
    assert_same_route(got, gv, want, wv)
    assert stat_get("sharded_bucket_overflow") == before + want.overflow
    assert t._overflow_warned
    strict = port_table(P, 8, keys, strict=True)
    with pytest.raises(RuntimeError, match="gradients"):
        strict.bucketize(keys, valid.copy(), plain=plain)
    jflags.set_flag("strict_bucket_overflow", True)
    with pytest.raises(RuntimeError, match="gradients"):
        jt.bucketize(keys, valid.copy())


@pytest.mark.parametrize("plain", [False, True], ids=["native", "plain"])
@pytest.mark.parametrize("P", [2, 4, 8])
def test_bucketize_sentinel_and_unregistered_keys(P, plain):
    kmax = np.uint64(0xFFFFFFFFFFFFFFFF)
    keys = np.array([8, kmax, 9, kmax, 3 * P], np.uint64)
    jt = jax_table(P, 16, keys)
    t = port_table(P, 16, keys)
    wv, gv = np.ones(5, bool), np.ones(5, bool)
    want = jax_native_bucketize(jt, keys, wv)
    got = t.bucketize(keys, gv, plain=plain)
    assert_same_route(got, gv, want, wv)
    s = int(t.policy.shard_of(np.array([kmax], np.uint64))[0])
    assert t.shard_keys(s)[got.buckets.reshape(-1)[got.restore[1]]] == kmax
    bad = np.array([8, 987651], np.uint64)
    with pytest.raises(KeyError, match="987651"):
        jax_native_bucketize(jt, bad, np.ones(2, bool))
    with pytest.raises(KeyError, match="987651"):
        t.bucketize(bad, np.ones(2, bool), plain=plain)


def test_plain_twin_routes_by_any_shard_array():
    """The twin takes the owner array a policy computes (the sharded
    native router's input): equal to rt_bucketize_sharded."""
    from paddlebox_tpu_torch.native import host_lib
    keys, valid = batch_keys(3, n=2048)
    t = port_table(4, 256, keys)
    shard = ((keys // np.uint64(7)) % np.uint64(4)).astype(np.int64)
    shard_keys = [np.unique(keys[shard == s]) for s in range(4)]
    handle = host_lib.create_route_index(shard_keys)
    try:
        nv, pv = valid.copy(), valid.copy()
        native = host_lib.bucketize(handle, keys, nv, 4, 256, t.shard_cap - 1,
                                    shard)
        plain = bucketize_plain(shard_keys, keys, pv, 256, t.shard_cap - 1,
                                shard)
    finally:
        host_lib.destroy_route_index(handle)
    np.testing.assert_array_equal(native[0], plain.buckets)
    np.testing.assert_array_equal(native[1], plain.restore)
    assert native[2] == plain.overflow
    np.testing.assert_array_equal(nv, pv)
    with pytest.raises(ValueError, match="out of range"):
        bucketize_plain(shard_keys, keys, valid.copy(), 256, 0, shard + 4)


@pytest.mark.parametrize("P", [2, 4])
def test_stage_push_dedup_matches_the_reference(P):
    from concurrent.futures import ThreadPoolExecutor
    from paddlebox_tpu.parallel.sharded_table import \
        stage_push_dedup as jstage
    batches = [batch_keys(100 + w, n=1024, vocab=5000) for w in range(P)]
    allk = np.concatenate([k for k, _ in batches])
    jt = jax_table(P, 512, allk)
    buckets = [jt.bucketize(k, v.copy()).buckets for k, v in batches]
    with ThreadPoolExecutor(2) as pool:
        want = jstage(buckets, list(range(P)), P, jt.shard_cap, False, None,
                      rebuild=False, pool=pool, sort_uids=True)
    for d in range(P):
        inc = np.stack([buckets[s][d] for s in range(P)])
        touched = []
        got = stage_push_dedup({d: inc}, jt.shard_cap,
                               note_touched=lambda dd, u: touched.append(
                                   (dd, u)))
        for k in ("push_uids", "push_perm", "push_inv"):
            np.testing.assert_array_equal(got[k][0], want[k][d], err_msg=k)
        n_valid = int((inc != jt.shard_cap - 1).sum())
        np.testing.assert_array_equal(
            got["push_offsets"][0], segment_offsets(want["push_inv"][d],
                                                    n_valid))
        assert got["n_uniq"][0] == int((want["push_uids"][d]
                                        < jt.shard_cap).sum())
        assert touched[0][0] == d


def test_feed_pass_unions_and_splits_by_key_mod():
    keys = np.array([1, 2, 3, 5, 8, 13, 21, 34], np.uint64)
    t = port_table(4, 16, keys[:4], rank=2)
    t.begin_feed_pass()
    t.add_keys(keys[:3])
    t.end_feed_pass(allgather=lambda local: [local, keys[3:]])
    for s in range(4):
        np.testing.assert_array_equal(t.shard_keys(s),
                                      keys[keys % np.uint64(4) == s])
    np.testing.assert_array_equal(t.shard.pass_keys, t.shard_keys(2))
    assert t.pass_size == keys.size
    t.begin_feed_pass()
    t.add_keys(np.arange(0, 4 * ROUTE_SHARD_CAP, dtype=np.uint64))
    with pytest.raises(RuntimeError, match="shard capacity"):
        t.end_feed_pass()


# ------------------------------------------------------ world one, refusals

def test_world_one_equals_the_single_device_trainer(data):
    """At world 1 (gloo in process) the sharded trainer gives BoxTrainer's
    two passes bit for bit: losses, AUC, the store and the dense
    parameters; every collective was called."""
    files, pfeed = data
    from paddlebox_tpu_torch.models.deepfm import DeepFM as PD
    torch.manual_seed(3)
    base = PD(ModelSpec(num_slots=NUM_SLOTS, slot_dim=3 + D), hidden=HIDDEN)
    state = {k: v.clone() for k, v in base.state_dict().items()}

    def model():
        m = PD(ModelSpec(num_slots=NUM_SLOTS, slot_dim=3 + D), hidden=HIDDEN)
        m.load_state_dict(state)
        return m

    cfg = TrainerConfig(dense_lr=LR, scan_chunk=4)
    single = BoxTrainer(model(), table_cfg(), pfeed, cfg, seed=0,
                        flags=PushFlags("scatter"), device="cpu")
    seeds = [int(x) for x in np.random.RandomState(1).randint(0, 2**31 - 1,
                                                              64)]
    fl = world_one()
    try:
        sharded = factory.create_trainer(
            "ShardedBoxTrainer", model(), table_cfg(), pfeed, cfg, seed=0,
            fleet=fl, device="cpu")
        assert isinstance(sharded, ShardedBoxTrainer)
        assert sharded.bucket_cap == 2 * pfeed.key_capacity()
        out = {}
        for name, t in (("single", single), ("sharded", sharded)):
            t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
            t.seed_fn = iter(seeds).__next__
            res = []
            for _ in range(2):
                ds = port_dataset(pfeed, files)
                ds.set_filelist(files[:4])
                r = t.train_pass(ds)
                res.append((r["loss"], t.metrics.get_metric_msg("auc")["auc"]))
            store = (t.table.stores[0] if name == "sharded"
                     else t.table.store)
            k, v = store.state_items()
            o = np.argsort(k)
            out[name] = (res, k[o], v[o], t.params)
        assert out["sharded"][0] == out["single"][0]
        np.testing.assert_array_equal(out["sharded"][1], out["single"][1])
        assert_bits(out["sharded"][2], out["single"][2])
        for k, v in out["single"][3].items():
            assert_bits(out["sharded"][3][k], v)
        steps = 2 * 16
        c = sharded.collective_counts
        assert (c["a2a_pull"], c["a2a_push"], c["all_reduce"]) == (
            steps, steps, steps)
        # a test pass: no creation, the main task's preds
        ds = port_dataset(pfeed, files)
        ds.set_filelist(files[4:5])
        before = len(sharded.table.stores[0].state_items()[0])
        preds, labels = sharded.predict_batches(ds)
        sp, sl = single.predict_batches(ds)
        assert_bits(preds, sp)
        np.testing.assert_array_equal(labels, sl)
        assert len(sharded.table.stores[0].state_items()[0]) == before
    finally:
        single.close()
        fl.stop()


@pytest.mark.parametrize("cfg", [TrainerConfig(sparse_chunk_sync=True),
                                 TrainerConfig(sync_mode="async"),
                                 TrainerConfig(async_mode=True)],
                         ids=["chunk_sync", "async", "async_mode"])
def test_chunk_sync_and_async_raise_as_the_reference(cfg, data):
    _, pfeed = data
    model = DeepFM(ModelSpec(num_slots=NUM_SLOTS, slot_dim=3 + D),
                   hidden=HIDDEN)
    with pytest.raises(ValueError, match="single-host"):
        ShardedBoxTrainer(model, table_cfg(), pfeed, cfg, device="cpu")

