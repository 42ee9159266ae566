"""The push write modes rebuild and auto and the lean wires against the JAX
package.

  * the wire products: dedup_uids_sorted (native tier against numpy, where
    it engages and where it declines), delta_encode_uids and
    decode_delta_uids (round trip, the int16 refusal), pos_for_rebuild,
    each against the reference's function;
  * the device derivation of perm and offsets (device_push_maps) equal to
    the host's dedup_ids and segment_offsets, at the flagship batch's
    131,072 key slots and at a chunk of 8 such batches;
  * the delta wire on a batch with no padding: the decoded trash id, which
    no occurrence names, leaves the slab as the full wire does, under every
    write;
  * resolve_push_write against the reference's on the CPU, the card's
    'auto' rule, the ids-only wire's refusals;
  * two passes of a narrow DeepFM under each mode of chip_smoke.py's phase
    18, bit-identical to the port's full-wire scatter run (losses, AUC,
    slab after each pass, store) and held to the JAX trainer in the same
    mode (use_pallas_push, its kernel interpreted) at the tolerances of
    tests/test_torch_train.py: loss rtol 1e-4, AUC 1e-4, the store's
    integer columns exact and the rest rtol 1e-4;
  * on the card (cuda mark): the rebuild write's gather and the uid wire's
    push against their plain versions.
"""

import functools

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
from paddlebox_tpu.embedding import optimizers as jopt
from paddlebox_tpu.embedding import pass_table as jpt
from paddlebox_tpu.models.base import ModelSpec as JSpec
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.train import trainer as jtrainer
from paddlebox_tpu.train.trainer import BoxTrainer as JTrainer

from paddlebox_tpu_torch.config import flags as pflags
from paddlebox_tpu_torch.config.configs import (DataFeedConfig, SlotConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.config.flags import PushFlags, StageFlags
from paddlebox_tpu_torch.convert import params_from_jax
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.embedding import optimizers as popt
from paddlebox_tpu_torch.embedding import pass_table as ppt
from paddlebox_tpu_torch.embedding.accessor import PushLayout, ValueLayout
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.native import host_lib
from paddlebox_tpu_torch.ops import row_kernels as rk
from paddlebox_tpu_torch.train.trainer import BoxTrainer

D = 8
NUM_SLOTS = 4
BATCH = 32
HIDDEN = (16, 8)
CAP = 1024
LR = 5e-3
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
INT_COLS = [acc.SLOT, acc.SHOW, acc.CLICK, acc.UNSEEN_DAYS, acc.MF_SIZE]

# chip_smoke.py's phase 18 modes: (push_write, StageFlags wire fields,
# the wire they name)
MODES = {
    "full_rebuild": ("rebuild", {}, "full"),
    "uid_scatter": ("scatter", {"h2d_lean": True}, "uid"),
    "uid_rebuild": ("rebuild", {"h2d_lean": True}, "uid"),
    "uid_blocked": ("blocked", {"h2d_lean": True}, "uid"),
    "delta_scatter": ("scatter", {"h2d_lean": True,
                                  "wire_delta_ids": True}, "delta"),
    "ids_only": ("scatter", {"h2d_lean": True, "h2d_uid_wire": False},
                 "ids_only"),
    "auto": ("auto", {}, "full"),
}


# ----------------------------------------------------------- wire products

def _ids(K, n_valid, span, cap, seed):
    """K key slots: n_valid real ids below ``span``, then the padding
    tail on the trash row cap - 1."""
    rng = np.random.RandomState(seed)
    ids = np.full(K, cap - 1, np.int32)
    ids[:n_valid] = rng.randint(0, span, n_valid)
    return ids


# (K, n_valid, live id span, pad_base): engaging shapes (heavy
# duplication, the trash id on top) and declining ones (a span above
# K / 2, no padding and a wide span)
DEDUP_SHAPES = [(1024, 700, 64, 1 << 20), (2048, 2048, 400, 1 << 16),
                (4096, 3000, 2000, 1 << 13), (1024, 1024, 900, 1 << 12),
                (1024, 600, 900, 1 << 20), (64, 64, 1, 1 << 8),
                (128, 0, 1, 1 << 12)]


@pytest.mark.parametrize("K,n_valid,span,cap", DEDUP_SHAPES)
def test_dedup_uids_sorted_native_matches_numpy_and_jax(K, n_valid, span,
                                                        cap):
    ids = _ids(K, n_valid, span, cap, seed=K + span)
    got = ppt.dedup_uids_sorted(ids, cap)
    uniq = np.unique(ids)
    want = np.concatenate([uniq, cap + np.arange(K - uniq.size)])
    np.testing.assert_array_equal(got, want.astype(np.int32))
    np.testing.assert_array_equal(got, jpt.dedup_uids_sorted(ids, cap))
    # the native tier alone: engaged it gives the same array, declined
    # (-1) it gives None
    span_live = (np.unique(ids[ids != cap - 1]).max(initial=-1) + 1
                 if (ids == cap - 1).any() else ids.max() + 1)
    native = host_lib.dedup_sorted(ids, cap)
    if 2 * span_live <= K:
        np.testing.assert_array_equal(native, want)
    else:
        assert native is None


def test_dedup_uids_sorted_declines_out_of_range_ids():
    ids = np.array([0, 1, 1, 9], np.int32)
    assert host_lib.dedup_sorted(ids, 8) is None
    with pytest.raises(ValueError, match="nonnegative"):
        ppt.dedup_uids_sorted(np.array([0, -1], np.int32), 8)


@pytest.mark.parametrize("padded", [True, False], ids=["padded", "no_pad"])
def test_delta_wire_round_trip_matches_jax(padded):
    cap = 1 << 14
    ids = _ids(512, 400 if padded else 512, 3000, cap, seed=3)
    uids = ppt.dedup_uids_sorted(ids, cap)
    got = ppt.delta_encode_uids(uids, cap)
    want = jpt.delta_encode_uids(uids, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert np.asarray(g).dtype == np.asarray(w).dtype
    base, d16, cut = got
    dec = popt.decode_delta_uids(int(base), torch.from_numpy(d16), int(cut),
                                 cap).numpy()
    np.testing.assert_array_equal(dec, np.asarray(jopt.decode_delta_uids(
        jnp.int32(base), jnp.asarray(d16), jnp.int32(cut), cap)))
    n = ppt.uniq_count(uids, cap)
    np.testing.assert_array_equal(dec[:n], uids[:n])
    # with no padding the decoded tail starts at the trash id, which n
    # leaves out; with padding it is the uid vector's tail
    assert dec[n] == (cap if padded else cap - 1)


def test_delta_wire_refuses_a_gap_above_int16():
    cap = 1 << 20
    uids = ppt.dedup_uids_sorted(np.array([5, 40000, cap - 1], np.int32),
                                 cap)
    for mod in (ppt, jpt):
        with pytest.raises(ValueError, match="exceeds int16"):
            mod.delta_encode_uids(uids, cap)


def test_pos_for_rebuild_matches_jax():
    cap = 4096
    uids = ppt.dedup_uids_sorted(_ids(900, 700, 2000, cap, seed=4), cap)
    pos = ppt.pos_for_rebuild(uids, cap)
    np.testing.assert_array_equal(pos, jpt.pos_for_rebuild(uids, cap))
    n = ppt.uniq_count(uids, cap)
    assert (pos >= 0).sum() == n and pos[cap - 1] == n - 1
    dev = popt.rebuild_pos(torch.from_numpy(uids), n, cap)
    np.testing.assert_array_equal(dev.numpy(), pos)


# the flagship batch's key slots and a chunk of 8 of them (about 63% real,
# over the flagship's 557,083 pass keys)
@pytest.mark.parametrize("K", [131072, 8 * 131072], ids=["batch", "chunk"])
def test_device_maps_equal_the_host_dedup(K):
    cap = 1 << 20
    n_valid = int(K * 0.627)
    ids = _ids(K, n_valid, 557083, cap, seed=5)
    uids, perm, inv, n_uniq = ppt.dedup_ids(ids, cap)
    offsets = ppt.segment_offsets(inv, n_valid)
    t_ids = torch.from_numpy(ids)
    inv_dev = torch.searchsorted(torch.from_numpy(
        ppt.dedup_uids_sorted(ids, cap)), t_ids, out_int32=True)
    p, o = popt.device_push_maps(inv_dev, n_valid)
    np.testing.assert_array_equal(p.numpy(), perm)
    np.testing.assert_array_equal(o.numpy(), offsets)
    # the ids-only wire's torch.unique gives the same uniques and inverse
    uniq, inv_u = torch.unique(t_ids, sorted=True, return_inverse=True)
    assert uniq.shape[0] == n_uniq
    np.testing.assert_array_equal(inv_u.to(torch.int32).numpy(),
                                  inv_dev.numpy())


def _push_inputs(K, n_valid, cap, seed):
    """A slab whose rows mix creation (mf_size 0) and update, a batch's
    ids and per-occurrence push rows (zero on the padding slots)."""
    rng = np.random.RandomState(seed)
    layout, push = ValueLayout(D), PushLayout(D)
    slab = np.zeros((cap, layout.width), np.float32)
    slab[:, acc.SHOW] = rng.randint(1, 20, cap)
    slab[:, acc.EMBED_W] = rng.randn(cap) * 0.1
    has_mf = rng.rand(cap) < 0.5
    slab[has_mf, acc.MF_SIZE] = D
    xw = layout.embedx_w
    slab[has_mf, xw:xw + D] = rng.randn(int(has_mf.sum()), D) * 0.01
    ids = _ids(K, n_valid, cap // 2, cap, seed)
    live = np.arange(K) < n_valid
    grads = np.zeros((K, push.width), np.float32)
    grads[:, push.SHOW] = live
    grads[:, push.CLICK] = rng.randint(0, 2, K) * live
    grads[:, push.EMBED_G] = rng.randn(K) * 0.2 * live
    grads[:, push.embedx_g:] = rng.randn(K, D) * 0.2 * live[:, None]
    return layout, slab, ids, grads


@pytest.mark.parametrize("wire,write", [
    (wire, write) for wire in ("full", "uid", "delta")
    for write in ("scatter", "rebuild", "blocked")] + [
    ("ids_only", "scatter")])
@pytest.mark.parametrize("n_valid", [300, 512], ids=["padded", "no_pad"])
def test_every_wire_and_write_pushes_the_full_wires_bits(write, wire,
                                                         n_valid):
    """One push from the same inputs on every wire and write (the
    ids-only wire pushes by scatter only): the whole slab (the trash row
    included) bit-identical to the full wire's scatter. A batch with no
    padding has no trash id among its uids; the delta wire decodes one at
    position n_uniq, and it must not be written."""
    cap, K = 1024, 512
    layout, slab_np, ids, grads_np = _push_inputs(K, n_valid, cap, seed=6)
    conf = SparseOptimizerConfig(**OPT)
    uids, perm, inv, n_uniq = ppt.dedup_ids(ids, cap)
    offsets = ppt.segment_offsets(inv, n_valid)
    t = torch.from_numpy
    want = t(slab_np.copy())
    popt.push_sparse_hostdedup(want, t(uids), t(perm), t(offsets), n_uniq,
                               t(grads_np), 77, layout, conf)
    got = t(slab_np.copy())
    if wire == "full":
        if write == "rebuild":
            popt.push_sparse_rebuild(got, t(uids),
                                     t(ppt.pos_for_rebuild(uids, cap)),
                                     t(perm), t(offsets), n_uniq,
                                     t(grads_np), 77, layout, conf)
        else:
            popt.push_sparse_hostdedup(got, t(uids), t(perm), t(offsets),
                                       n_uniq, t(grads_np), 77, layout,
                                       conf, write=write, block_rows=64)
    elif wire == "ids_only":
        popt.push_sparse_dedup(got, t(ids), n_valid, t(grads_np), 77,
                               layout, conf)
    else:
        wire_uids = ppt.dedup_uids_sorted(ids, cap)
        n = ppt.uniq_count(wire_uids, cap)
        assert n == n_uniq
        if wire == "delta":
            base, d16, cut = ppt.delta_encode_uids(wire_uids, cap)
            dev_uids = popt.decode_delta_uids(int(base), t(d16), int(cut),
                                              cap)
        else:
            dev_uids = t(wire_uids)
        popt.push_sparse_uidwire(got, dev_uids, t(ids), n_valid, n,
                                 t(grads_np), 77, layout, conf, write=write,
                                 block_rows=64)
    assert (ids == cap - 1).any() == (n_valid < K)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.numpy().view(np.uint32))


def test_rebuild_on_the_bf16_slab_matches_scatter():
    """The 2-byte rows: the rebuild write moves the encoded int16 rows."""
    cap, K, n_valid = 1024, 512, 300
    layout16 = ValueLayout(D, embed_dtype="bfloat16")
    _, slab_np, ids, grads_np = _push_inputs(K, n_valid, cap, seed=8)
    slab16 = acc.slab_rows_np(slab_np, layout16)
    conf = SparseOptimizerConfig(**OPT)
    uids, perm, inv, n_uniq = ppt.dedup_ids(ids, cap)
    offsets = ppt.segment_offsets(inv, n_valid)
    t = torch.from_numpy
    a, b = t(slab16.copy()), t(slab16.copy())
    popt.push_sparse_hostdedup(a, t(uids), t(perm), t(offsets), n_uniq,
                               t(grads_np), 5, layout16, conf)
    popt.push_sparse_rebuild(b, t(uids), t(ppt.pos_for_rebuild(uids, cap)),
                             t(perm), t(offsets), n_uniq, t(grads_np), 5,
                             layout16, conf)
    assert a.dtype == torch.int16
    assert torch.equal(a, b)


# ----------------------------------------------------------- resolve_write

@pytest.mark.parametrize("mode", ["auto", "scatter", "rebuild", "blocked"])
@pytest.mark.parametrize("wire", ["full", "uid", "ids_only"])
@pytest.mark.parametrize("cap,keys", [(1 << 20, 131072), (1 << 22, 131072),
                                      (4096, 8192)])
def test_resolve_push_write_matches_jax_on_the_cpu(mode, wire, cap, keys):
    stage = StageFlags(h2d_lean=wire != "full",
                       h2d_uid_wire=wire != "ids_only")
    jflags.set_flag("push_write", mode)
    jflags.set_flag("h2d_lean", stage.h2d_lean)
    jflags.set_flag("h2d_uid_wire", stage.h2d_uid_wire)
    push = PushFlags(mode, 1024)
    try:
        want = jtrainer.resolve_push_write(cap, keys)
    except ValueError as e:
        with pytest.raises(ValueError, match="h2d_lean without"):
            push.resolve_push_write(cap, keys, "cpu", stage)
        assert "h2d_lean without" in str(e)
        return
    assert push.resolve_push_write(cap, keys, "cpu", stage) == want
    assert push.resolve_push_write(cap, keys, torch.device("cpu"),
                                   stage) == want


def test_auto_on_the_card_follows_the_measured_rule(monkeypatch):
    auto = PushFlags("auto")
    ratio = pflags.AUTO_REBUILD_MAX_RATIO
    for keys in (131072, 8 * 131072):
        want = "rebuild" if (1 << 20) <= ratio * keys else "scatter"
        assert auto.resolve_push_write(1 << 20, keys, "cuda") == want
    monkeypatch.setattr(pflags, "AUTO_REBUILD_MAX_RATIO", 16)
    assert auto.resolve_push_write(1 << 20, 131072, "cuda") == "rebuild"
    assert auto.resolve_push_write(1 << 22, 131072, "cuda") == "scatter"
    assert auto.resolve_push_write(1 << 20, 131072, "cpu") == "scatter"
    ids_only = StageFlags(h2d_lean=True, h2d_uid_wire=False)
    assert auto.resolve_push_write(1 << 20, 131072, "cuda",
                                   ids_only) == "scatter"


def test_flags_defaults_match_the_reference():
    assert PushFlags().push_write == jflags.get_flag("push_write") == "auto"
    s = StageFlags()
    for name in ("h2d_lean", "h2d_uid_wire", "wire_delta_ids"):
        assert getattr(s, name) == jflags.get_flag(name), name
    assert s.wire == "full"
    assert StageFlags(h2d_lean=True).wire == "uid"
    assert StageFlags(h2d_lean=True, wire_delta_ids=True).wire == "delta"
    with pytest.raises(TypeError, match="bool"):
        StageFlags(h2d_lean=1)
    with pytest.raises(ValueError, match="push_write"):
        PushFlags("log")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_wires_data")
    files, feed = write_synthetic_ctr_files(
        str(out), num_files=2, lines_per_file=96, num_slots=NUM_SLOTS,
        vocab_per_slot=60, max_len=3, seed=7)
    jfeed = type(feed)(slots=feed.slots, batch_size=BATCH)
    pfeed = DataFeedConfig(
        slots=tuple(SlotConfig(s.name, s.type, is_used=s.is_used,
                               max_len=s.max_len)
                    for s in feed.slots), batch_size=BATCH)
    return files, jfeed, pfeed


def _port(pfeed, jparams, write, stage, scan_chunk=4, sync=False):
    model = DeepFM(ModelSpec(num_slots=NUM_SLOTS, slot_dim=3 + D),
                   hidden=HIDDEN)
    model.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}))
    t = BoxTrainer(model, TableConfig(embedx_dim=D, pass_capacity=CAP,
                                      optimizer=SparseOptimizerConfig(**OPT)),
                   pfeed, TrainerConfig(dense_lr=LR, scan_chunk=scan_chunk,
                                        sparse_chunk_sync=sync),
                   seed=0, flags=PushFlags(write, 64), device="cpu",
                   stage_flags=StageFlags(**stage))
    t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    return t


def test_ids_only_wire_refuses_a_position_map(data):
    files, jfeed, pfeed = data
    jparams = _jax_trainer(jfeed).params
    ids_only = {"h2d_lean": True, "h2d_uid_wire": False}
    for write in ("rebuild", "blocked"):
        with pytest.raises(ValueError, match="h2d_lean without"):
            _port(pfeed, jparams, write, ids_only)
    # switched to the ids-only wire after construction: the pass refuses
    t = _port(pfeed, jparams, "rebuild", {})
    t.stage_flags = StageFlags(**ids_only)
    ds = BoxDataset(pfeed)
    ds.set_filelist(files)
    with pytest.raises(ValueError, match="ids-only wire"):
        t.train_pass(ds)
    t.close()


def test_a_batch_without_products_raises(data):
    """Off the ids-only wire, a train batch that carries no dedup product
    raises: the device dedup never runs in its place."""
    files, jfeed, pfeed = data
    t = _port(pfeed, _jax_trainer(jfeed).params, "scatter", {})
    ds = BoxDataset(pfeed)
    ds.set_filelist(files[:1])
    t.table.begin_feed_pass()
    ds.load_into_memory(add_keys_fn=t.table.add_keys)
    t.table.end_feed_pass()
    t.table.begin_pass()
    b = ds.split_batches(1)[0][0]
    batch = t.device_batch(b, t.table.lookup_ids(b.keys, b.valid))
    for k in ("uids", "perm", "offsets", "n_uniq"):
        del batch[k]
    with pytest.raises(KeyError, match="dedup products"):
        t.step_fn(t.table.slab, batch, 3)
    # a test pass stages no product on any wire
    t.table.end_pass()
    for stage in ({}, {"h2d_lean": True}, {"h2d_lean": True,
                                           "wire_delta_ids": True}):
        t.stage_flags = StageFlags(**stage)
        t.table.set_test_mode(True)
        host = t.host_batch(b, np.zeros(b.keys.shape, np.int32))
        t.table.set_test_mode(False)
        assert not {"uids", "perm", "offsets", "n_uniq", "uid_d16",
                    "push_pos"} & set(host)
    t.close()


# ---------------------------------------------------------- two passes

def _jax_trainer(jfeed, scan_chunk=4):
    table = JTable(embedx_dim=D, pass_capacity=CAP, optimizer=JSparse(**OPT))
    model = JDeepFM(JSpec(num_slots=NUM_SLOTS, slot_dim=3 + D), hidden=HIDDEN)
    return JTrainer(model, table, jfeed,
                    JTrainerCfg(dense_lr=LR, scan_chunk=scan_chunk), seed=0)


def _jax_seeds(key, n):
    """(the seeds of a train_pass that splits its key n times, next table
    key), as tests/test_torch_chunks.py replays them."""
    key, prng = jax.random.split(key)
    seeds = []
    for _ in range(n):
        prng, sub = jax.random.split(prng)
        seeds.append(int(jax.random.randint(sub, (), 0,
                                            jnp.int32(2**31 - 1))))
    return seeds, key


def _two_passes(t, files, feed, seeds=None):
    ds = BoxDataset(feed)
    ds.set_filelist(files)
    out, slabs = [], []
    for p in range(2):
        if seeds is not None:
            t.seed_fn = iter(seeds[p]).__next__
        res = t.train_pass(ds)
        assert res["batches"] == 6
        out.append((res["loss"], t.metrics.get_metric_msg("auc")["auc"]))
        slabs.append(t.table.resident_slab.numpy().copy())
    keys = t.table.pass_keys
    return out, slabs, keys, t.table.store.lookup(keys)


@pytest.fixture(scope="module")
def port_reference(data):
    """The port's full-wire scatter run, the one every mode is held to bit
    for bit, from the JAX trainer's initial weights and seeds."""
    files, jfeed, pfeed = data
    jparams = _jax_trainer(jfeed).params
    key = jax.random.PRNGKey(0)
    seeds = []
    for _ in range(2):
        s, key = _jax_seeds(key, 6)
        seeds.append(s)
    t = _port(pfeed, jparams, "scatter", {})
    ref = _two_passes(t, files, pfeed, seeds)
    t.close()
    return jparams, seeds, ref


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX trainer with use_pallas_push, its kernel interpreted on the
    CPU (as tests/test_torch_train.py wires it)."""
    import paddlebox_tpu.embedding.pallas_push as pp
    jflags.set_flag("use_pallas_push", True)
    monkeypatch.setattr(pp, "pallas_apply_push",
                        functools.partial(pp.pallas_apply_push,
                                          interpret=True))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_two_passes_per_mode_match_the_full_wire_and_jax(
        data, port_reference, pallas_interpret, mode):
    files, jfeed, pfeed = data
    jparams, seeds, (ref_out, ref_slabs, ref_keys, ref_rows) = \
        port_reference
    write, stage, wire = MODES[mode]
    t = _port(pfeed, jparams, write, stage)
    assert t.stage_flags.wire == wire
    assert t.push_write == ("scatter" if write == "auto" else write)
    got_out, got_slabs, keys, rows = _two_passes(t, files, pfeed, seeds)
    t.close()
    assert got_out == ref_out
    for a, b in zip(got_slabs, ref_slabs):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    np.testing.assert_array_equal(keys, ref_keys)
    np.testing.assert_array_equal(rows.view(np.uint32),
                                  ref_rows.view(np.uint32))

    # the JAX trainer in the same mode
    jflags.set_flag("push_write", write)
    for name, value in stage.items():
        jflags.set_flag(name, value)
    jt = _jax_trainer(jfeed)
    jt.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    jds = JDataset(jfeed, read_threads=1, columnar=False)
    jds.set_filelist(files)
    want = []
    for _ in range(2):
        res = jt.train_pass(jds)
        want.append((res["loss"], jt.metrics.get_metric_msg("auc")["auc"]))
    for (gl, ga), (wl, wa) in zip(got_out, want):
        np.testing.assert_allclose(gl, wl, rtol=1e-4)
        assert abs(ga - wa) <= 1e-4, (ga, wa)
    j_rows = jt.table.store.lookup(keys)
    np.testing.assert_array_equal(rows[:, INT_COLS], j_rows[:, INT_COLS])
    np.testing.assert_allclose(rows, j_rows, rtol=1e-4, atol=1e-7)
    jt.close()


def test_chunk_sync_on_the_uid_and_delta_wires(data, port_reference):
    """sparse_chunk_sync with one staging of the chunk's flat products:
    the uid and delta wires train as the full wire does."""
    files, _, pfeed = data
    jparams, seeds, _ = port_reference
    sync_seeds = [s[:3] for s in seeds]    # a chunk and 2 tail steps
    runs = {}
    for wire, stage in (("full", {}), ("uid", {"h2d_lean": True}),
                        ("delta", {"h2d_lean": True,
                                   "wire_delta_ids": True})):
        t = _port(pfeed, jparams, "scatter", stage, sync=True)
        runs[wire] = _two_passes(t, files, pfeed, sync_seeds)
        t.close()
    for wire in ("uid", "delta"):
        assert runs[wire][0] == runs["full"][0]
        for a, b in zip(runs[wire][1], runs["full"][1]):
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32))


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode; "
                    "chip_smoke.py's phase 18 holds the rebuild gather and "
                    "every wire's push to the full wire on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("write", ["scatter", "rebuild", "blocked"])
def test_cuda_uid_wire_push_matches_plain(cuda_device, write):
    """The uid wire's push on the card (push_adagrad, gather_rows under
    rebuild, blocked_write under blocked) bit-equal to the CPU's plain
    versions."""
    cap, K, n_valid = 4096, 2048, 1500
    layout, slab_np, ids, grads_np = _push_inputs(K, n_valid, cap, seed=9)
    conf = SparseOptimizerConfig(**OPT)
    wire_uids = ppt.dedup_uids_sorted(ids, cap)
    n = ppt.uniq_count(wire_uids, cap)
    out = []
    for dev in (torch.device("cpu"), cuda_device):
        slab = torch.from_numpy(slab_np.copy()).to(dev)
        popt.push_sparse_uidwire(
            slab, torch.from_numpy(wire_uids).to(dev),
            torch.from_numpy(ids).to(dev), n_valid, n,
            torch.from_numpy(grads_np).to(dev), 11, layout, conf,
            write=write, block_rows=64)
        out.append(slab.cpu())
    assert torch.equal(out[0].view(torch.int32), out[1].view(torch.int32))


@pytest.mark.cuda
def test_cuda_rebuild_gather_matches_plain(cuda_device):
    rng = np.random.RandomState(10)
    rows = torch.from_numpy(rng.randn(777, 17).astype(np.float32)).to(
        cuda_device)
    pos = torch.from_numpy(np.where(rng.rand(1 << 16) < 0.1,
                                    rng.randint(0, 777, 1 << 16), -1)
                           .astype(np.int32)).to(cuda_device)
    ids = pos.clamp(0, 776)
    got = rk.gather_rows(rows, ids)
    assert torch.equal(got.view(torch.int32),
                       rk.gather_rows_plain(rows, ids).view(torch.int32))
