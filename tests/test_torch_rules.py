"""The port's in-table rules (adam, adam_shared, naive) and the expand
block against the JAX package's ``apply_push``, the layouts, and a day of
such tables across the packages.

The reference runs these rules in XLA (``apply_push``), whose lazily
created columns are threefry draws; the port keeps the Pallas kernel's
integer hash of (row id, column, seed) for every layout. So the reference
runs here with ``optimizers._fresh_uniform`` replaced, through
monkeypatch, by that hash: the seed is the one ``_dispatch_apply_push``
hands the Pallas kernel (``jax.random.randint(prng, (), 0, 2**31 - 1)``),
embedx column c hashes c and expand column e (``stream=1``) D + e. The
unpatched ``apply_push`` runs too, once a rule: there every column but the
created ones must hold, and created columns lie in [0, mf_initial_range).

Tolerances: integer-valued columns (slot, show, click, unseen_days,
mf_size), pass-through rows and created columns are exact. The float
columns are held at rtol 1e-6 / atol 1e-9: XLA on the CPU contracts the
adam moment ``beta1 * m + (1 - beta1) * scaled`` into a fused multiply-add
(one rounding where the port, like its kernel built with --fmad=false,
takes two) and may sum a mean's columns in another order, so a float
column differs from the reference's by a rounding or two. The kernel
against its plain version on the card is bit for bit (cuda-marked cases,
which skip here).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlebox_tpu.embedding.optimizers as jopt
from paddlebox_tpu.config import flags as jflags
from paddlebox_tpu.config.configs import (CheckpointConfig as JCkptCfg,
                                          SparseOptimizerConfig as JSparse,
                                          TableConfig as JTable)
from paddlebox_tpu.embedding import accessor as jacc
from paddlebox_tpu.embedding.pass_table import PassTable as JPassTable
from paddlebox_tpu.train import checkpoint as jckpt

from paddlebox_tpu_torch.config.configs import (CheckpointConfig,
                                                SparseOptimizerConfig,
                                                TableConfig)
from paddlebox_tpu_torch.config.flags import CkptFlags
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.embedding import ckpt_store as cks
from paddlebox_tpu_torch.embedding import push_kernels as pk
from paddlebox_tpu_torch.embedding.accessor import PushLayout, ValueLayout
from paddlebox_tpu_torch.embedding.pass_table import (PassTable, dedup_ids,
                                                      segment_offsets)
from paddlebox_tpu_torch.train import checkpoint as pckpt

D = 8
E = 16
N = 300
INT_COLS = [acc.SLOT, acc.SHOW, acc.CLICK, acc.UNSEEN_DAYS, acc.MF_SIZE]
# the layouts beside the plain adagrad table: (rule, expand width)
RULES = [("adam", 0), ("adam_shared", 0), ("naive", 0), ("adagrad", E),
         ("naive", E)]
RULE_IDS = ["%s%s" % (r, "+expand" if e else "") for r, e in RULES]
THRES = {"no_create": 1e9, "create": 0.0, "mixed": 3.0}


def conf_kwargs(thres, **kw):
    """Rates that differ from one another, so a rule reading the wrong one
    shows; slots 0-4 never meet nodeid_slot (the updated-slot rule has a
    test of its own)."""
    return dict(mf_create_thresholds=thres, mf_initial_range=1e-3,
                learning_rate=0.07, mf_learning_rate=0.04,
                feature_learning_rate=0.1, beta1_decay_rate=0.85,
                beta2_decay_rate=0.995, mf_beta1_decay_rate=0.9,
                mf_beta2_decay_rate=0.999, min_bound=-0.5, max_bound=0.5,
                **kw)


def hash_fresh(d):
    """_fresh_uniform as the port creates columns (the Pallas kernel's
    hash, pallas_push.py:86-98), for a table of embedx width ``d``."""

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


def jax_seed(prng):
    return int(jax.random.randint(prng, (), 0, jnp.int32(2**31 - 1)))


def rows_and_grads(layout, n, seed, conf):
    """Value rows with every state column set (adam moments small, beta
    powers a few steps in, g2sums positive), a mix of rows with and
    without embedx, and merged push grads with zero-show (inactive) rows."""
    D_, E_ = layout.embedx_dim, layout.expand_dim
    push = PushLayout.of(layout)
    rng = np.random.RandomState(seed)
    rows = layout.new_rows(n, rng, conf)
    rows[:, acc.SLOT] = rng.randint(0, 5, n)
    rows[:, acc.SHOW] = rng.randint(1, 30, n)
    rows[:, acc.CLICK] = rng.randint(0, 5, n)
    rows[:, acc.DELTA_SCORE] = rng.rand(n)
    rows[:, acc.UNSEEN_DAYS] = rng.randint(0, 3, n)
    rows[:, acc.EMBED_W] = rng.randn(n) * 0.1
    rows[:, acc.MF_SIZE] = np.where(rng.rand(n) < 0.6, D_, 0)
    es, xs, xw = layout.embed_state, layout.embedx_state, layout.embedx_w
    rows[:, xw:xw + D_] = rng.randn(n, D_) * 0.1
    if layout.optimizer == "adagrad":
        rows[:, es] = rng.rand(n)
        rows[:, xs] = rng.rand(n)
    if layout.optimizer in ("adam", "adam_shared"):
        rows[:, es] = rng.randn(n) * 0.01
        rows[:, es + 1] = rng.rand(n) * 0.01
        rows[:, es + 2] = 0.85 ** rng.randint(1, 6, n)
        rows[:, es + 3] = 0.995 ** rng.randint(1, 6, n)
    if layout.optimizer == "adam":
        rows[:, xs:xs + D_] = rng.randn(n, D_) * 0.01
        rows[:, xs + D_:xs + 2 * D_] = rng.rand(n, D_) * 0.01
        rows[:, xs + 2 * D_] = 0.9 ** rng.randint(1, 6, n)
        rows[:, xs + 2 * D_ + 1] = 0.999 ** rng.randint(1, 6, n)
    if layout.optimizer == "adam_shared":
        rows[:, xs] = rng.randn(n) * 0.01
        rows[:, xs + 1] = rng.rand(n) * 0.01
        rows[:, xs + 2] = 0.9 ** rng.randint(1, 6, n)
        rows[:, xs + 3] = 0.999 ** rng.randint(1, 6, n)
    if E_:
        rows[:, layout.expand_w:layout.expand_w + E_] = \
            rng.randn(n, E_) * 0.1
        if layout.expand_state_dim:
            rows[:, layout.expand_state] = rng.rand(n)
    rows = rows.astype(np.float32)
    grads = np.zeros((n, push.width), np.float32)
    grads[:, push.SLOT] = rng.randint(0, 5, n)
    grads[:, push.SHOW] = rng.randint(0, 4, n)   # zero-show rows included
    grads[:, push.CLICK] = np.minimum(grads[:, push.SHOW],
                                      rng.randint(0, 2, n))
    grads[:, push.EMBED_G:] = rng.randn(n, push.width - 3) * 0.2
    grads[grads[:, push.SHOW] == 0, push.EMBED_G:] = 0.0
    row_ids = rng.permutation(1 << 20)[:n].astype(np.int32)
    return rows, grads, row_ids


def port_push(rows, grads, rids, seed, layout, conf):
    return pk.push_adagrad_plain(
        torch.from_numpy(rows), torch.from_numpy(grads),
        torch.from_numpy(rids), seed, layout, conf).numpy()


def jax_push(rows, grads, rids, prng, layout, thres):
    return np.asarray(jopt.apply_push(
        jnp.asarray(rows), jnp.asarray(grads), prng,
        jacc.ValueLayout(layout.embedx_dim, layout.optimizer,
                         layout.expand_dim), JSparse(**conf_kwargs(thres)),
        row_ids=jnp.asarray(rids)))


def created_cols(layout):
    """The columns lazy creation writes: embedx and the expand block."""
    cols = list(range(layout.embedx_w, layout.embedx_w + layout.embedx_dim))
    return cols + list(range(layout.expand_w,
                             layout.expand_w + layout.expand_dim))


def assert_rules_match(got, want, rows, grads, layout):
    active = grads[:, PushLayout.SHOW] > 0
    assert active.any() and (~active).any()
    np.testing.assert_array_equal(got[~active], rows[~active])
    np.testing.assert_array_equal(got[:, INT_COLS], want[:, INT_COLS])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    return active & (rows[:, acc.MF_SIZE] == 0) \
        & (got[:, acc.MF_SIZE] == layout.embedx_dim)


@pytest.mark.parametrize("case", sorted(THRES))
@pytest.mark.parametrize("rule,e", RULES, ids=RULE_IDS)
def test_plain_rule_matches_apply_push(rule, e, case, monkeypatch):
    """push_adagrad_plain against apply_push with the port's creation
    rule: integer columns, pass-through rows and created columns exact,
    float columns to rounding."""
    monkeypatch.setattr(jopt, "_fresh_uniform", hash_fresh(D))
    layout = ValueLayout(D, rule, e)
    conf = SparseOptimizerConfig(**conf_kwargs(THRES[case]))
    rows, grads, rids = rows_and_grads(layout, N, 11 + len(rule) + e, conf)
    prng = jax.random.PRNGKey(5)
    got = port_push(rows, grads, rids, jax_seed(prng), layout, conf)
    want = jax_push(rows, grads, rids, prng, layout, THRES[case])
    created = assert_rules_match(got, want, rows, grads, layout)
    assert created.any() == (case != "no_create")
    cols = created_cols(layout)
    np.testing.assert_array_equal(got[np.ix_(created, cols)],
                                  want[np.ix_(created, cols)])


@pytest.mark.parametrize("rule,e", RULES, ids=RULE_IDS)
def test_plain_rule_matches_unpatched_apply_push(rule, e):
    """The real apply_push (threefry creation): every column but the
    created ones holds; created columns lie in [0, mf_initial_range)."""
    layout = ValueLayout(D, rule, e)
    conf = SparseOptimizerConfig(**conf_kwargs(THRES["mixed"]))
    rows, grads, rids = rows_and_grads(layout, N, 3, conf)
    prng = jax.random.PRNGKey(9)
    got = port_push(rows, grads, rids, jax_seed(prng), layout, conf)
    want = jax_push(rows, grads, rids, prng, layout, THRES["mixed"])
    created = got[:, acc.MF_SIZE] != rows[:, acc.MF_SIZE]
    assert created.any()
    cols = created_cols(layout)
    for a in (got, want):
        fresh = a[np.ix_(created, cols)]
        assert (fresh >= 0).all() and (fresh < conf.mf_initial_range).all()
    keep = np.ones(layout.width, bool)
    keep[cols] = False
    np.testing.assert_array_equal(got[:, INT_COLS], want[:, INT_COLS])
    np.testing.assert_allclose(got[:, keep], want[:, keep], rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(got[~created], want[~created], rtol=1e-6,
                               atol=1e-9)


@pytest.mark.parametrize("write", ["scatter", "blocked"])
@pytest.mark.parametrize("rule,e", RULES, ids=RULE_IDS)
def test_fused_push_matches_jax_push(rule, e, write, monkeypatch):
    """The fused push's plain version (merge, row read, rule, write) and
    the wrapper on CPU tensors against the reference's
    push_sparse_hostdedup on the same slab, dedup and seed."""
    from paddlebox_tpu_torch.embedding.optimizers import \
        push_sparse_hostdedup
    monkeypatch.setattr(jopt, "_fresh_uniform", hash_fresh(D))
    layout = ValueLayout(D, rule, e)
    push = PushLayout.of(layout)
    conf = SparseOptimizerConfig(**conf_kwargs(THRES["mixed"]))
    cap, K, n_pad = 1024, 700, 90
    rows, _, _ = rows_and_grads(layout, cap, 21, conf)
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 400, K).astype(np.int32)
    ids[:60] = 17                        # a hot key
    ids[K - n_pad:] = cap - 1            # the padding tail, on the trash row
    grads = (rng.randn(K, push.width) * 0.2).astype(np.float32)
    grads[:, push.SLOT] = rng.randint(0, 5, K)
    grads[:, push.SHOW] = 1.0
    grads[:, push.CLICK] = rng.randint(0, 2, K)
    grads[K - n_pad:] = 0.0
    uids, perm, inv, n_uniq = dedup_ids(ids, cap)
    prng = jax.random.PRNGKey(2)
    want = np.asarray(jopt.push_sparse_hostdedup(
        jnp.asarray(rows), jnp.asarray(uids), jnp.asarray(perm),
        jnp.asarray(inv), jnp.asarray(grads), prng,
        jacc.ValueLayout(D, rule, e), JSparse(**conf_kwargs(3.0))))
    slab = torch.from_numpy(rows.copy())
    push_sparse_hostdedup(
        slab, torch.from_numpy(uids), torch.from_numpy(perm),
        torch.from_numpy(segment_offsets(inv, K - n_pad)), n_uniq,
        torch.from_numpy(grads), jax_seed(prng), layout, conf, write=write,
        block_rows=64)
    got = slab.numpy()
    np.testing.assert_array_equal(got[:, INT_COLS], want[:, INT_COLS])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    created = (rows[:, acc.MF_SIZE] == 0) & (got[:, acc.MF_SIZE] == D)
    assert created.any()
    cols = created_cols(layout)
    np.testing.assert_array_equal(got[np.ix_(created, cols)],
                                  want[np.ix_(created, cols)])


def test_learning_rate_follows_the_updated_slot():
    """The port picks adagrad's embed_w learning rate by the UPDATED slot
    (the Pallas kernel's rule, pallas_push.py:67-68) on every layout;
    apply_push, which the reference runs for the expand block, reads the
    row's old slot (optimizers.py:117-119). A fresh row (slot 0) pushed
    from slot nodeid_slot: mf_learning_rate in the port,
    feature_learning_rate in apply_push."""
    layout = ValueLayout(D, "adagrad", E)
    kw = conf_kwargs(1e9, nodeid_slot=7)
    conf = SparseOptimizerConfig(**kw)
    push = PushLayout.of(layout)
    rows = layout.new_rows(1, np.random.RandomState(0), conf)
    grads = np.zeros((1, push.width), np.float32)
    grads[0, push.SLOT] = 7.0
    grads[0, push.SHOW] = 1.0
    grads[0, push.EMBED_G] = 0.25
    got = port_push(rows, grads, np.zeros(1, np.int32), 1, layout, conf)
    want = np.asarray(jopt.apply_push(
        jnp.asarray(rows), jnp.asarray(grads), jax.random.PRNGKey(0),
        jacc.ValueLayout(D, "adagrad", E), JSparse(**kw),
        row_ids=jnp.zeros(1, jnp.int32)))
    # g2sum 0: ratio = lr * sqrt(3 / 3) = lr exactly, so embed_w = lr * g
    assert got[0, acc.EMBED_W] == np.float32(0.04) * np.float32(0.25)
    assert want[0, acc.EMBED_W] == np.float32(0.1) * np.float32(0.25)
    keep = np.arange(layout.width) != acc.EMBED_W
    np.testing.assert_array_equal(got[:, keep], want[:, keep])


ALL_LAYOUTS = [(r, e, dt) for r in acc.OPTIMIZERS for e in (0, 3, 64)
               for dt in acc.EMBED_DTYPES if not e or r in ("adagrad",
                                                            "naive")]


@pytest.mark.parametrize("rule,e,dt", ALL_LAYOUTS,
                         ids=["%s-%d-%s" % x for x in ALL_LAYOUTS])
def test_layout_matches_reference(rule, e, dt):
    """Widths, column offsets, the push layout, new_rows (beta power
    columns set at creation) and the slab codec's plan: the reference's,
    for every rule, expand width and slab dtype."""
    mine, ref = ValueLayout(D, rule, e, dt), jacc.ValueLayout(D, rule, e, dt)
    for name in ("embed_state", "embedx_w", "embedx_state", "expand_w",
                 "expand_state", "width", "device_width"):
        assert getattr(mine, name) == getattr(ref, name), name
    p, jp = PushLayout.of(mine), jacc.PushLayout(D, e)
    assert (p.embedx_g, p.expand_g, p.width) == (jp.embedx_g, jp.expand_g,
                                                 jp.width)
    kw = conf_kwargs(0.0, initial_range=0.02)
    got = mine.new_rows(50, np.random.RandomState(3),
                        SparseOptimizerConfig(**kw))
    want = ref.new_rows(50, np.random.RandomState(3), JSparse(**kw))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    a, b = acc.slab_codec_plan(mine), jacc.slab_codec_plan(ref)
    for f in ("bf16_cols", "kinds", "srcs", "hi_pos", "lo_pos"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    rng = np.random.RandomState(1)
    rows = (rng.randn(40, mine.width) * 3).astype(np.float32)
    np.testing.assert_array_equal(acc.encode_slab_rows_np(rows, mine),
                                  jacc.encode_slab_rows_np(rows, ref))


def test_layout_refuses_what_the_reference_refuses():
    for rule in ("adam", "adam_shared"):
        with pytest.raises(ValueError, match="adagrad/naive"):
            ValueLayout(D, rule, 4)
    with pytest.raises(ValueError, match="unknown sparse optimizer"):
        ValueLayout(D, "sgd")


def test_launch_counts_name_every_form():
    """Each rule, expand block and slab form counts under its own name
    (push_adagrad and push_adagrad_bf16 for the adagrad table, as
    before)."""
    counts = pk.launch_counts()
    for rule, e in [("adagrad", 0)] + RULES:
        for dt in acc.EMBED_DTYPES:
            assert pk.push_form(ValueLayout(D, rule, e, dt)) in counts
    assert pk.push_form(ValueLayout(D)) == "push_adagrad"
    assert pk.push_form(ValueLayout(D, "adam", 0, "bfloat16")) \
        == "push_adam_bf16"
    assert pk.kernel_built_for(ValueLayout(8, "adam"))
    assert pk.kernel_built_for(ValueLayout(8, "naive", 64))
    assert not pk.kernel_built_for(ValueLayout(4, "adam"))
    assert not pk.kernel_built_for(ValueLayout(8, "adagrad", 16))


# ------------------------------------------------- on the card (cuda mark)

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode; "
                    "chip_smoke.py holds every push form against its plain "
                    "version on the card")
    return torch.device("cuda")


CUDA_CASES = [(r, d, e) for r in ("adam", "adam_shared", "naive")
              for d in pk.KERNEL_RULE_DIMS for e in (0,)] + \
    [(r, d, e) for r in ("adagrad", "naive") for d, e in
     pk.KERNEL_EXPAND_DIMS]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", acc.EMBED_DTYPES)
@pytest.mark.parametrize("rule,d,e", CUDA_CASES,
                         ids=["%s-%d-%d" % c for c in CUDA_CASES])
def test_cuda_push_rule_matches_plain(cuda_device, rule, d, e, dt):
    """Each instantiation over several tiles, with a hot key and a
    padding tail, in both write modes: bit-equal to its plain version,
    one launch counted under its form."""
    layout = ValueLayout(d, rule, e, dt)
    push = PushLayout.of(layout)
    conf = SparseOptimizerConfig(**conf_kwargs(3.0))
    rng = np.random.RandomState(d + e)
    cap, K, n_pad = 4096, 3000, 300
    ids = rng.randint(0, 1500, K).astype(np.int32)
    ids[:400] = 7
    ids[K - n_pad:] = cap - 1
    uids, perm, inv, n = dedup_ids(ids, cap)
    rows, _, _ = rows_and_grads(layout, cap, 5, conf)
    grads = (rng.randn(K, push.width) * 0.2).astype(np.float32)
    grads[:, push.SHOW] = rng.randint(0, 2, K)
    grads[K - n_pad:] = 0.0
    slab = torch.from_numpy(acc.slab_rows_np(rows, layout)).to(cuda_device)
    g, p, o, u = (torch.from_numpy(x).to(cuda_device) for x in (
        grads, perm, segment_offsets(inv, K - n_pad), uids))
    for rows_out in (False, True):
        s_k, s_p = slab.clone(), slab.clone()
        before = pk.launch_counts()[pk.push_form(layout)]
        got = pk.push_adagrad(s_k, g, p, o, u, n, 99, layout, conf, rows_out)
        torch.cuda.synchronize()
        assert pk.launch_counts()[pk.push_form(layout)] == before + 1
        want = pk.push_adagrad_fused_plain(s_p, g, p, o, u, n, 99, layout,
                                           conf, rows_out)
        assert torch.equal(s_k, s_p)
        if rows_out:
            assert torch.equal(got, want)


# ----------------------------------------------- a day across the packages

CAP = 1 << 10
DAY_OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
DAY_LAYOUTS = [("adam", 0), ("adagrad", 6)]


def _cfgs(rule, e):
    return (TableConfig(embedx_dim=4, expand_embed_dim=e, pass_capacity=CAP,
                        optimizer=SparseOptimizerConfig(optimizer=rule,
                                                        **DAY_OPT)),
            JTable(embedx_dim=4, expand_embed_dim=e, pass_capacity=CAP,
                   optimizer=JSparse(optimizer=rule, **DAY_OPT)))


def _sorted_items(store):
    keys, rows = store.state_items()
    order = np.argsort(keys)
    return keys[order], rows[order]


def _assert_stores_equal(a, b):
    (ka, va), (kb, vb) = a, b
    np.testing.assert_array_equal(ka, kb)
    assert va.shape == vb.shape
    np.testing.assert_array_equal(np.ascontiguousarray(va).view(np.uint32),
                                  np.ascontiguousarray(vb).view(np.uint32))


def _drive_pass(table, keys, step):
    """One pass over ``keys``: half of them looked up, their slab rows
    edited as a push would (every column moves), then the touched
    write-back."""
    table.begin_feed_pass()
    table.add_keys(keys)
    table.end_feed_pass()
    table.begin_pass()
    sub = keys[:max(1, keys.size // 2)]
    ids = torch.from_numpy(np.unique(table.lookup_ids(sub)).astype(np.int64))
    with torch.no_grad():
        slab = table.slab
        slab[ids] += step
        slab[ids, acc.SHOW] += 1.0
        slab[ids, acc.UNSEEN_DAYS] = 0.0
        slab[ids, acc.MF_SIZE] = 4.0
    table.end_pass()


def _port_cm(root, table, **flags):
    return pckpt.CheckpointManager(
        CheckpointConfig(batch_model_dir=str(root / "batch"),
                         xbox_model_dir=str(root / "xbox"),
                         async_save=False), table, CkptFlags(**flags))


def _jax_cm(root, table):
    return jckpt.CheckpointManager(
        JCkptCfg(batch_model_dir=str(root / "batch"),
                 xbox_model_dir=str(root / "xbox"), async_save=False), table)


@pytest.mark.parametrize("rule,e", DAY_LAYOUTS,
                         ids=["adam", "adagrad+expand"])
def test_port_day_of_new_layouts_loads_in_the_reference(rule, e, tmp_path):
    """A port-written day of an adam table and of an expand table (a full
    base, a pass, then a journal-mode base): the reference's load_base
    gives the port's own store bit for bit, both bases."""
    cfg, jcfg = _cfgs(rule, e)
    rng = np.random.RandomState(len(rule) + e)
    t = PassTable(cfg, seed=3, device="cpu")
    cm = _port_cm(tmp_path, t)
    keys = np.unique(rng.randint(1, 1 << 40, 400).astype(np.uint64))
    _drive_pass(t, keys, 0.01)
    cm.save_base({"w": np.float32(0)}, {}, day="d0")
    _drive_pass(t, np.unique(np.concatenate(
        [keys[::3], rng.randint(1, 1 << 40, 50).astype(np.uint64)])), 0.02)
    t.end_day()
    cm.save_base({"w": np.float32(1)}, {}, day="d1", mode="touched")
    assert cks.read_manifest(os.path.join(
        tmp_path, "batch", "d1", "sparse.xman"))["mode"] == "journal"
    jflags.set_flag("flatten_dense_opt", False)
    for day in ("d0", "d1"):
        mine = PassTable(cfg, device="cpu")
        _port_cm(tmp_path, mine, ckpt_journal=False).load_base(day)
        jt = JPassTable(jcfg)
        _jax_cm(tmp_path, jt).load_base(day)
        _assert_stores_equal(_sorted_items(jt.store),
                             _sorted_items(mine.store))
        assert mine.store.state_items()[1].shape[1] == t.layout.width


@pytest.mark.parametrize("rule,e", DAY_LAYOUTS,
                         ids=["adam", "adagrad+expand"])
def test_reference_day_of_new_layouts_loads_in_the_port(rule, e, tmp_path):
    """The reverse: a reference-written full base and journal-mode base
    of the same tables through the port's load_base, bit-equal to the
    reference's own load."""
    cfg, jcfg = _cfgs(rule, e)
    jflags.set_flag("ckpt_journal", True)
    jflags.set_flag("flatten_dense_opt", False)
    rng = np.random.RandomState(7 + e)
    jt = JPassTable(jcfg)
    width = jt.layout.width
    keys = np.unique(rng.randint(1, 1 << 40, 300).astype(np.uint64))
    vals = rng.rand(keys.size, width).astype(np.float32)
    vals[:, acc.SHOW] = rng.randint(0, 30, keys.size)
    jt.store.load_blob({"keys": keys, "values": vals, "embedx_dim": 4,
                        "optimizer": rule})
    jcm = _jax_cm(tmp_path, jt)
    jcm.save_base({"w": np.ones(2, np.float32)}, {}, day="d0")
    upd = np.unique(np.concatenate(
        [keys[::3], rng.randint(1, 1 << 40, 40).astype(np.uint64)]))
    jt.begin_feed_pass()
    jt.add_keys(upd)
    jt.end_feed_pass()
    jt.begin_pass()
    jt.lookup_ids(upd[::2])
    jt.end_pass()
    jt.end_day()
    bdir, _ = jcm.save_base({"w": np.ones(2, np.float32)}, {}, day="d1",
                            mode="auto")
    assert cks.read_manifest(os.path.join(bdir, "sparse.xman"))[
        "mode"] == "journal"
    for day in ("d0", "d1"):
        jt2 = JPassTable(jcfg)
        _jax_cm(tmp_path, jt2).load_base(day)
        pt = PassTable(cfg, device="cpu")
        _port_cm(tmp_path, pt, ckpt_journal=False).load_base(day)
        _assert_stores_equal(_sorted_items(pt.store),
                             _sorted_items(jt2.store))
