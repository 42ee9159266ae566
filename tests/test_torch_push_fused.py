"""The port's fused push (merge, row read, in-table adagrad, row write in one
kernel) against the JAX push and against the unfused composition it
replaced, on the CPU, where the wrapper runs its plain version.

The JAX reference is ``push_sparse_hostdedup`` with ``use_pallas_push``,
its Pallas kernel interpreted on the CPU, fed the seed the JAX step draws
from its key. Tolerances: integer-valued columns (slot, show, click,
unseen_days, mf_size) and created embedx are exact (integer sums and a
pure uint32 hash); the other floats within the one-step rtol 1e-5 (JAX's
scatter-add merge and XLA's 8-term embedx mean may add in another order).
The unfused composition (occurrence gather, searchsorted, segment_reduce,
pulled-row gather, per-row update, index_copy_) does the same f32
operations in the same order, so against it the fused push is bit-equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.config import flags as jflags
from paddlebox_tpu.config.configs import SparseOptimizerConfig as JSparse
from paddlebox_tpu.embedding.accessor import ValueLayout as JLayout
from paddlebox_tpu.embedding.optimizers import (
    push_sparse_hostdedup as jax_push_sparse_hostdedup)
from paddlebox_tpu.embedding.pass_table import (
    first_occurrence_idx as jax_first_idx)

from paddlebox_tpu_torch.config.configs import SparseOptimizerConfig
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.embedding import push_kernels as pk
from paddlebox_tpu_torch.embedding.accessor import PushLayout, ValueLayout
from paddlebox_tpu_torch.embedding.optimizers import push_sparse_hostdedup
from paddlebox_tpu_torch.embedding.pass_table import (dedup_ids,
                                                      segment_offsets)

D = 8
CAP = 512
BLOCK = 32
INT_COLS = [acc.SLOT, acc.SHOW, acc.CLICK, acc.UNSEEN_DAYS, acc.MF_SIZE]
CONF = dict(mf_create_thresholds=3.0, mf_initial_range=1e-3,
            feature_learning_rate=0.1, mf_learning_rate=0.05, nodeid_slot=3)


def push_case(seed, K=400, n_keys=150, hot=100, n_pad=60, cap=CAP):
    """One step's push inputs, as the train step builds them: ids with one
    key repeated ``hot`` times and a padding tail of ``n_pad`` key slots on
    the trash row; a slab whose touched rows mix embedx to create (mf_size
    0, score over the threshold), to leave (mf_size 0, under it) and to
    update (mf_size D); per-occurrence push rows with g_show 1, except the
    padding (all zero) and a few keys whose rows are all zero (inactive)."""
    layout, push = ValueLayout(D), PushLayout(D)
    rng = np.random.RandomState(seed)
    n_valid = K - n_pad
    ids = np.full(K, cap - 1, np.int32)
    ids[:n_valid] = rng.permutation(np.concatenate(
        [np.full(hot, 7), rng.randint(8, n_keys, n_valid - hot)]))
    slab = np.zeros((cap, layout.width), np.float32)
    slab[:, acc.SLOT] = rng.randint(0, 5, cap)
    slab[:, acc.SHOW] = rng.randint(0, 30, cap)
    slab[:, acc.CLICK] = rng.randint(0, 5, cap)
    slab[:, acc.DELTA_SCORE] = rng.rand(cap)
    slab[:, acc.UNSEEN_DAYS] = rng.randint(0, 3, cap)
    slab[:, acc.EMBED_W] = rng.randn(cap) * 0.1
    slab[:, layout.embed_state] = rng.rand(cap)
    has_mf = rng.rand(cap) < 0.5
    slab[has_mf, acc.MF_SIZE] = D
    xw = layout.embedx_w
    slab[has_mf, xw:xw + D] = rng.randn(int(has_mf.sum()), D) * 0.01
    slab[has_mf, layout.embedx_state] = rng.rand(int(has_mf.sum()))
    slab[cap - 1] = rng.rand(layout.width)   # the trash row passes through
    grads = np.zeros((K, push.width), np.float32)
    live = (np.arange(K) < n_valid) & (ids % 11 != 5)
    grads[:, push.SLOT] = slab[ids, acc.SLOT] * live
    grads[:, push.SHOW] = live
    grads[:, push.CLICK] = rng.randint(0, 2, K) * live
    grads[:, push.EMBED_G] = rng.randn(K) * 0.2 * live
    grads[:, push.embedx_g:] = rng.randn(K, D) * 0.2 * live[:, None]
    uids, perm, inv, n_uniq = dedup_ids(ids, cap)
    return dict(ids=ids, slab=slab, grads=grads.astype(np.float32),
                uids=uids, perm=perm, inv=inv, n_uniq=n_uniq,
                n_valid=n_valid, offsets=segment_offsets(inv, n_valid))


def _t(c, *names):
    return [torch.from_numpy(np.ascontiguousarray(c[n])) for n in names]


def port_push(c, seed, write, conf=None):
    """The slab after the port's push_sparse_hostdedup (plain versions)."""
    slab = torch.from_numpy(c["slab"].copy())
    uids, perm, offsets, grads = _t(c, "uids", "perm", "offsets", "grads")
    push_sparse_hostdedup(slab, uids, perm, offsets, c["n_uniq"], grads,
                          seed, ValueLayout(D),
                          conf or SparseOptimizerConfig(**CONF),
                          write=write, block_rows=BLOCK)
    return slab.numpy()


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX push with use_pallas_push, its kernel interpreted on the
    CPU (as tests/test_torch_train.py wires it); the flag is put back."""
    import paddlebox_tpu.embedding.pallas_push as pp
    before = jflags.get_flag("use_pallas_push")
    jflags.set_flag("use_pallas_push", True)
    monkeypatch.setattr(pp, "pallas_apply_push",
                        functools.partial(pp.pallas_apply_push,
                                          interpret=True))
    yield
    jflags.set_flag("use_pallas_push", before)


@pytest.mark.parametrize("write", ["scatter", "blocked"])
@pytest.mark.parametrize("case_seed", [0, 1])
def test_fused_push_matches_jax_pallas_push(pallas_interpret, case_seed,
                                            write):
    c = push_case(case_seed)
    prng = jax.random.PRNGKey(10 + case_seed)
    # the seed _dispatch_apply_push hands the Pallas kernel
    seed = int(jax.random.randint(prng, (), 0, jnp.int32(2**31 - 1)))
    want = np.asarray(jax_push_sparse_hostdedup(
        jnp.asarray(c["slab"]), jnp.asarray(c["uids"]),
        jnp.asarray(c["perm"]), jnp.asarray(c["inv"]),
        jnp.asarray(c["grads"]), prng, JLayout(D, "adagrad"),
        JSparse(**CONF)))
    got = port_push(c, seed, write)
    layout = ValueLayout(D)
    before = c["slab"]
    real = c["uids"][:c["n_uniq"]]
    touched = np.zeros(CAP, bool)
    touched[real] = True
    # the case holds every kind of row
    g_show = np.zeros(CAP)
    np.add.at(g_show, c["ids"], c["grads"][:, PushLayout(D).SHOW])
    active = touched & (g_show > 0)
    created = active & (before[:, acc.MF_SIZE] == 0) \
        & (got[:, acc.MF_SIZE] == D)
    left = active & (before[:, acc.MF_SIZE] == 0) & ~created
    updated = active & (before[:, acc.MF_SIZE] == D)
    inactive = touched & ~active
    assert created.any() and left.any() and updated.any()
    assert inactive[CAP - 1] and inactive[:CAP - 1].any()
    assert np.bincount(c["ids"][:c["n_valid"]])[7] == 100
    np.testing.assert_array_equal(got[~active], before[~active])
    np.testing.assert_array_equal(got[:, INT_COLS], want[:, INT_COLS])
    xw = layout.embedx_w
    np.testing.assert_array_equal(got[created, xw:xw + D],
                                  want[created, xw:xw + D])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def unfused_push(c, seed, write):
    """The push as the port ran it before the fusion: occurrence gather,
    searchsorted offsets, segment_reduce merge, each unique's row from the
    pull's rows at its first occurrence, the per-row update over all K
    uids, then index_copy_ (scatter) or the blocked write of all K rows."""
    layout, conf = ValueLayout(D), SparseOptimizerConfig(**CONF)
    slab = torch.from_numpy(c["slab"].copy())
    ids, uids, perm, inv, grads = _t(c, "ids", "uids", "perm", "inv",
                                     "grads")
    K, n_valid, n_uniq = ids.shape[0], c["n_valid"], c["n_uniq"]
    pulled = slab.index_select(0, ids)
    first = torch.from_numpy(jax_first_idx(c["perm"], c["inv"]))
    sorted_grads = grads.index_select(0, perm[:n_valid])
    offsets = torch.searchsorted(inv[:n_valid],
                                 torch.arange(K + 1, dtype=inv.dtype))
    merged = torch.segment_reduce(sorted_grads, "sum", offsets=offsets,
                                  axis=0, unsafe=True)
    new_rows = pk.push_adagrad_plain(pulled.index_select(0, first), merged,
                                     uids, seed, layout, conf)
    if write == "scatter":
        slab.index_copy_(0, uids[:n_uniq].to(torch.int64), new_rows[:n_uniq])
    else:
        from paddlebox_tpu_torch.embedding.optimizers import \
            push_blocked_write
        push_blocked_write(slab, uids, new_rows, BLOCK)
    return slab.numpy(), new_rows[:n_uniq].numpy()


@pytest.mark.parametrize("write", ["scatter", "blocked"])
def test_fused_push_equals_unfused_composition_bitwise(write):
    c = push_case(2)
    seed = 424242
    want_slab, want_rows = unfused_push(c, seed, write)
    np.testing.assert_array_equal(port_push(c, seed, write).view(np.uint32),
                                  want_slab.view(np.uint32))
    # the rows-out mode the blocked path launches returns the same rows
    slab, grads, perm, offsets, uids = _t(c, "slab", "grads", "perm",
                                          "offsets", "uids")
    rows = pk.push_adagrad(slab, grads, perm, offsets, uids, c["n_uniq"],
                           seed, ValueLayout(D),
                           SparseOptimizerConfig(**CONF), rows_out=True)
    np.testing.assert_array_equal(rows.numpy().view(np.uint32),
                                  want_rows.view(np.uint32))
    np.testing.assert_array_equal(slab.numpy(), c["slab"])  # untouched


@pytest.mark.parametrize("K,n_pad,hot", [(400, 60, 100), (300, 0, 1),
                                         (64, 64, 1), (0, 0, 0)])
def test_segment_offsets_equal_searchsorted(K, n_pad, hot):
    rng = np.random.RandomState(K + n_pad)
    ids = rng.randint(0, 40, K).astype(np.int32)
    ids[:hot] = 3
    rng.shuffle(ids)
    ids[K - n_pad:] = CAP - 1
    uids, perm, inv, n_uniq = dedup_ids(ids, CAP)
    n_valid = K - n_pad
    got = segment_offsets(inv, n_valid)
    assert got.dtype == np.int32 and got.shape == (K + 1,)
    want = torch.searchsorted(torch.from_numpy(inv[:n_valid]),
                              torch.arange(K + 1, dtype=torch.int32))
    np.testing.assert_array_equal(got, want.numpy())
    # the real keys lead the uids, each run as long as the key's count
    lengths = np.diff(got)
    real = uids[:n_uniq][uids[:n_uniq] != CAP - 1]
    np.testing.assert_array_equal(
        lengths[:real.size], np.bincount(ids[:n_valid], minlength=CAP)[real])
    assert lengths.sum() == n_valid
