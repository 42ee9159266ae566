"""The port's push kernels: plain versions against the JAX Pallas kernels,
wrapper contracts, and (on a GPU) each CUDA kernel against its plain
version.

The Pallas kernels run interpreted on the CPU, as the JAX package's own
tests run them. Tolerances: integer-valued columns, created embedx and
mf_size are exact (integer sums and a pure uint32 hash); the float columns
of the per-row adagrad update within rtol 1e-6 (the same f32 operations,
but XLA may sum the 8-term embedx mean in another order than the port's
column-0-up loop); the blocked write is pure placement and bit-exact. The
fused push against the JAX push is tests/test_torch_push_fused.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.config.configs import SparseOptimizerConfig as JSparse
from paddlebox_tpu.embedding.accessor import ValueLayout as JLayout
from paddlebox_tpu.embedding.optimizers import (
    push_blocked_write as jax_push_blocked_write)
from paddlebox_tpu.embedding.pallas_push import (pallas_apply_push,
                                                 pallas_blocked_write)

from paddlebox_tpu_torch import edge_cases
from paddlebox_tpu_torch.config.configs import SparseOptimizerConfig
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.embedding import push_kernels as pk
from paddlebox_tpu_torch.embedding.accessor import PushLayout, ValueLayout
from paddlebox_tpu_torch.embedding.optimizers import (blocked_layout,
                                                      push_blocked_write)
from paddlebox_tpu_torch.embedding.pass_table import (dedup_ids,
                                                      segment_offsets)

D = 8
N = 300  # not a multiple of the Pallas kernel's 256-row tile
INT_COLS = [acc.SLOT, acc.SHOW, acc.CLICK, acc.UNSEEN_DAYS, acc.MF_SIZE]


def _conf_kwargs(create_thres):
    return dict(mf_create_thresholds=create_thres, mf_initial_range=1e-3,
                feature_learning_rate=0.1, mf_learning_rate=0.05,
                nodeid_slot=3)


def _rows_and_grads(n, seed, with_mf):
    """Value rows and merged grads with zero-show (inactive) rows mixed
    in; slot 3 takes the nodeid learning rate."""
    layout = ValueLayout(D)
    push = PushLayout(D)
    rng = np.random.RandomState(seed)
    rows = np.zeros((n, layout.width), np.float32)
    rows[:, acc.SLOT] = rng.randint(0, 5, n)
    rows[:, acc.SHOW] = rng.randint(1, 30, n)
    rows[:, acc.CLICK] = rng.randint(0, 5, n)
    rows[:, acc.DELTA_SCORE] = rng.rand(n)
    rows[:, acc.UNSEEN_DAYS] = rng.randint(0, 3, n)
    rows[:, acc.EMBED_W] = rng.randn(n) * 0.1
    rows[:, layout.embed_state] = rng.rand(n)
    if with_mf:
        rows[:, acc.MF_SIZE] = np.where(rng.rand(n) < 0.7, D, 0)
        xw = layout.embedx_w
        rows[:, xw:xw + D] = rng.randn(n, D) * 0.01
        rows[:, layout.embedx_state] = rng.rand(n)
    grads = np.zeros((n, push.width), np.float32)
    grads[:, push.SLOT] = rng.randint(0, 5, n)
    grads[:, push.SHOW] = rng.randint(0, 4, n)  # zero-show rows included
    grads[:, push.CLICK] = np.minimum(grads[:, push.SHOW],
                                      rng.randint(0, 2, n))
    grads[:, push.EMBED_G] = rng.randn(n) * 0.2
    grads[:, push.embedx_g:push.embedx_g + D] = rng.randn(n, D) * 0.2
    row_ids = rng.permutation(1 << 20)[:n].astype(np.int32)
    return layout, rows.astype(np.float32), grads, row_ids


@pytest.mark.parametrize("case", ["no_create", "create", "mixed"])
def test_plain_adagrad_matches_pallas(case):
    thres = {"no_create": 1e9, "create": 0.0, "mixed": 3.0}[case]
    layout, rows, grads, rids = _rows_and_grads(
        N, seed={"no_create": 0, "create": 3, "mixed": 5}[case],
        with_mf=case != "create")
    seed = 1234567
    want = np.asarray(pallas_apply_push(
        jnp.asarray(rows), jnp.asarray(grads), seed, JLayout(D, "adagrad"),
        JSparse(**_conf_kwargs(thres)), interpret=True,
        row_ids=jnp.asarray(rids)))
    got = pk.push_adagrad_plain(
        torch.from_numpy(rows), torch.from_numpy(grads),
        torch.from_numpy(rids), seed, layout,
        SparseOptimizerConfig(**_conf_kwargs(thres))).numpy()
    active = grads[:, PushLayout(D).SHOW] > 0
    assert active.any() and (~active).any()
    np.testing.assert_array_equal(got[~active], rows[~active])
    np.testing.assert_array_equal(got[:, INT_COLS], want[:, INT_COLS])
    created = active & (rows[:, acc.MF_SIZE] == 0) & (got[:, acc.MF_SIZE] == D)
    if case != "no_create":
        assert created.any()
    xw = layout.embedx_w
    np.testing.assert_array_equal(got[created, xw:xw + D],
                                  want[created, xw:xw + D])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def _blocked_case(seed=3, cap=512, K=160, block=32):
    rng = np.random.RandomState(seed)
    W = ValueLayout(D).width
    slab = rng.rand(cap, W).astype(np.float32)
    ids = rng.randint(0, cap // 2, K).astype(np.int32)
    ids[rng.rand(K) < 0.2] = cap - 1   # trash-row occurrences
    uids, _, _, n_uniq = dedup_ids(ids, cap)
    assert n_uniq < K   # a padding tail is present
    new_rows = rng.rand(K, W).astype(np.float32)
    return slab, uids, new_rows, block


def test_plain_blocked_write_matches_jax():
    slab, uids, new_rows, B = _blocked_case()
    want = np.asarray(jax_push_blocked_write(
        jnp.asarray(slab), jnp.asarray(uids), jnp.asarray(new_rows), B))
    row_map, blk_idx = blocked_layout(torch.from_numpy(uids), slab.shape[0],
                                      B)
    # the Pallas grid needs its slots in reverse (sentinel slots before the
    # real write of the block they clamp onto, optimizers.py:443-456); the
    # port's kernel does not read the slab back and takes any order
    rm, bi = row_map.numpy()[::-1], blk_idx.numpy()[::-1]
    tiles = new_rows[np.clip(rm, 0, len(uids) - 1)]
    want_pallas = np.asarray(pallas_blocked_write(
        jnp.asarray(slab), jnp.asarray(tiles), jnp.asarray(rm),
        jnp.asarray(bi), interpret=True))
    got = torch.from_numpy(slab.copy())
    pk.blocked_write_plain(got, torch.from_numpy(new_rows), row_map, blk_idx)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want_pallas.view(np.uint32))
    # the in-place entry point does the same
    again = torch.from_numpy(slab.copy())
    push_blocked_write(again, torch.from_numpy(uids),
                       torch.from_numpy(new_rows), B)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


BLOCKED_CASES = edge_cases.blocked_edge_cases()


@pytest.mark.parametrize("case", sorted(BLOCKED_CASES))
def test_plain_blocked_write_edge_cases_match_pallas(case):
    """Permuted sources, sentinel slots (ordered before the real write of
    the block they share, as the Pallas grid needs), a fully placed slot,
    B in {100, 256, 1024, 4096}, NB = 1, nothing placed: the plain version
    (the wrapper on the CPU) is the interpreted Pallas kernel, bit for bit,
    and places exactly the placed lanes."""
    slab, new_rows, row_map, blk_idx, _ = BLOCKED_CASES[case]
    NB, B = row_map.shape
    tiles = new_rows[np.clip(row_map, 0, len(new_rows) - 1)]
    want = np.asarray(pallas_blocked_write(
        jnp.asarray(slab), jnp.asarray(tiles), jnp.asarray(row_map),
        jnp.asarray(blk_idx), interpret=True))
    expect = slab.copy()
    slots, lanes = np.nonzero(row_map >= 0)
    expect[blk_idx[slots].astype(np.int64) * B + lanes] = \
        new_rows[row_map[slots, lanes]]
    got = torch.from_numpy(slab.copy())
    pk.blocked_write(got, torch.from_numpy(new_rows),
                     torch.from_numpy(row_map), torch.from_numpy(blk_idx))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  expect.view(np.uint32))


def test_blocked_layout_drops_padding_and_refuses_bad_blocks():
    _, uids, _, B = _blocked_case()
    row_map, blk_idx = blocked_layout(torch.from_numpy(uids), 512, B)
    assert row_map.shape == (min(len(uids), 512 // B), B)
    placed = row_map[row_map >= 0]
    assert (uids[placed.numpy()] < 512).all()
    assert int(blk_idx.max()) < 512 // B
    with pytest.raises(ValueError):
        blocked_layout(torch.from_numpy(uids), 512, 48)


def _layout_uids(case):
    """(uids, capacity) of a blocked-layout case: the first flagship
    batch's sorted uids on the 2^20-row slab (77,128 in range and the
    padding tail), or a dense draw of 410,407 of 2^20 rows, the density of
    a step of 8 flagship batches, with a padding tail."""
    C = 1 << 20
    if case == "flagship":
        import tempfile

        from paddlebox_tpu_torch.train import flagship
        cfg = flagship.FLAGSHIP
        with tempfile.TemporaryDirectory() as tmp:
            files, feed = flagship.write_files(
                tmp, dataclasses.replace(cfg, num_files=1))
            ids = flagship.first_batch_ids(files, feed, cfg)
        uids, _, _, n_uniq = dedup_ids(ids, cfg.capacity)
        assert (cfg.capacity, n_uniq) == (C, 77128)
        return uids, C
    rng = np.random.RandomState(32)
    drawn = np.sort(rng.choice(C - 1, 410407, replace=False))
    return np.concatenate([drawn, C + np.arange(64)]).astype(np.int32), C


@pytest.mark.parametrize("case", ["flagship", "dense"])
def test_blocked_layout_is_the_reference_layout_in_one_run(case,
                                                           monkeypatch):
    """blocked_layout's row map and block ids are the reference's
    (push_blocked_write's row_map and blk_of_slot, optimizers.py:409-426,
    as it hands them to its Pallas kernel, slots reversed there), and its
    placed lanes read new_rows 0, 1, 2, ... in lane order: every tile of
    the f32 kernel's lanes takes one consecutive run of source rows."""
    from paddlebox_tpu.config import flags
    from paddlebox_tpu.embedding import pallas_push

    uids, C = _layout_uids(case)
    B = 1024
    seen = {}

    def capture(slab, tiles, row_map, blk, interpret=False):
        seen["row_map"] = np.asarray(row_map)[::-1]
        seen["blk_idx"] = np.asarray(blk)[::-1]
        return slab

    monkeypatch.setattr(pallas_push, "pallas_blocked_write", capture)
    flags.set_flag("push_blocked_pallas", True)
    try:
        jax_push_blocked_write(jnp.zeros((C, 1), jnp.float32),
                               jnp.asarray(uids),
                               jnp.zeros((len(uids), 1), jnp.float32), B)
    finally:
        flags.set_flag("push_blocked_pallas", False)
    row_map, blk_idx = blocked_layout(torch.from_numpy(uids), C, B)
    np.testing.assert_array_equal(row_map.numpy(), seen["row_map"])
    np.testing.assert_array_equal(blk_idx.numpy(), seen["blk_idx"])
    flat = row_map.numpy().reshape(-1)
    placed = flat[flat >= 0]
    assert placed.size == int((uids < C).sum())
    np.testing.assert_array_equal(placed, np.arange(placed.size))


def _push_args(seed=1, K=120, n_pad=20, hot=1, n_keys=60, cap=256):
    """Fused push arguments (slab, grads, perm, offsets, uids) and n_uniq:
    a slab of _rows_and_grads rows, one step's ids with ``hot`` repeats of
    key 5 and a padding tail on the trash row, per-occurrence push rows
    (zero on the padding)."""
    layout, slab, occ, _ = _rows_and_grads(max(cap, K), seed, with_mf=True)
    rng = np.random.RandomState(seed)
    ids = np.full(K, cap - 1, np.int32)
    ids[:K - n_pad] = rng.permutation(np.concatenate(
        [np.full(hot, 5), rng.randint(6, n_keys, K - n_pad - hot)]))
    occ = occ[:K].copy()
    occ[K - n_pad:] = 0.0
    uids, perm, inv, n_uniq = dedup_ids(ids, cap)
    args = (slab[:cap], occ, perm, segment_offsets(inv, K - n_pad), uids)
    return layout, [torch.from_numpy(np.ascontiguousarray(a))
                    for a in args], n_uniq


def test_wrappers_run_plain_on_cpu_without_counting():
    layout, (slab, g, p, o, u), n = _push_args()
    conf = SparseOptimizerConfig(**_conf_kwargs(0.0))
    pk.reset_launch_counts()
    rows = pk.push_adagrad(slab, g, p, o, u, n, 5, layout, conf,
                           rows_out=True)
    assert rows.shape == (n, layout.width)
    want = pk.push_adagrad_fused_plain(slab, g, p, o, u, n, 5, layout, conf,
                                       rows_out=True)
    assert torch.equal(rows, want)
    a, b = slab.clone(), slab.clone()
    assert pk.push_adagrad(a, g, p, o, u, n, 5, layout, conf) is None
    pk.push_adagrad_fused_plain(b, g, p, o, u, n, 5, layout, conf)
    assert torch.equal(a, b) and not torch.equal(a, slab)
    assert torch.equal(a[u[:n].long()], rows)
    slab, uids, new_rows, B = _blocked_case()
    push_blocked_write(torch.from_numpy(slab), torch.from_numpy(uids),
                       torch.from_numpy(new_rows), B)
    counts = pk.launch_counts()
    assert {"push_adagrad", "push_adagrad_bf16", "blocked_write",
            "blocked_write_2byte"} <= set(counts)
    assert not any(counts.values()), counts


def test_wrappers_check_arguments():
    layout, (s, g, p, o, u), n = _push_args(seed=2)
    conf = SparseOptimizerConfig()

    def push(*args, n_uniq=n, seed=0):
        return pk.push_adagrad(*args, n_uniq, seed, layout, conf)

    with pytest.raises(TypeError):
        push(s.double(), g, p, o, u)
    with pytest.raises(TypeError):
        push(s, g, p.long(), o, u)
    with pytest.raises(ValueError):
        push(s, g[:8], p, o, u)
    with pytest.raises(ValueError):
        push(s[:, :10].contiguous(), g, p, o, u)
    with pytest.raises(ValueError):
        push(s.t().contiguous().t(), g, p, o, u)
    with pytest.raises(ValueError):
        push(s, g, p, o[:-1], u)
    with pytest.raises(ValueError):
        push(s, g, p, o, u, n_uniq=u.shape[0] + 1)
    with pytest.raises(ValueError):
        push(s, g, p, o, u, seed=-1)
    slab = torch.zeros(64, layout.width)
    with pytest.raises(TypeError):
        pk.blocked_write(slab, s, torch.zeros(2, 32),
                         torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        pk.blocked_write(slab, s, torch.zeros(2, 48, dtype=torch.int32),
                         torch.zeros(2, dtype=torch.int32))


# ------------------------------------------------- on the card (cuda mark)

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode; "
                    "chip_smoke.py holds both kernels against their plain "
                    "versions on the card")
    return torch.device("cuda")


# push forms on the card: (rule, expand, slab dtype); the expand rows take
# the lane-group design, the others the thread design (push_adagrad.cu)
CUDA_PUSH_FORMS = [("adagrad", 0, "float32"), ("adagrad", 0, "bfloat16"),
                   ("adam", 0, "bfloat16"), ("adagrad", 64, "float32"),
                   ("adagrad", 64, "bfloat16"), ("naive", 64, "bfloat16")]


def _form_push_args(rule, expand, dtype, seed, K, n_pad, hot, n_keys, cap):
    """_push_args' ids and rows for the push form (rule, expand, dtype) at
    embedx D: the rule's state columns and the expand block set by
    push_probe.rule_rows, expand push columns random, the slab encoded
    under bf16."""
    from paddlebox_tpu_torch.embedding.accessor import slab_rows_np
    from paddlebox_tpu_torch.push_probe import rule_rows

    base_layout, (slab, occ, p, o, u), n = _push_args(seed, K, n_pad, hot,
                                                      n_keys, cap)
    layout = ValueLayout(D, rule, expand, dtype)
    conf = SparseOptimizerConfig(**_conf_kwargs(3.0))
    rows = rule_rows(layout, slab.numpy(), conf)
    grads = np.zeros((K, PushLayout.of(layout).width), np.float32)
    grads[:, :occ.shape[1]] = occ.numpy()
    grads[:K - n_pad, occ.shape[1]:] = np.random.RandomState(seed).randn(
        K - n_pad, expand) * 0.2
    return layout, [torch.from_numpy(slab_rows_np(rows, layout)),
                    torch.from_numpy(grads), p, o, u], n


@pytest.mark.cuda
@pytest.mark.parametrize("form", CUDA_PUSH_FORMS,
                         ids=["-".join(map(str, f)) for f in CUDA_PUSH_FORMS])
@pytest.mark.parametrize("rows_out", [False, True])
def test_cuda_push_adagrad_matches_plain(cuda_device, form, rows_out):
    """The fused kernel over several tiles of uniques, one key's run of 700
    occurrences (past the occurrences either design stages a tile), in both
    write modes, at each of CUDA_PUSH_FORMS: bit-equal to its plain
    version."""
    layout, args, n = _form_push_args(*form, seed=5, K=3000, n_pad=200,
                                      hot=700, n_keys=900, cap=1024)
    conf = SparseOptimizerConfig(**_conf_kwargs(3.0))
    s, g, p, o, u = [a.to(cuda_device) for a in args]
    s_k, s_p = s.clone(), s.clone()
    name = pk.push_form(layout)
    before = pk.launch_counts()[name]
    got = pk.push_adagrad(s_k, g, p, o, u, n, 99, layout, conf, rows_out)
    torch.cuda.synchronize()
    assert pk.launch_counts()[name] == before + 1
    want = pk.push_adagrad_fused_plain(s_p, g, p, o, u, n, 99, layout, conf,
                                       rows_out)
    assert torch.equal(s_k.view(torch.int16), s_p.view(torch.int16))
    if rows_out:
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def _dense_blocked_case(permuted):
    """blocked_write at a step of 8 flagship batches' density: 410,407
    sorted rows of a 2^20 x 17 slab bucketized in 1024 slots of 1024 lanes
    (blocked_layout: one consecutive run of sources a tile), or the same
    lanes with their sources permuted (no run)."""
    rng = np.random.RandomState(41)
    C, W, B = 1 << 20, ValueLayout(D).width, 1024
    uids = np.sort(rng.choice(C - 1, 410407, replace=False)).astype(np.int32)
    row_map, blk_idx = blocked_layout(torch.from_numpy(uids), C, B)
    row_map = row_map.numpy()
    if permuted:
        placed = row_map >= 0
        row_map[placed] = rng.permutation(row_map[placed])
    return (rng.rand(C, W).astype(np.float32),
            rng.rand(len(uids), W).astype(np.float32), row_map,
            blk_idx.numpy(), 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["blocked_layout", "dense", "dense_permuted"]
                         + sorted(BLOCKED_CASES))
def test_cuda_blocked_write_matches_plain(cuda_device, case):
    """The kernel on a bucketized batch, at the density of a step of 8
    flagship batches (sources one run a tile, and permuted) and on the edge
    cases, the row map one entry into its buffer where the case asks (not
    16-byte aligned), in the case's slot order and reversed: bit-equal to
    its plain version."""
    if case.startswith("dense"):
        slab, new_rows, row_map, blk_idx, offset = _dense_blocked_case(
            case == "dense_permuted")
    elif case == "blocked_layout":
        slab, uids, new_rows, B = _blocked_case()
        row_map, blk_idx = blocked_layout(torch.from_numpy(uids),
                                          slab.shape[0], B)
        row_map, blk_idx, offset = row_map.numpy(), blk_idx.numpy(), 0
    else:
        slab, new_rows, row_map, blk_idx, offset = BLOCKED_CASES[case]
    s0 = torch.from_numpy(slab).to(cuda_device)
    nr = torch.from_numpy(new_rows).to(cuda_device)
    for flip in (slice(None), slice(None, None, -1)):
        flat = torch.empty(row_map.size + offset, dtype=torch.int32,
                           device=cuda_device)
        rm = flat[offset:].view(row_map.shape)
        rm.copy_(torch.from_numpy(row_map[flip].copy()))
        bi = torch.from_numpy(blk_idx[flip].copy()).to(cuda_device)
        s1, s2 = s0.clone(), s0.clone()
        before = pk.blocked_write.launches
        pk.blocked_write(s1, nr, rm, bi)
        torch.cuda.synchronize()
        assert pk.blocked_write.launches == before + 1
        pk.blocked_write_plain(s2, nr, rm, bi)
        assert torch.equal(s1.view(torch.int32), s2.view(torch.int32))
