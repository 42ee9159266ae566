"""The bf16 slab diet and dense bf16 in the port, against the JAX package.

``slab_embed_dtype="bfloat16"`` stores the device slab as 2-byte columns:
bf16 weights (embed_w, embedx) and (hi, lo) halves of every other f32
column. The port holds those bits in an int16 tensor; numpy and the
reference see them as uint16. Tolerances, each with its reason:

  * the codec (torch and numpy, both directions), the 2-byte gather (raw
    and decoding), the 2-byte blocked write and the pass table's moves of
    rows: bit-exact, NaN payloads included (integer work and copies);
  * the bf16 push: bit-exact to the reference's numpy codec around the
    port's f32 per-row update (which tests/test_torch_push_kernels.py holds
    to the Pallas kernel); against the reference's whole decode ->
    pallas_apply_push (interpreted) -> encode_slab_rows_np, the integer
    columns, created embedx and pass-through rows are exact and the rest
    within rtol 1e-6 as in the f32 push's test (XLA takes some f32
    operations of the update in another order), one bf16 step at most on
    a weight column, where such a last-bit f32 difference lands on a
    rounding boundary;
  * two bf16 passes against the JAX trainer (use_pallas_push): loss rtol
    1e-4 and AUC 1e-4 absolute, as the f32 path (measured: 9e-8 and 0);
    host rows with the integer columns exact, weights within one bf16
    step (2^-7 relative) and the stats rtol 1e-4;
  * dense bf16: the forward's logits exact under compute_dtype bfloat16
    (the same bf16 operations), rtol 1e-5 under matmul_dtype bfloat16
    (f32 sums of exact products in another order); two passes loss rtol
    1e-4, AUC 1e-4 absolute with f32 compute and 2e-3 with bf16 compute
    (measured 1.2e-3: XLA and ATen sum a bias gradient's bf16 cotangents
    with other roundings, and bf16 logits tie, so the AUC moves by a few
    pairs at this 192-instance size).

The port alone: scatter and blocked, per step and chunked, incremental and
full rebuild are bit-identical under bf16; a bf16 day resumes bit for bit;
the journal's ROWS records are the decoded f32 rows the store got. Legs
that need the card carry the ``cuda`` marker and skip here.
"""

import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from paddlebox_tpu.config import flags as jflags
from paddlebox_tpu.config.configs import (SparseOptimizerConfig as JSparse,
                                          TableConfig as JTable,
                                          TrainerConfig as JTrainerCfg)
from paddlebox_tpu.data.dataset import BoxDataset as JDataset
from paddlebox_tpu.data.generator import write_synthetic_ctr_files
from paddlebox_tpu.embedding import accessor as ja
from paddlebox_tpu.embedding.pallas_push import (pallas_apply_push,
                                                 pallas_blocked_write)
from paddlebox_tpu.embedding.pass_table import PassTable as JPassTable
from paddlebox_tpu.models.base import ModelSpec as JSpec
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.ops import sparse as jsparse
from paddlebox_tpu.train.trainer import (BoxTrainer as JTrainer,
                                         apply_mixed_precision,
                                         mixed_logits_to_f32)

from paddlebox_tpu_torch import convert, edge_cases
from paddlebox_tpu_torch.config.configs import (CheckpointConfig,
                                                DataFeedConfig, SlotConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.config.flags import (DtypeFlags, PassFlags,
                                              PushFlags, StageFlags)
from paddlebox_tpu_torch.convert import params_from_jax
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.embedding import push_kernels as pk
from paddlebox_tpu_torch.embedding.accessor import PushLayout, ValueLayout
from paddlebox_tpu_torch.embedding.pass_table import (PassTable, dedup_ids,
                                                      segment_offsets)
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.native import kernel_args
from paddlebox_tpu_torch.ops import row_kernels as rk
from paddlebox_tpu_torch.ops import sparse
from paddlebox_tpu_torch.train import checkpoint as pckpt
from paddlebox_tpu_torch.train import flagship
from paddlebox_tpu_torch.train.trainer import BoxTrainer, model_logits
from paddlebox_tpu_torch.utils import journal_format as jf

BF16 = "bfloat16"
D = 8
NUM_SLOTS = 4
BATCH = 32
MAX_LEN = 3
HIDDEN = (16, 8)
CAP = 1024
LR = 5e-3
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
INT_COLS = [acc.SLOT, acc.SHOW, acc.CLICK, acc.UNSEEN_DAYS, acc.MF_SIZE]
# the f32 bit patterns the codec must round or carry exactly: RNE ties
# (round down to even, round up to even), the largest finite value (rounds
# to inf), +-0, the smallest and largest subnormals, +-inf, NaNs with
# payloads of either sign (quieted to hi | 0x40 by the numpy twin), the
# all-ones NaN, a NaN whose rounding would carry into the sign
SPECIAL_BITS = np.array(
    [0x3F808000, 0x3F818000, 0x7F7FFFFF, 0x00000000, 0x80000000,
     0x00000001, 0x007FFFFF, 0x80000001, 0x7F800000, 0xFF800000,
     0xFFC12345, 0x7F812345, 0x7FC00000, 0xFFFFFFFF, 0xFFFF8000,
     0x7FFF8000, 0x3F7FFFFF, 0x4049FFFF], np.uint32)
# NaNs with payloads, negative and positive: the reference's encoders
# disagree on them (the numpy twin keeps the payload, XLA does not)
NAN_PAYLOADS = np.array([0xFFC12345, 0x7F812345], np.uint32)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint32)


def _u16(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().view(np.uint16)


def _i16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True).view(np.int16))


def _layouts(d):
    return (ValueLayout(d, embed_dtype=BF16),
            ja.ValueLayout(d, "adagrad", embed_dtype=BF16))


def _codec_rows(d, seed, n=600):
    """f32 rows of a layout's width: every SPECIAL_BITS pattern in every
    column, then random bits."""
    width = ValueLayout(d).width
    bits = np.random.RandomState(seed).randint(
        0, 1 << 32, (n, width), dtype=np.uint64).astype(np.uint32)
    bits[:SPECIAL_BITS.size] = SPECIAL_BITS[:, None]
    return bits.view(np.float32)


# ------------------------------------------------------------------ codec

@pytest.mark.parametrize("d", [2, 4, 8, 16, 32, 64])
def test_codec_layout_matches_reference(d):
    """device_width, bytes and the column plan equal the reference's; the
    push kernel's hard-coded device columns (csrc/push_adagrad.cu hi_pos:
    17 + D columns) are the plan's."""
    pl_, jl = _layouts(d)
    assert pl_.device_width == jl.device_width == 17 + d
    assert pl_.device_bytes_per_row == jl.device_bytes_per_row
    assert pl_.device_dtype == torch.int16
    assert jl.device_dtype == np.uint16
    rows = _codec_rows(d, seed=1)[:50]
    np.testing.assert_array_equal(acc.slab_rows_np(rows, pl_).view(np.uint16),
                                  ja.encode_slab_rows_np(rows, jl))
    plan, jplan = acc.slab_codec_plan(pl_), ja.slab_codec_plan(jl)
    for f in ("bf16_cols", "kinds", "srcs", "hi_pos", "lo_pos"):
        np.testing.assert_array_equal(getattr(plan, f), getattr(jplan, f))
    xw = pl_.embedx_w
    hi = [2 * c if c < acc.EMBED_W else 12 if c == acc.EMBED_W else
          13 if c == pl_.embed_state else 15 + (c - xw) if c < xw + d
          else 15 + d for c in range(pl_.width)]
    np.testing.assert_array_equal(plan.hi_pos, hi)
    split = ~plan.bf16_cols
    np.testing.assert_array_equal(plan.lo_pos[split], plan.hi_pos[split] + 1)
    f32 = ValueLayout(d)
    assert (f32.device_width, f32.device_dtype) == (f32.width, torch.float32)
    assert f32.device_bytes_per_row == 4 * f32.width
    assert acc.slab_rows_np(rows, f32) is rows
    with pytest.raises(ValueError):
        ValueLayout(d, embed_dtype="float16")


@pytest.mark.parametrize("d", [2, 8, 64])
def test_codec_bit_exact_to_numpy_twins(d):
    """Both directions, torch and numpy, against the reference's numpy
    twins: RNE ties, subnormals, +-0, +-inf, NaN payloads, random bits."""
    pl_, jl = _layouts(d)
    rows = _codec_rows(d, seed=d)
    want = ja.encode_slab_rows_np(rows, jl)
    np.testing.assert_array_equal(acc.encode_slab_rows_np(rows, pl_), want)
    np.testing.assert_array_equal(
        _u16(acc.encode_slab_rows(torch.from_numpy(rows.copy()), pl_)),
        want)
    # decode of the encoded rows and of arbitrary 2-byte bits
    dev = np.concatenate([want, np.random.RandomState(d + 1).randint(
        0, 1 << 16, (300, pl_.device_width)).astype(np.uint16)])
    dec = ja.decode_slab_rows_np(dev, jl)
    np.testing.assert_array_equal(_bits(acc.decode_slab_rows_np(dev, pl_)),
                                  _bits(dec))
    np.testing.assert_array_equal(
        _bits(acc.decode_slab_rows(_i16(dev), pl_).numpy()), _bits(dec))
    # a batch dimension in front, as the chunk's flat rows have it
    np.testing.assert_array_equal(
        _u16(acc.encode_slab_rows(torch.from_numpy(
            rows[:300].reshape(3, 100, -1).copy()), pl_)),
        want[:300].reshape(3, 100, -1))


@pytest.mark.parametrize("d", [2, 8, 64])
def test_codec_matches_jnp_encoder_without_nan(d):
    """The device push's jnp encoder and decoder (XLA's convert) agree
    with the port's on every pattern but NaN."""
    pl_, jl = _layouts(d)
    rows = _codec_rows(d, seed=10 + d)
    rows = np.where(np.isnan(rows), np.float32(1.5), rows)
    want = np.asarray(ja.encode_slab_rows(jnp.asarray(rows), jl))
    got = _u16(acc.encode_slab_rows(torch.from_numpy(rows), pl_))
    np.testing.assert_array_equal(got, want)
    dec = np.asarray(ja.decode_slab_rows(jnp.asarray(want), jl))
    np.testing.assert_array_equal(
        _bits(acc.decode_slab_rows(_i16(want), pl_).numpy()), _bits(dec))


def test_codec_nan_is_the_numpy_twins_not_a_library_conversion():
    """The reference's two encoders disagree on NaN: its numpy twin keeps
    the payload's high bits and quiets (hi | 0x40), its jnp encoder (XLA's
    convert) gives the canonical NaN. torch's own bf16 conversion gives a
    third answer. The port encodes as the numpy twin, which writes every
    host row that reaches the slab."""
    pl_, jl = _layouts(D)
    rows = np.zeros((2, pl_.width), np.float32)
    rows[:, acc.EMBED_W] = NAN_PAYLOADS.view(np.float32)
    col = acc.slab_codec_plan(pl_).hi_pos[acc.EMBED_W]
    twin = ja.encode_slab_rows_np(rows, jl)[:, col]
    np.testing.assert_array_equal(twin, [0xFFC1, 0x7FC1])
    np.testing.assert_array_equal(
        np.asarray(ja.encode_slab_rows(jnp.asarray(rows), jl))[:, col],
        [0xFFC0, 0x7FC0])
    port = _u16(acc.encode_slab_rows(torch.from_numpy(rows), pl_))[:, col]
    np.testing.assert_array_equal(port, twin)
    np.testing.assert_array_equal(acc.encode_slab_rows_np(rows, pl_)[:, col],
                                  twin)
    lib = _u16(torch.from_numpy(rows[:, acc.EMBED_W]).to(torch.bfloat16)
               .view(torch.int16))
    assert not np.array_equal(lib, twin)


def test_codec_round_trip_is_the_identity_on_encoded_rows():
    """Decode then encode gives back every row the codec wrote (a
    pass-through row keeps its bits through the push), and the split
    columns decode to their exact f32 bits; an f32 layout's codec is the
    identity."""
    pl_, _ = _layouts(D)
    rows = _codec_rows(D, seed=3)
    enc = acc.encode_slab_rows_np(rows, pl_)
    dec = acc.decode_slab_rows_np(enc, pl_)
    np.testing.assert_array_equal(acc.encode_slab_rows_np(dec, pl_), enc)
    np.testing.assert_array_equal(
        _u16(acc.encode_slab_rows(acc.decode_slab_rows(_i16(enc), pl_),
                                  pl_)), enc)
    split = ~acc.slab_codec_plan(pl_).bf16_cols
    np.testing.assert_array_equal(_bits(dec[:, split]), _bits(rows[:, split]))
    f32 = ValueLayout(D)
    t = torch.from_numpy(rows)
    assert acc.encode_slab_rows(t, f32) is t
    assert acc.decode_slab_rows(t, f32) is t


# ------------------------------------------------- the 2-byte gather

@pytest.fixture(scope="module")
def probe():
    """tools/pallas_rate_probe.py, imported on the CPU (it reads its JAX
    platform from sys.argv[1] at import)."""
    saved = sys.argv
    sys.argv = ["pallas_rate_probe.py", "cpu"]
    try:
        from tools import pallas_rate_probe
    finally:
        sys.argv = saved
    return pallas_rate_probe


@pytest.mark.parametrize("W", [19, 25, 81])
def test_plain_gather_2byte_matches_pallas_gather_kernel(probe, W):
    """The probe's Pallas gather, interpreted, over a uint16 slab of the
    bf16 device widths: the plain version on int16 moves the same bits."""
    rng = np.random.RandomState(W)
    C, K, rps = 4096, 64, 8
    slab = rng.randint(0, 1 << 16, (C, W)).astype(np.uint16)
    idx = np.sort(rng.choice(C - 1, K, replace=False)).astype(np.int32)
    idx[1::2] |= 1   # odd rows: starts that are not 4-byte aligned
    want = pl.pallas_call(
        functools.partial(probe.gather_kernel, rows_per_step=rps),
        out_shape=jax.ShapeDtypeStruct((K, W), jnp.uint16),
        grid=(K // rps,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((rps, W), lambda g: (g, 0)),
        interpret=True)(jnp.asarray(idx), jnp.asarray(slab))
    got = rk.gather_rows_plain(_i16(slab), torch.from_numpy(idx))
    np.testing.assert_array_equal(_u16(got), np.asarray(want))


GATHER_CASES_2 = edge_cases.gather_edge_cases_2byte()


@pytest.mark.parametrize("case", sorted(GATHER_CASES_2))
def test_plain_gather_2byte_edge_cases_match_jax(case):
    """K around the kernel's tile for the bf16 widths 19, 25 and 81 (and
    26 and 256), ids past the source, a source one element into its
    buffer: the plain version and the wrapper on the CPU are JAX's clamped
    slab[ids], bit for bit; where the width is a layout's, the decoding
    gather is the reference's gather_slab_rows."""
    flat, offset, C, W, ids = GATHER_CASES_2[case]
    src = edge_cases.gather_source(flat, offset, C, W)
    want = np.asarray(jnp.asarray(src)[jnp.asarray(ids)])
    s, i = _i16(src), torch.from_numpy(ids)
    np.testing.assert_array_equal(_u16(rk.gather_rows_plain(s, i)), want)
    np.testing.assert_array_equal(_u16(rk.gather_rows(s, i)), want)
    out = torch.empty((ids.size, W), dtype=torch.int16)
    assert rk.gather_rows(s, i, out=out) is out
    np.testing.assert_array_equal(_u16(out), want)
    if W - 17 in (2, 8, 64):
        pl_, jl = _layouts(W - 17)
        dec = np.asarray(jsparse.gather_slab_rows(
            jnp.asarray(src), jnp.asarray(ids), jl))
        for got in (rk.gather_rows_decode_plain(s, i, pl_),
                    rk.gather_rows_decode(s, i, pl_),
                    sparse.gather_slab_rows(s, i, pl_)):
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(dec))


# ------------------------------------------------- the 2-byte blocked write

BLOCKED_CASES_2 = edge_cases.blocked_edge_cases_2byte()


def _offset_view(a: np.ndarray, offset: int, device="cpu") -> torch.Tensor:
    """``a`` (as int16 bits where it is uint16) on ``device``, ``offset``
    elements into a larger buffer: a contiguous view the wrappers take."""
    t = _i16(a) if a.dtype == np.uint16 else torch.from_numpy(a.copy())
    flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=device)
    view = flat[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("case", sorted(BLOCKED_CASES_2))
def test_plain_blocked_write_2byte_edge_cases_match_pallas(case):
    """The interpreted Pallas blocked write on the uint16 slab (sentinel
    slots ordered before their block's real write, as its grid needs):
    the plain version and the wrapper on the CPU place the same bits, on
    the slab and new_rows at the case's data offsets too."""
    slab, new_rows, row_map, blk_idx, _, offs = BLOCKED_CASES_2[case]
    NB, B = row_map.shape
    tiles = new_rows[np.clip(row_map, 0, len(new_rows) - 1)]
    want = np.asarray(pallas_blocked_write(
        jnp.asarray(slab), jnp.asarray(tiles), jnp.asarray(row_map),
        jnp.asarray(blk_idx), interpret=True))
    assert want.dtype == np.uint16
    expect = slab.copy()
    slots, lanes = np.nonzero(row_map >= 0)
    expect[blk_idx[slots].astype(np.int64) * B + lanes] = \
        new_rows[row_map[slots, lanes]]
    for fn in (pk.blocked_write_plain, pk.blocked_write):
        for so, ro in {(0, 0), offs}:
            got = _offset_view(slab, so)
            fn(got, _offset_view(new_rows, ro), torch.from_numpy(row_map),
               torch.from_numpy(blk_idx))
            np.testing.assert_array_equal(_u16(got), want)
            np.testing.assert_array_equal(_u16(got), expect)


# ------------------------------------------------------- the bf16 push

def _conf_kwargs(create_thres):
    return dict(mf_create_thresholds=create_thres, mf_initial_range=1e-3,
                feature_learning_rate=0.1, mf_learning_rate=0.05,
                nodeid_slot=3)


def _push_rows(n, seed, with_mf):
    """f32 value rows (zero-show pushes mixed in, slot 3 the nodeid lr),
    merged push rows and distinct slab ids."""
    layout, push = ValueLayout(D), PushLayout(D)
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
    grads[:, push.SHOW] = rng.randint(0, 4, n)
    grads[:, push.CLICK] = np.minimum(grads[:, push.SHOW],
                                      rng.randint(0, 2, n))
    grads[:, push.EMBED_G] = rng.randn(n) * 0.2
    grads[:, push.embedx_g:push.embedx_g + D] = rng.randn(n, D) * 0.2
    uids = np.sort(rng.permutation(4096)[:n]).astype(np.int32)
    return rows, grads, uids


def _one_occurrence_push(rows, grads, uids, layout, cap=4096):
    """(slab, grads, perm, offsets, uids, n): a bf16 slab holding the
    encoded rows at their uids, one occurrence per unique."""
    n = uids.size
    slab = torch.zeros((cap, layout.device_width), dtype=torch.int16)
    slab[torch.from_numpy(uids).long()] = _i16(
        acc.encode_slab_rows_np(rows, layout))
    ar = torch.arange(n + 1, dtype=torch.int32)
    return (slab, torch.from_numpy(grads), ar[:n].clone(), ar,
            torch.from_numpy(uids), n)


@pytest.mark.parametrize("case", ["no_create", "create", "mixed"])
def test_plain_bf16_push_matches_reference(case):
    thres = {"no_create": 1e9, "create": 0.0, "mixed": 3.0}[case]
    rows, grads, uids = _push_rows(
        300, seed={"no_create": 0, "create": 3, "mixed": 5}[case],
        with_mf=case != "create")
    pl_, jl = _layouts(D)
    conf = SparseOptimizerConfig(**_conf_kwargs(thres))
    seed = 1234567
    slab, g, p, o, u, n = _one_occurrence_push(rows, grads, uids, pl_)
    dev = acc.encode_slab_rows_np(rows, pl_)
    dec = ja.decode_slab_rows_np(dev, jl)
    got = _u16(pk.push_adagrad(slab, g, p, o, u, n, seed, pl_, conf,
                               rows_out=True))
    # (1) bit-exact: the reference's numpy codec around the port's f32
    # per-row update
    mine = ja.encode_slab_rows_np(pk.push_adagrad_plain(
        torch.from_numpy(dec), g, u, seed, ValueLayout(D), conf).numpy(),
        jl)
    np.testing.assert_array_equal(got, mine)
    # in place: the same rows at their uids, nothing else written
    inplace = slab.clone()
    assert pk.push_adagrad(inplace, g, p, o, u, n, seed, pl_, conf) is None
    np.testing.assert_array_equal(_u16(inplace)[uids], got)
    keep = np.ones(slab.shape[0], bool)
    keep[uids] = False
    np.testing.assert_array_equal(_u16(inplace)[keep], _u16(slab)[keep])
    # (2) the reference's decode -> pallas_apply_push -> encode
    want = ja.encode_slab_rows_np(np.asarray(pallas_apply_push(
        jnp.asarray(dec), jnp.asarray(grads), seed,
        ja.ValueLayout(D, "adagrad"), JSparse(**_conf_kwargs(thres)),
        interpret=True, row_ids=jnp.asarray(uids))), jl)
    active = grads[:, PushLayout(D).SHOW] > 0
    assert active.any() and (~active).any()
    np.testing.assert_array_equal(got[~active], dev[~active])
    np.testing.assert_array_equal(want[~active], dev[~active])
    gd = ja.decode_slab_rows_np(got, jl)
    wd = ja.decode_slab_rows_np(want, jl)
    np.testing.assert_array_equal(gd[:, INT_COLS], wd[:, INT_COLS])
    created = active & (rows[:, acc.MF_SIZE] == 0) & (gd[:, acc.MF_SIZE] == D)
    if case != "no_create":
        assert created.any()
    xw = pl_.embedx_w
    np.testing.assert_array_equal(_bits(gd[created, xw:xw + D]),
                                  _bits(wd[created, xw:xw + D]))
    bf = acc.slab_codec_plan(pl_).bf16_cols
    np.testing.assert_allclose(gd[:, ~bf], wd[:, ~bf], rtol=1e-6, atol=1e-9)
    step = np.abs(wd[:, bf]) * 2.0 ** -7 + 1e-30
    assert (np.abs(gd[:, bf] - wd[:, bf]) <= step).all()


def test_bf16_push_of_a_batch_with_a_hot_key_and_padding():
    """The fused push on a step's dedup (a hot key, the padding tail on the
    trash row): the plain version's bf16 form is the f32 form between the
    numpy codec, pass-through rows and the rows of other keys keep their
    bits."""
    pl_ = ValueLayout(D, embed_dtype=BF16)
    rng = np.random.RandomState(4)
    cap, K, n_pad = 512, 300, 40
    ids = np.full(K, cap - 1, np.int32)
    ids[:K - n_pad] = rng.permutation(np.concatenate(
        [np.full(60, 5), rng.randint(6, 200, K - n_pad - 60)]))
    rows, occ, _ = _push_rows(cap, 6, with_mf=True)
    occ = occ[:K].copy()
    occ[K - n_pad:] = 0.0
    uids, perm, inv, n = dedup_ids(ids, cap)
    args = [torch.from_numpy(a) for a in (occ, perm, segment_offsets(
        inv, K - n_pad), uids)]
    conf = SparseOptimizerConfig(**_conf_kwargs(2.0))
    enc = acc.encode_slab_rows_np(rows, pl_)
    s16 = _i16(enc.copy())
    pk.push_adagrad(s16, *args, n, 77, pl_, conf)
    s32 = torch.from_numpy(acc.decode_slab_rows_np(enc, pl_))
    pk.push_adagrad(s32, *args, n, 77, ValueLayout(D), conf)
    np.testing.assert_array_equal(
        _u16(s16), acc.encode_slab_rows_np(s32.numpy(), pl_))
    untouched = np.setdiff1d(np.arange(cap), uids[:n])
    np.testing.assert_array_equal(_u16(s16)[untouched], enc[untouched])


def test_wrappers_refuse_mismatched_slabs_and_never_fall_back(monkeypatch):
    """A slab of the wrong dtype or width raises; a tensor the kernel
    should take (use_kernel True) goes to the kernel's build, which raises
    here for want of nvcc, never to a plain version."""
    pl_ = ValueLayout(D, embed_dtype=BF16)
    rows, grads, uids = _push_rows(20, 1, True)
    slab, g, p, o, u, n = _one_occurrence_push(rows, grads, uids, pl_)
    conf = SparseOptimizerConfig()
    with pytest.raises(TypeError):
        pk.push_adagrad(slab.float(), g, p, o, u, n, 1, pl_, conf)
    with pytest.raises(ValueError):
        pk.push_adagrad(slab[:, :-1].contiguous(), g, p, o, u, n, 1, pl_,
                        conf)
    with pytest.raises(TypeError):
        pk.push_adagrad(slab, g, p, o, u, n, 1, ValueLayout(D), conf)
    with pytest.raises(ValueError):
        rk.gather_rows_decode(slab.float(), u, pl_)
    with pytest.raises(TypeError):
        rk.gather_rows(slab.to(torch.int32), u)
    with pytest.raises(TypeError):
        pk.blocked_write(slab, slab.float(), torch.zeros((1, 8), dtype=
                         torch.int32), torch.zeros(1, dtype=torch.int32))

    def no_nvcc(name):
        raise RuntimeError("nvcc not found")

    import paddlebox_tpu_torch.native.build as build
    for mod in (rk, pk):
        monkeypatch.setattr(mod, "use_kernel", lambda dev: True)
    monkeypatch.setattr(build, "load_kernel", no_nvcc)
    rk.reset_launch_counts()
    pk.reset_launch_counts()
    with pytest.raises(RuntimeError, match="nvcc"):
        rk.gather_rows(slab, u)
    with pytest.raises(RuntimeError, match="nvcc"):
        rk.gather_rows_decode(slab, u, pl_)
    with pytest.raises(RuntimeError, match="nvcc"):
        pk.push_adagrad(slab, g, p, o, u, n, 1, pl_, conf)
    with pytest.raises(RuntimeError, match="nvcc"):
        pk.blocked_write(slab, slab[:4].clone(), torch.zeros(
            (1, 8), dtype=torch.int32), torch.zeros(1, dtype=torch.int32))
    assert not any(rk.launch_counts().values())
    assert not any(pk.launch_counts().values())
    assert kernel_args.use_kernel(torch.device("cpu")) is False


# --------------------------------------------------- the slice vs the JAX

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_bf16_data")
    files, feed = write_synthetic_ctr_files(
        str(out), num_files=2, lines_per_file=96, num_slots=NUM_SLOTS,
        vocab_per_slot=60, max_len=MAX_LEN, seed=7)
    jfeed = type(feed)(slots=feed.slots, batch_size=BATCH)
    pfeed = DataFeedConfig(
        slots=tuple(SlotConfig(s.name, s.type, s.is_used, s.max_len)
                    for s in feed.slots), batch_size=BATCH)
    return files, jfeed, pfeed


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX trainer with use_pallas_push, its kernel interpreted."""
    import paddlebox_tpu.embedding.pallas_push as pp
    jflags.set_flag("use_pallas_push", True)
    monkeypatch.setattr(pp, "pallas_apply_push",
                        functools.partial(pp.pallas_apply_push,
                                          interpret=True))


def _jax_trainer(jfeed, slab="float32", compute="float32",
                 matmul="float32"):
    jflags.set_flag("slab_embed_dtype", slab)
    jflags.set_flag("matmul_dtype", matmul)
    table = JTable(embedx_dim=D, pass_capacity=CAP, optimizer=JSparse(**OPT))
    model = JDeepFM(JSpec(num_slots=NUM_SLOTS, slot_dim=3 + D), hidden=HIDDEN)
    return JTrainer(model, table, jfeed,
                    JTrainerCfg(dense_lr=LR, compute_dtype=compute), seed=0)


def _port_trainer(pfeed, jparams, slab="float32", compute="float32",
                  matmul="float32", push_write="scatter", seed=0,
                  scan_chunk=8):
    table = TableConfig(embedx_dim=D, pass_capacity=CAP,
                        optimizer=SparseOptimizerConfig(**OPT))
    model = DeepFM(ModelSpec(num_slots=NUM_SLOTS, slot_dim=3 + D),
                   hidden=HIDDEN)
    model.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}))
    return BoxTrainer(model, table, pfeed,
                      TrainerConfig(dense_lr=LR, compute_dtype=compute,
                                    scan_chunk=scan_chunk),
                      seed=seed, flags=PushFlags(push_write, 64),
                      device="cpu", dtype_flags=DtypeFlags(slab, matmul))


def _jax_pass_seeds(key, n_steps):
    key, prng = jax.random.split(key)
    seeds = []
    for _ in range(n_steps):
        prng, sub = jax.random.split(prng)
        seeds.append(int(jax.random.randint(sub, (), 0,
                                            jnp.int32(2**31 - 1))))
    return seeds, key


def _two_passes(trainer, dataset, seeds=None):
    out = []
    for p in range(2):
        if seeds is not None:
            trainer.seed_fn = iter(seeds[p]).__next__
        res = trainer.train_pass(dataset)
        out.append((res["loss"], trainer.metrics.get_metric_msg("auc")["auc"]))
    return out


def _run_both(data, slab, compute, matmul):
    files, jfeed, pfeed = data
    jt = _jax_trainer(jfeed, slab, compute, matmul)
    pt = _port_trainer(pfeed, jt.params, slab, compute, matmul)
    jds = JDataset(jfeed, read_threads=1, columnar=False)
    pds = BoxDataset(pfeed)
    for t, ds in ((jt, jds), (pt, pds)):
        t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
        ds.set_filelist(files)
    n_steps = (2 * 96 + BATCH - 1) // BATCH
    key, seeds = jax.random.PRNGKey(0), []
    for _ in range(2):
        s, key = _jax_pass_seeds(key, n_steps)
        seeds.append(s)
    want = _two_passes(jt, jds)
    got = _two_passes(pt, pds, seeds)
    return jt, pt, got, want


def _assert_host_rows(got, want, layout):
    """Integer columns exact; bf16 weights within one bf16 step; the
    stats rtol 1e-4."""
    np.testing.assert_array_equal(got[:, INT_COLS], want[:, INT_COLS])
    bf = acc.slab_codec_plan(layout).bf16_cols
    assert (np.abs(got[:, bf] - want[:, bf])
            <= np.abs(want[:, bf]) * 2.0 ** -7 + 1e-30).all()
    np.testing.assert_allclose(got[:, ~bf], want[:, ~bf], rtol=1e-4,
                               atol=1e-7)


def test_two_bf16_passes_match_jax(data, pallas_interpret):
    jt, pt, got, want = _run_both(data, BF16, "float32", "float32")
    for (gl, ga), (wl, wa) in zip(got, want):
        np.testing.assert_allclose(gl, wl, rtol=1e-4)
        assert abs(ga - wa) <= 1e-4, (ga, wa)
    layout = pt.table.layout
    assert layout.bf16 and pt.table.slab.dtype == torch.int16
    assert pt.table.slab.shape == (CAP, layout.device_width)
    assert np.asarray(jt.table.slab).dtype == np.uint16
    keys = pt.table.pass_keys
    _assert_host_rows(pt.table.store.lookup(keys),
                      jt.table.store.lookup(keys), layout)
    # the resident slabs: the same integer columns, bit for bit
    n = keys.size
    ps = acc.decode_slab_rows_np(_u16(pt.table.slab)[:n], layout)
    js = ja.decode_slab_rows_np(np.asarray(jt.table.slab)[:n],
                                ja.ValueLayout(D, embed_dtype=BF16))
    _assert_host_rows(ps, js, layout)


@pytest.mark.parametrize("compute,matmul,slab", [
    ("bfloat16", "float32", "float32"), ("float32", "bfloat16", "float32"),
    ("bfloat16", "bfloat16", BF16)], ids=["compute", "matmul", "all_bf16"])
def test_dense_bf16_two_passes_match_jax(data, pallas_interpret, compute,
                                         matmul, slab):
    _, _, got, want = _run_both(data, slab, compute, matmul)
    auc_tol = 2e-3 if compute == "bfloat16" else 1e-4
    for (gl, ga), (wl, wa) in zip(got, want):
        np.testing.assert_allclose(gl, wl, rtol=1e-4)
        assert abs(ga - wa) <= auc_tol, (ga, wa)


@pytest.mark.parametrize("compute,matmul", [
    ("bfloat16", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "bfloat16")])
def test_dense_bf16_forward_matches_jax(compute, matmul):
    """apply_mixed_precision / layers.matmul against model_logits on the
    same params and pooled input; gradients reach the f32 masters."""
    jflags.set_flag("matmul_dtype", matmul)
    S = 8
    jm = JDeepFM(JSpec(num_slots=S, slot_dim=3 + D), hidden=(64, 32))
    params = jm.init(jax.random.PRNGKey(1))
    pooled = np.random.RandomState(0).randn(256, S, 3 + D).astype(np.float32)

    def jax_logits(p, x):
        if compute == "bfloat16":
            p, x, _ = apply_mixed_precision(p, x, None, jnp.bfloat16)
        return mixed_logits_to_f32(jm.apply(p, x))

    want = np.asarray(jax_logits(params, jnp.asarray(pooled)))
    m = DeepFM(ModelSpec(S, 3 + D), hidden=(64, 32))
    m.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in params.items()}))
    m.matmul_dtype = matmul
    got = model_logits(m, torch.from_numpy(pooled), compute)
    assert got.dtype == torch.float32
    if matmul == "float32":
        np.testing.assert_array_equal(got.detach().numpy(), want)
    else:
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-6)
    got.sum().backward()
    for name, p in m.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        assert torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0, name


def test_dtype_switches_refuse_other_values():
    with pytest.raises(ValueError):
        TrainerConfig(compute_dtype="float16")
    with pytest.raises(ValueError):
        DtypeFlags(slab_embed_dtype="float16")
    with pytest.raises(ValueError):
        DtypeFlags(matmul_dtype="int8")

    class NoDtype(torch.nn.Module):
        def forward(self, x):
            return x.sum((1, 2))

    table = TableConfig(embedx_dim=D, pass_capacity=CAP)
    feed = DataFeedConfig(slots=(SlotConfig("s0"),), batch_size=4)
    with pytest.raises(ValueError, match="matmul_dtype"):
        BoxTrainer(NoDtype(), table, feed, device="cpu",
                   dtype_flags=DtypeFlags(matmul_dtype=BF16))


# ------------------------------------------------------- the port alone

def _small_cfg(**kw):
    return dataclasses.replace(flagship.FLAGSHIP_BF16, **{
        **dict(num_slots=NUM_SLOTS, batch=BATCH, max_len=MAX_LEN,
               hidden=HIDDEN, capacity=CAP, num_files=2, lines_per_file=80,
               vocab_per_slot=60, data_seed=7), **kw})


def _sorted_store(table):
    k, v = table.store.state_items()
    order = np.argsort(k)
    return k[order], v[order]


def _assert_stores_equal(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(_bits(a[1]), _bits(b[1]))


def _flagship_run(tmp_path, cfg, passes=2, **kw):
    files, feed = flagship.write_files(str(tmp_path), cfg)
    t, ds = flagship.build_trainer(files, feed, cfg, device="cpu", **kw)
    out = []
    for _ in range(passes):
        res = t.train_pass(ds)
        out.append((res["loss"], t.metrics.get_metric_msg("auc")["auc"]))
    return t, out


def test_bf16_scatter_blocked_chunked_and_rebuild_are_bit_identical(
        tmp_path):
    """FLAGSHIP_BF16 at a narrow replace: scatter in chunks (the default),
    blocked, one step at a time, full rebuilds, grouped staging and
    chunk-synchronous chunks of one batch all give the same losses, AUC
    and host rows, bit for bit; every slab is the int16 one."""
    cfg = _small_cfg()
    base, ref = _flagship_run(tmp_path / "a", cfg, scan_chunk=4)
    assert base.table.layout.bf16
    assert base.table.slab.dtype == torch.int16
    want = _sorted_store(base.table)
    for sub, kw in (("b", dict(push_write="blocked", scan_chunk=4)),
                    ("c", dict(scan_chunk=1)),
                    ("d", dict(scan_chunk=4,
                               pass_flags=PassFlags(incremental_pass=False))),
                    ("e", dict(scan_chunk=4,
                               stage_flags=StageFlags(2, 2, 2))),
                    ("f", dict(scan_chunk=1, sparse_chunk_sync=True))):
        t, got = _flagship_run(tmp_path / sub, cfg, **kw)
        assert got == ref, sub
        _assert_stores_equal(_sorted_store(t.table), want)


def test_bf16_preloaded_cadence_matches_full_rebuild(tmp_path):
    """The incremental cadence on the bf16 slab: preloaded with the
    promote prefetcher (its staged rows host f32, encoded at the promote)
    against full rebuilds, three passes, the same losses, AUC and store
    bit for bit, with rows prefetched, kept resident and new."""
    from paddlebox_tpu_torch import cadence_probe
    cfg = _small_cfg(capacity=4096, num_files=4, lines_per_file=96,
                     vocab_per_slot=400)
    windows, feed = flagship.write_cadence(str(tmp_path), cfg)
    runs = {}
    for mode in ("a", "c"):
        t, run = cadence_probe.run_cadence(mode, windows, feed, cfg, "cpu")
        assert t.table.layout.bf16
        runs[mode] = ([(p["loss"], p["auc"]) for p in run["passes"]],
                      _sorted_store(t.table), dict(t.table.counters))
    assert runs["a"][0] == runs["c"][0]
    _assert_stores_equal(runs["a"][1], runs["c"][1])
    c = runs["a"][2]
    assert c["pass_rows_promote_hit"] > 0 and c["pass_rows_promote_new"] > 0
    assert c["pass_rows_promote_prefetched"] > 0


def test_flagship_bf16_differs_from_f32_only_in_the_slab(tmp_path):
    """FLAGSHIP_BF16 is FLAGSHIP with the bf16 slab: its layout, slab and
    host rows; the losses stay close to the f32 run's."""
    assert dataclasses.replace(flagship.FLAGSHIP_BF16,
                               slab_embed_dtype="float32") == \
        flagship.FLAGSHIP
    t16, r16 = _flagship_run(tmp_path / "b", _small_cfg())
    t32, r32 = _flagship_run(tmp_path / "f", _small_cfg(
        slab_embed_dtype="float32"))
    assert t16.table.layout.device_width == 25
    assert t32.table.slab.dtype == torch.float32
    for (l16, _), (l32, _) in zip(r16, r32):
        np.testing.assert_allclose(l16, l32, rtol=1e-2)
    k16, v16 = _sorted_store(t16.table)
    k32, _ = _sorted_store(t32.table)
    np.testing.assert_array_equal(k16, k32)
    # every weight the bf16 run stored is a bf16 value
    bf = acc.slab_codec_plan(t16.table.layout).bf16_cols
    assert not (_bits(v16[:, bf]) & 0xFFFF).any()


def test_bf16_test_pass_reads_the_rows_an_f32_slab_reads(tmp_path):
    """A test pass (predict_batches) on the bf16 slab and on the f32 slab
    over the same host rows and dense weights: the codec decodes exactly,
    so the predictions are the same bits, and neither store changes."""
    cfg = _small_cfg()
    files, feed = flagship.write_files(str(tmp_path), cfg)
    t16, ds = flagship.build_trainer(files, feed, cfg, device="cpu")
    t16.train_pass(ds)
    t32, _ = flagship.build_trainer(files, feed, dataclasses.replace(
        cfg, slab_embed_dtype="float32"), device="cpu")
    keys, rows = _sorted_store(t16.table)
    t32.table.store.assign(keys, rows)
    t32.restore_dense(t16.params, t16.opt_state)
    out = []
    for t in (t16, t32):
        d = BoxDataset(feed)
        d.set_filelist(files[1:])
        d.load_into_memory()
        out.append(t.predict_batches(d))
        _assert_stores_equal(_sorted_store(t.table), (keys, rows))
    np.testing.assert_array_equal(_bits(out[0][0]), _bits(out[1][0]))
    np.testing.assert_array_equal(out[0][1], out[1][1])
    assert out[0][0].size > 0


def test_bf16_journal_rows_are_the_decoded_rows_the_store_got(tmp_path):
    """With the journal on, a bf16 pass records f32 rows: the full build's
    are the store's, the write-back's are the decoded slab rows the store
    then holds."""
    cfg = _small_cfg()
    files, feed = flagship.write_files(str(tmp_path / "d"), cfg)
    t, ds = flagship.build_trainer(files, feed, cfg, device="cpu")
    cm = pckpt.CheckpointManager(
        CheckpointConfig(batch_model_dir=str(tmp_path / "batch"),
                         xbox_model_dir=str(tmp_path / "xbox"),
                         async_save=False), t.table)
    seen = []
    real = cm.journal._append_locked

    def spy(kind, payload):
        seen.append((kind, payload))
        real(kind, payload)

    cm.journal._append_locked = spy
    t.train_pass(ds)
    rows = [jf.decode_rows_payload(p) for k, p in seen if k == jf.KIND_ROWS]
    assert len(rows) == 2
    keys, vals = rows[1]
    assert vals.dtype == np.float32 and vals.shape[1] == t.table.layout.width
    np.testing.assert_array_equal(_bits(vals),
                                  _bits(t.table.store.lookup(keys)))
    pos = np.searchsorted(t.table.pass_keys, keys)
    np.testing.assert_array_equal(
        _bits(vals), _bits(acc.decode_slab_rows_np(
            _u16(t.table.slab)[pos], t.table.layout)))


def test_bf16_day_resume_equals_continue(tmp_path):
    """A bf16 day (run_day: a delta after each pass, the base,
    end_day(age=False)), load_base into a fresh bf16 trainer: the store and
    dense state of the base; after the boundary's replay, one more pass
    from each trainer gives the same loss, AUC and store, bit for bit."""
    cfg = _small_cfg(num_files=4)
    files, feed = flagship.write_files(str(tmp_path / "d"), cfg)
    windows = [files[:2], files[2:]]
    ckpt = CheckpointConfig(batch_model_dir=str(tmp_path / "batch"),
                            xbox_model_dir=str(tmp_path / "xbox"))
    saver, _ = flagship.build_trainer(files, feed, cfg, device="cpu")
    cm = pckpt.CheckpointManager(ckpt, saver.table)
    snap = {}
    real = cm.save_base

    def save_base(params, opt_state, day, **kw):
        snap["store"] = _sorted_store(saver.table)
        return real(params, opt_state, day, **kw)

    cm.save_base = save_base
    pds = []
    for w in windows:
        d = BoxDataset(feed)
        d.set_filelist(w)
        pds.append(d)
    pckpt.run_day(saver, pds, cm, "d0")
    cm.wait()
    resumed, _ = flagship.build_trainer(files, feed, cfg, device="cpu",
                                        seed=1)
    assert resumed.table.layout.bf16
    params, opt_state, _ = pckpt.CheckpointManager(
        ckpt, resumed.table).load_base("d0")
    resumed.restore_dense(params, opt_state)
    _assert_stores_equal(_sorted_store(resumed.table), snap["store"])
    cfg_t = resumed.table.config
    with resumed.table.store_lock:
        resumed.table.store.update_stat_after_save(cfg_t, 1)
        resumed.table.store.update_stat_after_save(cfg_t, 3)
    resumed.table.end_day(age=False)
    _assert_stores_equal(_sorted_store(resumed.table),
                         _sorted_store(saver.table))
    out = []
    for t in (saver, resumed):
        t.reseed(5)
        t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
        d = BoxDataset(feed)
        d.set_filelist(windows[0])
        loss = t.train_pass(d)["loss"]
        out.append((loss, t.metrics.get_metric_msg("auc")["auc"],
                    _sorted_store(t.table)))
    assert out[0][:2] == out[1][:2]
    _assert_stores_equal(out[0][2], out[1][2])


def test_bf16_slab_crosses_packages_bit_for_bit():
    """A reference bf16 slab (the JAX PassTable's full build under
    slab_embed_dtype) carried into the port's int16 slab and back is the
    same bits, and it is the slab the port builds from the same store
    rows."""
    jflags.set_flag("slab_embed_dtype", BF16)
    rng = np.random.RandomState(2)
    jt = JPassTable(JTable(embedx_dim=D, pass_capacity=CAP,
                           optimizer=JSparse(**OPT)))
    keys = np.unique(rng.randint(1, 1 << 40, 300).astype(np.uint64))
    vals = rng.randn(keys.size, ValueLayout(D).width).astype(np.float32)
    blob = {"keys": keys, "values": vals, "embedx_dim": D,
            "optimizer": "adagrad"}
    jt.store.load_blob(blob)
    pt = PassTable(TableConfig(embedx_dim=D, pass_capacity=CAP,
                               optimizer=SparseOptimizerConfig(**OPT)),
                   device="cpu", embed_dtype=BF16)
    pt.store.load_blob(blob)
    for t in (jt, pt):
        t.begin_feed_pass()
        t.add_keys(keys)
        t.end_feed_pass()
        t.begin_pass()
    ref = np.asarray(jt.slab)
    assert ref.dtype == np.uint16
    mine = convert.slab_from_jax(ref)
    assert mine.dtype == torch.int16
    np.testing.assert_array_equal(convert.slab_to_jax(mine), ref)
    np.testing.assert_array_equal(convert.slab_to_jax(pt.slab), ref)
    f = np.random.RandomState(3).rand(4, 17).astype(np.float32)
    np.testing.assert_array_equal(convert.slab_to_jax(
        convert.slab_from_jax(f)), f)
    with pytest.raises(TypeError):
        convert.slab_from_jax(f.astype(np.float64))


# ------------------------------------------------- on the card (cuda mark)

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode; "
                    "chip_smoke.py holds the 2-byte forms against their "
                    "plain versions on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GATHER_CASES_2))
def test_cuda_gather_rows_2byte_matches_plain(cuda_device, case):
    flat, offset, C, W, ids = GATHER_CASES_2[case]
    src = edge_cases.gather_source(
        _i16(flat).to(cuda_device), offset, C, W)
    i = torch.from_numpy(ids).to(cuda_device)
    before = rk.launch_counts()
    got = rk.gather_rows(src, i)
    torch.cuda.synchronize()
    assert rk.gather_rows.launches_2byte == before["gather_rows_2byte"] + 1
    assert torch.equal(got, rk.gather_rows_plain(src, i))
    if W - 17 in (2, 8, 64):
        layout = ValueLayout(W - 17, embed_dtype=BF16)
        dec = rk.gather_rows_decode(src, i, layout)
        torch.cuda.synchronize()
        assert torch.equal(dec.view(torch.int32), rk.gather_rows_decode_plain(
            src, i, layout).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BLOCKED_CASES_2))
def test_cuda_blocked_write_2byte_matches_plain(cuda_device, case):
    slab, new_rows, row_map, blk_idx, offset, (so, ro) = \
        BLOCKED_CASES_2[case]
    nr = _offset_view(new_rows, ro, cuda_device)
    for flip in (slice(None), slice(None, None, -1)):
        rm = _offset_view(row_map[flip], offset, cuda_device)
        bi = torch.from_numpy(blk_idx[flip].copy()).to(cuda_device)
        s1 = _offset_view(slab, so, cuda_device)
        s2 = s1.clone()
        before = pk.blocked_write.launches_2byte
        pk.blocked_write(s1, nr, rm, bi)
        torch.cuda.synchronize()
        assert pk.blocked_write.launches_2byte == before + 1
        pk.blocked_write_plain(s2, nr, rm, bi)
        assert torch.equal(s1, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", pk.KERNEL_EMBEDX_DIMS)
def test_cuda_bf16_push_matches_plain(cuda_device, d):
    layout = ValueLayout(d, embed_dtype=BF16)
    rng = np.random.RandomState(d)
    cap, k = 4096, 3000
    ids = rng.randint(0, 1500, k).astype(np.int32)
    ids[:400] = 7
    ids[k - 300:] = cap - 1
    uids, perm, inv, n = dedup_ids(ids, cap)
    vals = rng.rand(cap, layout.width).astype(np.float32)
    vals[:, acc.MF_SIZE] = np.where(rng.rand(cap) < 0.5, d, 0)
    grads = (rng.randn(k, PushLayout(d).width) * 0.2).astype(np.float32)
    grads[:, PushLayout.SHOW] = rng.randint(0, 2, k)
    grads[k - 300:] = 0.0
    args = [torch.from_numpy(a).to(cuda_device) for a in (
        grads, perm, segment_offsets(inv, k - 300), uids)]
    slab = _i16(acc.encode_slab_rows_np(vals, layout)).to(cuda_device)
    conf = SparseOptimizerConfig(**_conf_kwargs(1.0))
    for rows_out in (False, True):
        s_k, s_p = slab.clone(), slab.clone()
        got = pk.push_adagrad(s_k, *args, n, 9, layout, conf, rows_out)
        torch.cuda.synchronize()
        want = pk.push_adagrad_fused_plain(s_p, *args, n, 9, layout, conf,
                                           rows_out)
        assert torch.equal(s_k, s_p)
        if rows_out:
            assert torch.equal(got, want)
