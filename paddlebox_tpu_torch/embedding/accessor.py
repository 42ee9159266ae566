"""Feature-value row layout (the "accessor") of the in-table optimizers,
and the slab codec of the bf16 diet.

Counterpart of paddlebox_tpu/embedding/accessor.py:35-215, 217-340,
344-367. A logical row (host stores, checkpoints, the push and pull math)
is ``width`` f32 columns

    [slot, show, click, delta_score, unseen_days, mf_size,
     embed_w, embed_state..., embedx_w[D], embedx_state...,
     expand_w[E], expand_state...]

whose state widths follow the table's rule (optimizer.cuh.h):

    adagrad:     embed_state 1 (g2sum),       embedx_state 1 (shared g2sum)
    adam:        embed_state 4 (m, v, b1p, b2p), embedx_state 2D + 2
    adam_shared: embed_state 4,               embedx_state 4
    naive:       embed_state 0,               embedx_state 0

and a per-key push row is [slot, show, click, embed_g, embedx_g[D],
expand_g[E]]. The expand block (E = expand_dim > 0, the NN-cross features
of pull_box_extended_sparse) is allowed with adagrad (one shared g2sum
column after it) and naive (no state). The day lifecycle's row arithmetic
(decay, delete decision, stat rewrite after a save) is numpy f32 with
Python-float weights in the reference's order, so the two packages agree
bit for bit.

``embed_dtype`` is the DEVICE slab's storage (flag ``slab_embed_dtype``):
'float32', the [capacity, width] f32 slab; or 'bfloat16', one 2-byte
[capacity, device_width] slab whose weight columns (embed_w, embedx,
expand) hold their bf16 and every other column its f32 bits as (hi, lo)
halves, losslessly. On the device those 2-byte columns are a ``torch.int16``
tensor holding the reference's uint16 bits (torch.uint16 has no
index_copy_, shifts or comparisons on the CPU); numpy views the same
bytes as uint16. The codec (``encode_slab_rows`` / ``decode_slab_rows``
in torch, ``*_np`` in numpy) is the one boundary between the two, the
identity on an f32 layout. Its bf16 rounding is the integer round to
nearest even of the reference's numpy twin, with a NaN quieted to
(hi | 0x40), never a library conversion: torch's and CUDA's give another
NaN.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from paddlebox_tpu_torch.config.configs import (SparseOptimizerConfig,
                                                TableConfig)

SLOT = 0
SHOW = 1
CLICK = 2
DELTA_SCORE = 3
UNSEEN_DAYS = 4
MF_SIZE = 5
EMBED_W = 6
_HEADER = 7  # embed_state starts here


EMBED_DTYPES = ("float32", "bfloat16")
OPTIMIZERS = ("adagrad", "adam", "adam_shared", "naive")


def _state_widths(optimizer: str, embedx_dim: int):
    """(embed_state, embedx_state) widths of a rule (reference
    accessor.py:46-56)."""
    if optimizer == "adagrad":
        return 1, 1
    if optimizer == "adam":
        return 4, 2 * embedx_dim + 2
    if optimizer == "adam_shared":
        return 4, 4
    if optimizer == "naive":
        return 0, 0
    raise ValueError("unknown sparse optimizer %r" % (optimizer,))


@dataclasses.dataclass(frozen=True)
class ValueLayout:
    """Column map of one table (its rule's state widths, the expand
    block) and the device slab's storage ``embed_dtype``."""

    embedx_dim: int
    optimizer: str = "adagrad"
    expand_dim: int = 0
    embed_dtype: str = "float32"

    def __post_init__(self):
        _state_widths(self.optimizer, self.embedx_dim)
        if self.embedx_dim <= 0:
            raise ValueError("embedx_dim must be positive")
        if self.expand_dim < 0:
            raise ValueError("expand_dim must be >= 0")
        if self.expand_dim and self.optimizer not in ("adagrad", "naive"):
            raise ValueError(
                "expand_dim requires adagrad/naive sparse optimizer")
        if self.embed_dtype not in EMBED_DTYPES:
            raise ValueError("embed_dtype must be float32 or bfloat16, got "
                             "%r" % (self.embed_dtype,))

    @property
    def embed_state_dim(self) -> int:
        return _state_widths(self.optimizer, self.embedx_dim)[0]

    @property
    def embedx_state_dim(self) -> int:
        return _state_widths(self.optimizer, self.embedx_dim)[1]

    @property
    def embed_state(self) -> int:
        return _HEADER

    @property
    def embedx_w(self) -> int:
        return _HEADER + self.embed_state_dim

    @property
    def embedx_state(self) -> int:
        return self.embedx_w + self.embedx_dim

    @property
    def expand_w(self) -> int:
        return self.embedx_state + self.embedx_state_dim

    @property
    def expand_state_dim(self) -> int:
        return 1 if (self.expand_dim and self.optimizer == "adagrad") else 0

    @property
    def expand_state(self) -> int:
        return self.expand_w + self.expand_dim

    @property
    def width(self) -> int:
        return self.expand_state + self.expand_state_dim

    @property
    def bf16(self) -> bool:
        return self.embed_dtype == "bfloat16"

    @property
    def device_width(self) -> int:
        """Columns of the device slab: ``width``, or under the bf16 diet
        one 2-byte column a weight and two every other column."""
        if not self.bf16:
            return self.width
        return int(2 * self.width - slab_codec_plan(self).bf16_cols.sum())

    @property
    def device_bytes_per_row(self) -> int:
        return 2 * self.device_width if self.bf16 else 4 * self.width

    @property
    def device_dtype(self) -> torch.dtype:
        """The device slab's torch dtype: float32, or int16 holding the
        diet's uint16 bits."""
        return torch.int16 if self.bf16 else torch.float32

    def new_rows(self, n: int, rng: np.random.RandomState,
                 conf: SparseOptimizerConfig) -> np.ndarray:
        """Fresh feature rows (reference accessor.py:159-182): zeros,
        embed_w uniform in +-initial_range when that is set (embedx and
        the expand block are created lazily by the push); the adam rules'
        beta power columns start at the decay rates (beta1_decay_rate and
        beta2_decay_rate, for embedx too)."""
        rows = np.zeros((n, self.width), dtype=np.float32)
        if conf.initial_range:
            rows[:, EMBED_W] = rng.uniform(
                -conf.initial_range, conf.initial_range, n)
        if self.optimizer in ("adam", "adam_shared"):
            es, xs = self.embed_state, self.embedx_state
            rows[:, es + 2] = conf.beta1_decay_rate
            rows[:, es + 3] = conf.beta2_decay_rate
            xp = xs + (2 * self.embedx_dim if self.optimizer == "adam"
                       else 2)
            rows[:, xp] = conf.beta1_decay_rate
            rows[:, xp + 1] = conf.beta2_decay_rate
        return rows

    # ----------------------------------------------------------- lifecycle
    def show_click_score(self, show, click, conf: SparseOptimizerConfig):
        """CtrCommonAccessor::ShowClickScore: nonclk_coeff*(show-click) +
        clk_coeff*click."""
        return conf.nonclk_coeff * (show - click) + conf.clk_coeff * click

    def shrink_mask(self, values: np.ndarray, table: TableConfig
                    ) -> np.ndarray:
        """Day-cadence decay and delete decision (ctr_accessor.cc:63-79):
        decays show/click of ``values`` IN PLACE and returns the bool mask
        of rows to delete."""
        conf = table.optimizer
        values[:, SHOW] *= table.show_click_decay_rate
        values[:, CLICK] *= table.show_click_decay_rate
        score = self.show_click_score(values[:, SHOW], values[:, CLICK], conf)
        return ((score < table.delete_threshold)
                | (values[:, UNSEEN_DAYS] > table.delete_after_unseen_days))

    def update_stat_after_save(self, values: np.ndarray, table: TableConfig,
                               param: int) -> None:
        """UpdateStatAfterSave (ctr_accessor.cc:101-128), in place: param 1
        clears the delta score of the rows a delta save covers, 3 ages
        unseen_days."""
        conf = table.optimizer
        if param == 1:
            score = self.show_click_score(values[:, SHOW], values[:, CLICK],
                                          conf)
            covered = ((score >= table.base_threshold)
                       & (values[:, DELTA_SCORE] >= table.delta_threshold)
                       & (values[:, UNSEEN_DAYS] <= table.delta_keep_days))
            values[covered, DELTA_SCORE] = 0.0
        elif param == 3:
            values[:, UNSEEN_DAYS] += 1.0


@dataclasses.dataclass(frozen=True)
class PushLayout:
    """Per-key gradient row: [slot, show, click, embed_g, embedx_g[D],
    expand_g[E]]."""

    embedx_dim: int
    expand_dim: int = 0

    SLOT = 0
    SHOW = 1
    CLICK = 2
    EMBED_G = 3

    @property
    def embedx_g(self) -> int:
        return 4

    @property
    def expand_g(self) -> int:
        return 4 + self.embedx_dim

    @property
    def width(self) -> int:
        return 4 + self.embedx_dim + self.expand_dim

    @classmethod
    def of(cls, layout: ValueLayout) -> "PushLayout":
        return cls(layout.embedx_dim, layout.expand_dim)


# --------------------------------------------------------------- slab codec
# reference accessor.py:217-340. Device column j of a bf16 slab holds
# kind kinds[j] of logical column srcs[j]: its bf16 (weights), or the high
# or low 16 bits of its f32.

_KIND_BF16, _KIND_HI, _KIND_LO = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class SlabCodecPlan:
    """The column plan of a layout (device column -> logical column and
    kind; logical column -> its device columns)."""

    bf16_cols: np.ndarray   # [width] bool, the weight columns stored as bf16
    kinds: np.ndarray       # [device_width] int32, _KIND_* of each column
    srcs: np.ndarray        # [device_width] int32, its logical column
    hi_pos: np.ndarray      # [width] int32, the device column of the hi
    #                         half (of the bf16 for a weight column)
    lo_pos: np.ndarray      # [width] int32, of the lo half (a weight
    #                         column's points at its own bf16; masked)


@functools.lru_cache(maxsize=None)
def slab_codec_plan(layout: ValueLayout) -> SlabCodecPlan:
    W = layout.width
    bf = np.zeros(W, bool)
    bf[EMBED_W] = True
    bf[layout.embedx_w:layout.embedx_w + layout.embedx_dim] = True
    bf[layout.expand_w:layout.expand_w + layout.expand_dim] = True
    kinds, srcs = [], []
    hi_pos = np.zeros(W, np.int32)
    lo_pos = np.zeros(W, np.int32)
    for c in range(W):
        hi_pos[c] = len(kinds)
        if bf[c]:
            lo_pos[c] = len(kinds)
            kinds.append(_KIND_BF16)
            srcs.append(c)
        else:
            kinds += [_KIND_HI, _KIND_LO]
            srcs += [c, c]
            lo_pos[c] = len(kinds) - 1
    return SlabCodecPlan(bf, np.asarray(kinds, np.int32),
                         np.asarray(srcs, np.int32), hi_pos, lo_pos)


@functools.lru_cache(maxsize=None)
def slab_codec_columns(layout: ValueLayout) -> tuple:
    """The plan as the kernels take it: 2 * width ints, each logical
    column's hi device column, then its lo device column (-1 for a column
    stored as bf16)."""
    plan = slab_codec_plan(layout)
    lo = np.where(plan.bf16_cols, -1, plan.lo_pos)
    return tuple(plan.hi_pos.tolist()) + tuple(lo.tolist())


@functools.lru_cache(maxsize=None)
def _codec_index(layout: ValueLayout, device: torch.device):
    """The plan's index tensors on ``device``, made once: the encode's
    (source column * 3 + kind), hi_pos, lo_pos and the bf16 column mask."""
    plan = slab_codec_plan(layout)
    return tuple(torch.from_numpy(a).to(device) for a in (
        (plan.srcs * 3 + plan.kinds).astype(np.int64),
        plan.hi_pos.astype(np.int64), plan.lo_pos.astype(np.int64),
        plan.bf16_cols))


def encode_slab_rows(rows: torch.Tensor, layout: ValueLayout
                     ) -> torch.Tensor:
    """[..., width] f32 rows -> [..., device_width] int16 device rows (the
    rows themselves on an f32 layout). Weight columns round to nearest
    even in integer arithmetic, a NaN to (hi | 0x40); the other columns
    split into their (hi, lo) bits."""
    if not layout.bf16:
        return rows
    at = _codec_index(layout, rows.device)[0]
    u = rows.contiguous().view(torch.int32)
    hi = (u >> 16) & 0xFFFF
    lo = u & 0xFFFF
    # (u + 0x7FFF + lsb) >> 16 modulo 2^16, without leaving int32
    rounded = (hi + ((lo + 0x7FFF + (hi & 1)) >> 16)) & 0xFFFF
    isnan = (u & 0x7FFFFFFF) > 0x7F800000
    b16 = torch.where(isnan, hi | 0x40, rounded)
    sel = torch.stack([b16, hi, lo], dim=-1).flatten(-2)
    v = sel.index_select(-1, at)
    return torch.where(v >= 0x8000, v - 0x10000, v).to(torch.int16)


def decode_slab_rows(rows: torch.Tensor, layout: ValueLayout
                     ) -> torch.Tensor:
    """[..., device_width] int16 device rows -> [..., width] f32 (the rows
    themselves on an f32 layout): the split columns get their exact f32
    bits back, the weight columns their bf16 widened with zero low bits
    (exact)."""
    if not layout.bf16:
        return rows
    _, hi_pos, lo_pos, bf16_cols = _codec_index(layout, rows.device)
    s = rows.to(torch.int32)
    hi = s.index_select(-1, hi_pos)
    lo = torch.where(bf16_cols, 0, s.index_select(-1, lo_pos) & 0xFFFF)
    # the sign-extended hi half times 2^16 plus the lo half is the f32's
    # bits as an int32, with no overflow
    return (hi * 0x10000 + lo).view(torch.float32)


def encode_slab_rows_np(rows: np.ndarray, layout: ValueLayout) -> np.ndarray:
    """The numpy twin of encode_slab_rows (uint16 device rows in C order),
    the host side of the full build and the promote."""
    if not layout.bf16:
        return np.ascontiguousarray(rows, np.float32)
    plan = slab_codec_plan(layout)
    u = np.ascontiguousarray(rows, np.float32).view(np.uint32)
    hi = (u >> np.uint32(16)).astype(np.uint16)
    lo = (u & np.uint32(0xFFFF)).astype(np.uint16)
    rounded = ((u + np.uint32(0x7FFF) + ((u >> np.uint32(16))
                                         & np.uint32(1)))
               >> np.uint32(16)).astype(np.uint16)
    isnan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    b16 = np.where(isnan, hi | np.uint16(0x40), rounded)
    # C order (indexing the last axis leaves the result transposed)
    return np.ascontiguousarray(np.where(
        plan.kinds == _KIND_BF16, b16[..., plan.srcs],
        np.where(plan.kinds == _KIND_HI, hi[..., plan.srcs],
                 lo[..., plan.srcs])))


def slab_rows_np(rows: np.ndarray, layout: ValueLayout) -> np.ndarray:
    """Host f32 rows as the device slab's rows, still on the host: the
    rows themselves under an f32 layout, their numpy encoding viewed as
    int16 (the device slab's dtype) under bf16."""
    enc = encode_slab_rows_np(rows, layout)
    return enc.view(np.int16) if layout.bf16 else enc


def decode_slab_rows_np(rows: np.ndarray, layout: ValueLayout) -> np.ndarray:
    """The numpy twin of decode_slab_rows (f32 rows from uint16 or int16
    device rows), the host side of the write-back."""
    if not layout.bf16:
        return np.asarray(rows, np.float32)
    plan = slab_codec_plan(layout)
    rows = np.asarray(rows).view(np.uint16)
    hi = rows[..., plan.hi_pos].astype(np.uint32)
    lo = np.where(plan.bf16_cols, np.uint32(0),
                  rows[..., plan.lo_pos].astype(np.uint32))
    return np.ascontiguousarray((hi << np.uint32(16)) | lo).view(np.float32)
