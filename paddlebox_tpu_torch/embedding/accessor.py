"""Feature-value row layout (the "accessor") of the f32 adagrad table.

Counterpart of paddlebox_tpu/embedding/accessor.py:35-215, 344-367. A row of
the [capacity, width] float32 slab is

    [slot, show, click, delta_score, unseen_days, mf_size,
     embed_w, embed_g2sum, embedx_w[D], embedx_g2sum]

and a per-key push row is [slot, show, click, embed_g, embedx_g[D]]. Only
the adagrad layout on an f32 slab is ported; the bf16 slab codec and the
adam layouts wait for later slices. The day lifecycle's row arithmetic
(decay, delete decision, stat rewrite after a save) is numpy f32 with
Python-float weights in the reference's order, so the two packages agree
bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

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


@dataclasses.dataclass(frozen=True)
class ValueLayout:
    """Column map of one adagrad table (embed_state and embedx_state are one
    g2sum column each)."""

    embedx_dim: int
    optimizer: str = "adagrad"

    def __post_init__(self):
        if self.optimizer != "adagrad":
            raise ValueError("the port implements the adagrad table layout "
                             "only, got %r" % (self.optimizer,))
        if self.embedx_dim <= 0:
            raise ValueError("embedx_dim must be positive")

    @property
    def embed_state(self) -> int:
        return _HEADER

    @property
    def embedx_w(self) -> int:
        return _HEADER + 1

    @property
    def embedx_state(self) -> int:
        return self.embedx_w + self.embedx_dim

    @property
    def width(self) -> int:
        return self.embedx_state + 1

    def new_rows(self, n: int, rng: np.random.RandomState,
                 conf: SparseOptimizerConfig) -> np.ndarray:
        """Fresh feature rows: zeros, embed_w uniform in +-initial_range when
        that is set (embedx is created lazily by the push)."""
        rows = np.zeros((n, self.width), dtype=np.float32)
        if conf.initial_range:
            rows[:, EMBED_W] = rng.uniform(
                -conf.initial_range, conf.initial_range, n)
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
    """Per-key gradient row: [slot, show, click, embed_g, embedx_g[D]]."""

    embedx_dim: int

    SLOT = 0
    SHOW = 1
    CLICK = 2
    EMBED_G = 3

    @property
    def embedx_g(self) -> int:
        return 4

    @property
    def width(self) -> int:
        return 4 + self.embedx_dim
