"""The CPU parameter server's sparse rules in numpy.

A copy of paddlebox_tpu/ps/sgd_rule.py (SparseAdaGradSGDRule /
SparseNaiveSGDRule and CtrCommonAccessor::Update, sparse_sgd_rule.cc and
ctr_accessor.cc): the server applies a push on its own thread, in numpy,
with the reference's operations in the reference's order, so the same
rows, gradients and RandomState give the same bits. The device's rule is
the fused push_adagrad kernel (embedding/push_kernels.py); this one runs
where no card is, on the server.
"""

from __future__ import annotations

import numpy as np

from paddlebox_tpu_torch.config.configs import SparseOptimizerConfig
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.embedding.accessor import PushLayout, ValueLayout


def _adagrad_np(w, g2sum, g, scale, lr, initial_g2sum, min_b, max_b):
    scaled = g / scale
    add_g2 = np.mean(scaled * scaled, axis=-1, keepdims=True)
    ratio = lr * np.sqrt(initial_g2sum / (initial_g2sum + g2sum))
    neww = np.clip(w + ratio * scaled, min_b, max_b)
    return neww, g2sum + add_g2


def numpy_apply_push(values: np.ndarray, grads: np.ndarray,
                     rng: np.random.RandomState, layout: ValueLayout,
                     conf: SparseOptimizerConfig) -> np.ndarray:
    """Merged per-key gradients applied to value rows (the device push's
    semantics, for the adagrad and naive rules): the new rows, ``values``
    untouched. values: [N, layout.width]; grads: [N, push width]; ``rng``
    draws the lazily created embedx (and expand) columns."""
    if layout.optimizer not in ("adagrad", "naive"):
        raise NotImplementedError(
            "CPU PS rule supports adagrad/naive; got " + layout.optimizer)
    push = PushLayout(layout.embedx_dim, layout.expand_dim)
    D = layout.embedx_dim
    out = values.copy()
    g_show = grads[:, push.SHOW:push.SHOW + 1]
    g_click = grads[:, push.CLICK:push.CLICK + 1]
    active = g_show > 0
    scale = np.where(active, g_show, 1.0)

    out[:, acc.SLOT:acc.SLOT + 1] = np.where(
        active, grads[:, push.SLOT:push.SLOT + 1],
        values[:, acc.SLOT:acc.SLOT + 1])
    show = values[:, acc.SHOW:acc.SHOW + 1] + g_show
    click = values[:, acc.CLICK:acc.CLICK + 1] + g_click
    out[:, acc.SHOW:acc.SHOW + 1] = show
    out[:, acc.CLICK:acc.CLICK + 1] = click
    out[:, acc.DELTA_SCORE:acc.DELTA_SCORE + 1] += (
        conf.nonclk_coeff * (g_show - g_click) + conf.clk_coeff * g_click)
    out[:, acc.UNSEEN_DAYS:acc.UNSEEN_DAYS + 1] = np.where(
        active, 0.0, values[:, acc.UNSEEN_DAYS:acc.UNSEEN_DAYS + 1])

    w = values[:, acc.EMBED_W:acc.EMBED_W + 1]
    g = grads[:, push.EMBED_G:push.EMBED_G + 1]
    es = layout.embed_state
    xw0 = layout.embedx_w
    xs = layout.embedx_state
    xg = grads[:, push.embedx_g:push.embedx_g + D]
    embedx = values[:, xw0:xw0 + D]

    if layout.optimizer == "adagrad":
        lr = np.where(
            values[:, acc.SLOT:acc.SLOT + 1] == float(conf.nodeid_slot),
            conf.mf_learning_rate, conf.feature_learning_rate)
        neww, newg2 = _adagrad_np(
            w, values[:, es:es + 1], g, scale, lr,
            conf.mf_initial_g2sum, conf.mf_min_bound, conf.mf_max_bound)
        out[:, acc.EMBED_W:acc.EMBED_W + 1] = neww
        out[:, es:es + 1] = newg2
        newx, newxg2 = _adagrad_np(
            embedx, values[:, xs:xs + 1], xg, scale,
            np.full_like(w, conf.mf_learning_rate),
            conf.mf_initial_g2sum, conf.mf_min_bound, conf.mf_max_bound)
        state_updates = {xs: newxg2}
    else:  # naive
        out[:, acc.EMBED_W:acc.EMBED_W + 1] = np.clip(
            w + conf.learning_rate * (g / scale),
            conf.min_bound, conf.max_bound)
        newx = np.clip(embedx + conf.mf_learning_rate * (xg / scale),
                       conf.mf_min_bound, conf.mf_max_bound)
        state_updates = {}

    # lazy embedx creation (dy_mf_update_value, optimizer.cuh.h:105-133)
    mf_size = values[:, acc.MF_SIZE:acc.MF_SIZE + 1]
    score = conf.nonclk_coeff * (show - click) + conf.clk_coeff * click
    create = (mf_size == 0) & (score >= conf.mf_create_thresholds) & active
    fresh = rng.uniform(0.0, conf.mf_initial_range,
                        embedx.shape).astype(np.float32)
    has_mf = mf_size > 0
    out[:, xw0:xw0 + D] = np.where(
        create, fresh, np.where(has_mf & active, newx, embedx))
    for col, newstate in state_updates.items():
        wdt = newstate.shape[-1]
        oldstate = values[:, col:col + wdt]
        out[:, col:col + wdt] = np.where(has_mf & active, newstate, oldstate)
    out[:, acc.MF_SIZE:acc.MF_SIZE + 1] = np.where(create, float(D), mf_size)

    # expand-embedding block shares the creation gate
    E = layout.expand_dim
    if E:
        ew0 = layout.expand_w
        expand = values[:, ew0:ew0 + E]
        eg = grads[:, push.expand_g:push.expand_g + E]
        if layout.optimizer == "adagrad":
            es2 = layout.expand_state
            newe, newe_g2 = _adagrad_np(
                expand, values[:, es2:es2 + 1], eg, scale,
                np.full_like(w, conf.mf_learning_rate),
                conf.mf_initial_g2sum, conf.mf_min_bound, conf.mf_max_bound)
            out[:, es2:es2 + 1] = np.where(
                has_mf & active, newe_g2, values[:, es2:es2 + 1])
        else:
            newe = np.clip(expand + conf.mf_learning_rate * (eg / scale),
                           conf.mf_min_bound, conf.mf_max_bound)
        fresh_e = rng.uniform(0.0, conf.mf_initial_range,
                              expand.shape).astype(np.float32)
        out[:, ew0:ew0 + E] = np.where(
            create, fresh_e, np.where(has_mf & active, newe, expand))

    return np.where(active, out, values).astype(np.float32)
