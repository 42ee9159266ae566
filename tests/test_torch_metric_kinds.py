"""The port's metric kinds against the JAX package's, bit for bit.

The same numpy arrays go through paddlebox_tpu_torch/metrics/auc.py and
paddlebox_tpu/metrics/auc.py: the calculator's sample-scaled AUC, the
continuous-label sums, the NaN/inf share, the user-weighted AUC (ties,
uids above 2**53), the merge of a bucket table accumulated elsewhere, each
MetricMsg kind's message, and the registry's join/update phase filter.
Every number is compared with ==: both sides run the same float64 numpy
operations in the same order.
"""

import numpy as np
import pytest

from paddlebox_tpu.metrics import auc as jauc
from paddlebox_tpu_torch.metrics import auc as pauc

TABLE = 1 << 12


def _arrays(n=500, seed=0, nan=False):
    rng = np.random.RandomState(seed)
    pred = rng.rand(n).astype(np.float32)
    if nan:
        pred[::37] = np.nan
        pred[5::41] = np.inf
    return {"label": (rng.rand(n) < 0.35).astype(np.int32),
            "pred": pred,
            "mask": rng.rand(n) < 0.85,
            "scale": rng.uniform(0.5, 3.0, n).astype(np.float32),
            "value": rng.gamma(2.0, 1.5, n),
            # a few users with several records each; ties on pred
            "uid": rng.randint(0, 25, n).astype(np.uint64),
            "tied": np.round(pred, 1)}


def _calc_fields(c, names):
    return {f: getattr(c, f)() for f in names}


AUC_FIELDS = ("auc", "bucket_error", "mae", "rmse", "actual_ctr",
              "predicted_ctr", "size")


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_sample_scale_weights_the_positive_bucket(masked):
    t = _arrays(seed=1)
    mask = t["mask"] if masked else None
    ours, theirs = pauc.BasicAucCalculator(TABLE), jauc.BasicAucCalculator(
        TABLE)
    for c in (ours, theirs):
        c.add_data(t["pred"], t["label"], mask, sample_scale=t["scale"])
        c.add_data(t["pred"][:50], t["label"][:50])
        c.compute()
    np.testing.assert_array_equal(ours._table, theirs._table)
    assert _calc_fields(ours, AUC_FIELDS) == _calc_fields(theirs,
                                                          AUC_FIELDS)
    # the scale moved the positive bucket only
    plain = pauc.BasicAucCalculator(TABLE)
    plain.add_data(t["pred"], t["label"], mask)
    plain.add_data(t["pred"][:50], t["label"][:50])
    np.testing.assert_array_equal(ours._table[0], plain._table[0])
    assert not np.array_equal(ours._table[1], plain._table[1])


def test_continue_kind_matches_jax():
    t = _arrays(seed=2)
    msgs = [m.MetricMsg("value", "pred", "c", kind="continue",
                        table_size=TABLE, mask_var="mask")
            for m in (pauc, jauc)]
    for m in msgs:
        m.add_from(t)
        m.add_from({**t, "mask": ~t["mask"]})
    got, want = msgs[0].get_msg(), msgs[1].get_msg()
    assert got == want and got["size"] == 500.0
    assert set(got) == {"mae", "rmse", "size", "actual_value",
                        "predicted_value"}


def test_nan_inf_kind_matches_jax():
    t = _arrays(seed=3, nan=True)
    msgs = [m.MetricMsg("label", "pred", "n", kind="nan_inf",
                        table_size=TABLE) for m in (pauc, jauc)]
    for m in msgs:
        m.add_from(t)
        m.add_from(_arrays(seed=4))
    got, want = msgs[0].get_msg(), msgs[1].get_msg()
    assert got == want and set(got) == {"nan_inf_rate"}
    assert 0.0 < got["nan_inf_rate"] < 0.1
    for m in msgs:
        m.calculator.reset_nan_inf()
        assert m.get_msg() == {"nan_inf_rate": 0.0}


@pytest.mark.parametrize("pred_key", ["pred", "tied"], ids=["pred", "ties"])
def test_wuauc_kind_matches_jax(pred_key):
    """Per-user AUC over (uid asc, pred desc, label asc), ties grouped:
    uauc and wuauc equal bit for bit, masked records left out."""
    t = _arrays(seed=5)
    msgs = [m.MetricMsg("label", pred_key, "w", kind="wuauc", uid_var="uid",
                        mask_var="mask", table_size=TABLE)
            for m in (pauc, jauc)]
    for seed in (5, 6):
        t = _arrays(seed=seed)
        for m in msgs:
            m.add_from(t)
    got, want = msgs[0].get_msg(), msgs[1].get_msg()
    assert got == want
    assert set(got) == {"user_cnt", "size", "uauc", "wuauc"}
    assert got["user_cnt"] > 10 and 0.0 < got["wuauc"] < 1.0
    # the AUC of the same records rode along
    assert msgs[0].calculator._table.sum() == msgs[1].calculator._table.sum()


def test_wuauc_keeps_uids_above_2_53_apart():
    """Two uids that float64 would merge stay two users."""
    base = np.uint64(1) << np.uint64(60)
    uid = np.array([base, base, base + np.uint64(1), base + np.uint64(1)],
                   np.uint64)
    pred = np.array([0.9, 0.1, 0.2, 0.8])
    label = np.array([1, 0, 1, 0])
    got = []
    for m in (pauc, jauc):
        c = m.BasicAucCalculator(TABLE)
        c.add_uid_data(pred, label, uid)
        c.compute_wuauc()
        got.append((c.user_cnt(), c.uauc(), c.wuauc(), c.size()))
    assert got[0] == got[1]
    # one user ranks right, one wrong (each AUC over fp * tp + 1e-9)
    assert got[0][0] == 2.0 and abs(got[0][1] - 0.5) < 1e-8


def test_bucket_stats_merge_and_refuse_a_shape():
    t = _arrays(seed=7)
    pos = np.minimum((t["pred"].astype(np.float64) * TABLE).astype(np.int64),
                     TABLE - 1)
    table = np.zeros((2, TABLE))
    np.add.at(table[0], pos[t["label"] == 0], 1.0)
    np.add.at(table[1], pos[t["label"] == 1], 1.0)
    err = t["pred"].astype(np.float64) - t["label"]
    stats = (float(np.abs(err).sum()), float((err ** 2).sum()),
             float(t["pred"].astype(np.float64).sum()),
             float(t["label"].sum()), float(t["pred"].size))
    calcs = [m.BasicAucCalculator(TABLE, mode_collect_in_device=True)
             for m in (pauc, jauc)]
    for c in calcs:
        assert c.mode_collect_in_device and c.table_size == TABLE
        c.add_bucket_stats(table, *stats)
        c.add_bucket_stats(table, *stats)
        c.compute()
        c.compute_continue_msg()
    np.testing.assert_array_equal(calcs[0]._table, calcs[1]._table)
    assert _calc_fields(calcs[0], AUC_FIELDS + (
        "actual_value", "predicted_value")) == _calc_fields(
        calcs[1], AUC_FIELDS + ("actual_value", "predicted_value"))
    # the merge equals per-batch adds of the same records
    direct = pauc.BasicAucCalculator(TABLE)
    direct.add_data(t["pred"], t["label"])
    direct.add_data(t["pred"], t["label"])
    direct.compute()
    np.testing.assert_array_equal(calcs[0]._table, direct._table)
    for c in calcs:
        with pytest.raises(ValueError, match="shape"):
            c.add_bucket_stats(np.zeros((2, TABLE // 2)), *stats)


def test_reset_clears_records_and_counts():
    t = _arrays(seed=8, nan=True)
    c = pauc.BasicAucCalculator(TABLE)
    c.add_uid_data(np.nan_to_num(t["pred"], posinf=1.0), t["label"],
                   t["uid"])
    c.add_nan_inf_data(t["pred"])
    c.compute_wuauc()
    c.compute_nan_inf()
    assert c.user_cnt() > 0 and c.nan_inf_rate() > 0
    c.reset()
    c.compute_wuauc()
    c.compute_nan_inf()
    assert (c.user_cnt(), c.uauc(), c.wuauc(), c.nan_inf_rate(),
            c._table.sum()) == (0.0, 0.0, 0.0, 0.0, 0.0)


def _registry(mod):
    reg = mod.MetricRegistry()
    reg.init_metric("all", "label", "pred")
    reg.init_metric("join", "label", "pred", metric_phase=0,
                    table_size=TABLE, mask_var="mask")
    reg.init_metric("update", "label", "pred", metric_phase=1,
                    table_size=TABLE, sample_scale_var="scale")
    reg.init_metric("cont", "value", "pred", metric_phase=1, kind="continue")
    return reg


@pytest.mark.parametrize("start", [-1, 0, 1, 2])
def test_phase_filter_and_flip_match_jax(start):
    """add_batch feeds the metrics of phase -1 and of the registry's
    phase, or every metric at phase -1; flip_phase swaps 0 and 1 only."""
    regs = [_registry(m) for m in (pauc, jauc)]
    for step in range(4):
        t = _arrays(seed=10 + step)
        for reg in regs:
            if step == 0:
                reg.phase = start
            reg.add_batch(t)
            reg.flip_phase()
        assert regs[0].phase == regs[1].phase
    assert regs[0].phase == start
    for name in regs[0].metric_names():
        assert regs[0].get(name).calculator._table.sum() == \
            regs[1].get(name).calculator._table.sum(), name
        assert regs[0].get_metric_msg(name) == regs[1].get_metric_msg(name)
    sizes = {n: regs[0].get_metric_msg(n)["size"]
             for n in ("all", "join", "update")}
    if start == -1:
        assert sizes["all"] == 2000.0 and sizes["join"] > 0 \
            and sizes["update"] > 0
    elif start == 2:
        # a phase other than 0 and 1 stays, and feeds phase -1 only
        assert sizes["join"] == sizes["update"] == 0.0
    else:
        assert sizes["join"] > 0 and sizes["update"] > 0


def test_message_kind_is_checked():
    with pytest.raises(ValueError, match="kind"):
        pauc.MetricMsg("label", "pred", "x", kind="uauc")
