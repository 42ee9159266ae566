"""The SSD tier under sharding: the port's ShardedPassTable with a spill
budget against the JAX package's.

The port runs P = 2 and 4 gloo ranks (tests/sharded_cluster.py, spawned,
a process group timeout and a wall limit), every rank's tier in one shared
ssd_dir (each rank's blocks carry its pid), against the JAX
ShardedBoxTrainer on a P-device mesh with use_pallas_push (interpreted);
every rank replays its shard's push seeds. The budget spills at every
pass end. The reference divides it over a process's P owned shards; the
port over the P ranks on the host (ShardMesh.chips), so each shard keeps
the same rows. Two passes, then the day (end_day(age=True)) and
LoadSSD2Mem, and before the day the shard's save. Tolerances: each pass's
loss rtol 1e-4 and the cluster AUC 1e-4 absolute; each shard's rows
(resident and tier, the tier's at their effective values) with the
integer columns exact and the float columns rtol 1e-4 / atol 1e-6, after
the passes, after the day and after LoadSSD2Mem; the rows each shard's
tier holds after each pass and after the day exact; a shard's save holds
its tier's rows beside the resident ones (bit for bit against the live
store, to the same tolerances against the JAX shard's save).

In process: the budget rule of PassTable.check_need_limit_mem (a share of
the budget a rank on the host; a table-wide store, the PS-backed one, the
whole budget through its primary, its spill tainting an attached journal).
"""

import numpy as np
import pytest

from paddlebox_tpu_torch.config.configs import TableConfig
from paddlebox_tpu_torch.embedding import ckpt_store
from paddlebox_tpu_torch.embedding.accessor import ValueLayout
from paddlebox_tpu_torch.embedding.pass_table import PassTable
from paddlebox_tpu_torch.parallel.sharded_table import ShardedPassTable
from sharded_cluster import (D, assert_bits, assert_matches_jax,
                             assert_store, cluster_spec, jax_reference,
                             run_cluster, use_jax_pallas, write_data)

BUDGET_ROWS = 160


def tier_fields(ssd_dir):
    width = ValueLayout(D).width
    return dict(ssd_dir=str(ssd_dir),
                ssd_threshold_mb=BUDGET_ROWS * width * 4 / (1 << 20))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_data(tmp_path_factory.mktemp("torch_sharded_ssd"), lines=64)


def sorted_rows(blob):
    keys = np.asarray(blob["keys"], np.uint64)
    order = np.argsort(keys)
    return keys[order], np.asarray(blob["values"], np.float32)[order]


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def clusters(request, data, tmp_path_factory):
    P = request.param
    files, pfeed = data
    root = tmp_path_factory.mktemp("torch_sharded_ssd_P%d" % P)
    for d in ("port_ssd", "jax_ssd", "port_save", "jax_save", "out"):
        (root / d).mkdir()
    spec = cluster_spec(pfeed, files, P, {"deepfm": jax_reference(
        files, pfeed, P, passes=0)}, [], 2 * 16)
    spec["runs"] = [{"table": tier_fields(root / "port_ssd"), "day": True,
                     "load_ssd": True,
                     "save_tier": str(root / "port_save" / "t")}]

    def oracle():
        with pytest.MonkeyPatch.context() as mp:
            from paddlebox_tpu.config import flags as jflags
            old = {k: jflags.get_flag(k)
                   for k in ("use_pallas_push", "dataset_disable_shuffle")}
            use_jax_pallas(mp)
            try:
                return jax_reference(files, pfeed, P,
                                     table=tier_fields(root / "jax_ssd"),
                                     save=str(root / "jax_save" / "t"),
                                     day=True)
            finally:
                for k, v in old.items():
                    jflags.set_flag(k, v)

    ranks, want = run_cluster(P, spec, root / "out", meanwhile=oracle)
    return P, root, [r[0] for r in ranks], want


def test_passes_and_shards_match_jax(clusters):
    P, _, ranks, want = clusters
    for r, res in enumerate(ranks):
        assert_matches_jax(res, want, r)
        # the tier held rows after every pass, on every shard, as the
        # reference's shard
        spilled = [t["spilled"] for t in res["tier"]]
        assert spilled == [w[r] for w in want["tier"]], (spilled,
                                                          want["tier"])
        assert all(n > 0 for n in spilled)
        assert res["tier"][0]["sparse_keys_spilled"] > 0
        assert res["tier"][1]["sparse_keys_faulted_in"] > 0
        assert res["tier"][0]["ps_rows_spilled"] == 0
        assert len(res["store"][0]) == want["pass_keys"][r].size
    # across the ranks the losses are the cluster's
    assert all(res["passes"] == ranks[0]["passes"] for res in ranks)


def test_day_and_load_ssd_to_mem_match_jax(clusters):
    P, _, ranks, want = clusters
    loaded = 0
    for r, res in enumerate(ranks):
        day = res["day"]
        assert day["day_spilled"] == want["day_spilled"][r]
        assert_store(day["day_union"], want["day_stores"][r])
        assert_store(day["after_load"], want["after_load"][r])
        assert day["after_load_spilled"] == 0
        assert day["after_load_resident"] == day["after_load"][0].size
        # the day's rows are the loaded rows: the tier moved back whole
        np.testing.assert_array_equal(day["after_load"][0],
                                      day["day_union"][0])
        loaded += day["ssd_loaded"]
    assert loaded == want["ssd_loaded"] == sum(want["day_spilled"])
    assert sum(r["day"]["shrunk"] for r in ranks) == want["shrunk"]


def test_shard_save_holds_its_tier(clusters):
    P, root, ranks, want = clusters
    for r, res in enumerate(ranks):
        assert res["tier"][-1]["spilled"] > 0
        got = sorted_rows(ckpt_store.load_sparse_any(
            str(root / "port_save" / ("t.shard%03d" % r))))
        live = res["day"]["saved_union"]
        np.testing.assert_array_equal(got[0], live[0])
        assert_bits(got[1], live[1])
        jax_file = sorted_rows(ckpt_store.load_sparse_any(
            str(root / "jax_save" / ("t.shard%03d" % r))))
        assert_store(got, jax_file)
        assert_store(got, want["saved"][r])


# ------------------------------------------------------- in process: budget
class TableWideStore:
    """A store whose tier is the table's (the PS-backed one's shape): it
    records the budget it was handed and has no journal sink."""

    spill_table_wide = True

    def __init__(self):
        self.budgets = []

    def spill(self, max_resident):
        self.budgets.append(max_resident)
        return 5


class Journal:
    def __init__(self):
        self.tainted = []

    def taint(self, reason):
        self.tainted.append(reason)

    def append_move(self, *a):
        pass


def test_budget_splits_over_the_host_ranks(tmp_path):
    width = ValueLayout(D).width
    table = TableConfig(embedx_dim=D, pass_capacity=64,
                        **tier_fields(tmp_path))
    budget = table.ssd_max_resident_rows(width)
    assert budget == BUDGET_ROWS
    sharded = ShardedPassTable(table, 4, 16, owned_shards=[1], device="cpu",
                               host_ranks=4)
    assert sharded.shard.budget_split == 4
    store = sharded.shard.store
    keys = np.arange(1, 301, dtype=np.uint64)
    store.lookup_or_create(keys)
    assert sharded.check_need_limit_mem() == 300 - BUDGET_ROWS // 4
    assert len(store) == BUDGET_ROWS // 4
    assert sharded.spilled_count() == 300 - BUDGET_ROWS // 4
    k, v = sharded.spilled_snapshot()
    assert k.size == sharded.spilled_count() == sharded.spilled_keys().size
    assert v.shape == (k.size, width)
    sharded.rebase_spill_ages()
    assert sharded.load_ssd_to_mem() == 300 - BUDGET_ROWS // 4
    assert len(store) == 300 and sharded.spilled_count() == 0
    # a table-wide store: the whole budget once, and its spill taints
    wide = TableWideStore()
    t = PassTable(table, device="cpu", store=wide)
    t.budget_split = 4
    journal = Journal()
    t._journal = journal
    assert t.check_need_limit_mem() == 5
    assert wide.budgets == [BUDGET_ROWS]
    assert len(journal.tainted) == 1 and "server-side" in journal.tainted[0]
    # and the probes of a store without a tier of its own
    assert t.load_ssd_to_mem() == 0
    t.attach_journal(journal)
    assert t.promote_prefetch_ctx() is None
    no_tier = ShardedPassTable(table, 1, 16, device="cpu", store=wide)
    assert no_tier.spilled_count() == 0 and no_tier.spilled_keys().size == 0
    assert no_tier.spilled_snapshot()[1].shape == (0, width)
