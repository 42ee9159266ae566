"""The sharded trainer under the table-wise and 2-D grid policies, with the
grid's replicated hot tier, against the JAX package's ShardedBoxTrainer.

Gloo clusters of 2 and 4 ranks (tests/sharded_cluster.py: each rank
spawned, one thread, a group timeout and a wall limit; no fixed port)
train two passes under each policy: table-wise (7 tables, the table
field at bit 2), the 2-D grid (its rows automatic at P = 2, 2 at P = 4)
and the grid with its hot tier on the uid wire and on the full wire.
Each run is held to the JAX sharded trainer on a P-device mesh under the
same flags within assert_matches_jax's tolerances (each pass's loss rtol
1e-4, the cluster AUC 1e-4 absolute, the store's integer columns bit-
exact and its float columns rtol 1e-4 / atol 1e-6, the dense parameters
rtol 1e-4 / atol 1e-6). The reference's in-process staging never drops
a hot id, so its run is the plain grid's: the port's hot runs equal their
JAX run all the same, the rows of hot ids a step did not touch left
unchanged by the push. Each rank's store holds the keys its policy
routes to it and no other; the frozen hot set is the same on every rank
and the reference's; the hot ids kept off the wire are counted; the
batches went through rt_bucketize_sharded; rank 0 emits a merged cluster
record of both ranks and its health record, which /health serves; a
split sharding_hot_cap raises MeshPolicyMismatch on every rank. At world
1 in process every policy equals the key-mod run bit for bit.
"""

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch.config.configs import TrainerConfig
from paddlebox_tpu_torch.config.flags import ShardFlags, StageFlags
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.parallel.sharded_trainer import ShardedBoxTrainer
from paddlebox_tpu_torch.parallel.sharding import resolve_sharding_policy
from sharded_cluster import (D, HIDDEN, LR, NUM_SLOTS, assert_bits,
                             assert_matches_jax, assert_same_run,
                             cluster_spec, flat_leaves, jax_reference,
                             port_dataset, run_cluster, table_cfg,
                             use_jax_pallas, world_one, write_data)

TABLES = dict(sharding_num_tables=7, sharding_table_shift=2)
# the hot tier's threshold over the summed sketch: pass 1 freezes the
# keys seen at least 30 times (a few), pass 2 (the counts of both passes)
# most of the pass
HOT = dict(sharding_hot_threshold=30)
UID = dict(h2d_lean=True)


def policy_runs(P):
    """(name, the port's run, the JAX flags) of each policy run."""
    grid = dict(TABLES, sharding_policy="2d-grid",
                sharding_grid_rows=2 if P == 4 else 0)
    return [
        ("table-wise", {"shard": dict(TABLES, sharding_policy="table-wise"),
                        "telemetry": P == 2},
         dict(TABLES, sharding_policy="table-wise")),
        ("grid", {"shard": grid}, dict(grid, **HOT)),
        ("grid hot uid", {"shard": dict(grid, **HOT), "stage": UID},
         dict(grid, **HOT)),
        ("grid hot full", {"shard": dict(grid, **HOT)}, dict(grid, **HOT)),
    ]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_data(tmp_path_factory.mktemp("torch_sharded_policies"))


@pytest.fixture(scope="module")
def clusters(data, tmp_path_factory):
    """{P: (refs by JAX flag set, the runs, each rank's results)} for
    P = 2 and 4: one cluster a P (the policy runs, then the split
    hot_cap), the JAX runs beside it."""
    from paddlebox_tpu.config import flags as registry
    files, pfeed = data
    saved = registry.all_flags()
    mp = pytest.MonkeyPatch()
    try:
        use_jax_pallas(mp)
        out = {}
        for P in (2, 4):
            named = policy_runs(P)
            refs = {}
            for name, _, jflags in named:
                key = tuple(sorted(jflags.items()))
                if key not in refs:
                    refs[key] = jax_reference(files, pfeed, P, flags=jflags)
            runs = [dict(run, name=name, new_fleet=i > 0)
                    for i, (name, run, _) in enumerate(named)]
            runs.append({"name": "split cap", "raises": True,
                         "new_fleet": True,
                         "shard": dict(TABLES, sharding_policy="2d-grid",
                                       **HOT),
                         "shard_rank": {1: {"sharding_hot_cap": 1025}}})
            first = next(iter(refs.values()))
            spec = cluster_spec(pfeed, files, P, {"deepfm": first}, runs,
                                sum(p[2] for p in first["passes"]))
            got = run_cluster(P, spec, tmp_path_factory.mktemp("c%d" % P))
            want = [refs[tuple(sorted(j.items()))] for _, _, j in named]
            out[P] = (want, runs, got)
        return out
    finally:
        # the reference's flags as they were: this module-scoped fixture
        # runs outside the per-test flag snapshot (tests/conftest.py)
        mp.undo()
        for name, value in saved.items():
            if registry.get_flag(name) != value:
                registry.set_flag(name, value)


@pytest.mark.parametrize("P", [2, 4])
def test_policies_match_the_jax_sharded_trainer(P, clusters):
    want, runs, got = clusters[P]
    for r, ranks in enumerate(got):
        for i, (w, run) in enumerate(zip(want, runs)):
            res = ranks[i]
            # the plain grid run is held to the hot run's reference: the
            # reference's staging keeps no id off its in-process exchange
            ident = w["policy"]
            if run["name"] == "grid":
                ident = ident.replace("/h30/", "/h0/")
            assert res["policy"] == ident
            assert_matches_jax(res, w, r)
    # the ranks' losses and dense parameters bit-identical
    for i in range(len(want)):
        for ranks in got[1:]:
            assert [p[0] for p in ranks[i]["passes"]] == [
                p[0] for p in got[0][i]["passes"]]
            first = flat_leaves(got[0][i]["params"])
            for k, v in flat_leaves(ranks[i]["params"]).items():
                assert_bits(v, first[k])


@pytest.mark.parametrize("P", [2, 4])
def test_each_rank_holds_only_its_policys_keys(P, clusters):
    """Every stored key is routed to its rank by the run's policy, the
    batches routed through rt_bucketize_sharded, and the ranks' stores
    together hold every key of the JAX run."""
    want, runs, got = clusters[P]
    for i, run in enumerate(runs[:len(want)]):
        pol = resolve_sharding_policy(P, flags=ShardFlags(**run["shard"]))
        keys = []
        for r, ranks in enumerate(got):
            k = ranks[i]["store"][0]
            assert k.size and (pol.shard_of(k) == r).all()
            keys.append(k)
            steps = sum(p[2] for p in ranks[i]["passes"])
            assert ranks[i]["route_counts"] == {"rt_bucketize_sharded":
                                                steps}
        np.testing.assert_array_equal(
            np.sort(np.concatenate(keys)),
            np.sort(np.concatenate([k for k, _ in want[i]["stores"]])))


@pytest.mark.parametrize("P", [2, 4])
def test_hot_tier_agrees_across_ranks_and_with_the_reference(P, clusters):
    """The frozen hot set (pass 2's) is the same on every rank and the
    reference's; on the uid wire the hot ids were kept off the wire and
    added back, the runs bit-identical to the plain grid's (the added
    rows unchanged), and on the full wire nothing was filtered."""
    want, runs, got = clusters[P]
    names = [r["name"] for r in runs]
    grid, uid, full = (names.index(n) for n in ("grid", "grid hot uid",
                                                "grid hot full"))
    ref_hot = want[uid]["hot_keys"]
    assert 0 < ref_hot.size
    for ranks in got:
        for i in (uid, full):
            np.testing.assert_array_equal(ranks[i]["hot_keys"], ref_hot)
            locals_ = ranks[i]["hot_local"]
            assert sum(0 if v is None else v.size
                       for v in locals_.values()) == ref_hot.size
        assert ranks[grid]["hot_keys"].size == 0
        c = ranks[uid]["hot_counts"]
        assert c["dropped"] > 0 and c["readded"] > 0
        assert ranks[full]["hot_counts"] == {}
        assert_same_run(ranks[uid], ranks[grid])
        assert_same_run(ranks[full], ranks[grid])


@pytest.mark.parametrize("P", [2, 4])
def test_a_split_hot_cap_raises_on_every_rank(P, clusters):
    _, runs, got = clusters[P]
    assert runs[-1]["name"] == "split cap"
    for ranks in got:
        assert ranks[-1]["raised"] == "MeshPolicyMismatch"
        assert "/c1024" in ranks[-1]["msg"] and "/c1025" in ranks[-1]["msg"]


def test_rank_zero_merges_the_cluster_record(clusters):
    """The 2-rank table-wise run: rank 0's merged cluster record holds both
    ranks, its health record scores both as the reference's monitor does
    over that record, /health serves it; the aggregator is a
    ClusterAggregator on both ranks."""
    _, runs, got = clusters[2]
    assert runs[0].get("telemetry")
    tel = got[0][0]["telemetry"]
    assert got[1][0]["telemetry"] is None
    cluster, health = tel["cluster"], tel["health"]
    assert cluster["type"] == "cluster_report"
    assert cluster["ranks"] == [0, 1] and cluster["stale_ranks"] == []
    m = cluster["metrics"]["examples_per_sec"]["per_rank"]
    assert set(m) == {"0", "1"}
    assert health["type"] == "cluster_health" and health["world"] == 2
    assert set(health["ranks"]) == {"0", "1"}
    # the health record is the reference's monitor's over the same merged
    # record (a fresh monitor: no rank was stale before)
    from paddlebox_tpu.obs.health import HealthMonitor as JHealth
    want = JHealth(2, drift_warn=0.5).update(cluster)
    assert {k: v for k, v in health.items() if k != "ts"} == {
        k: v for k, v in want.items() if k != "ts"}
    served = dict(tel["served"])
    assert served == {k: v for k, v in health.items()}
    for ranks in got:
        assert ranks[0]["aggregator"] == "ClusterAggregator"


# ------------------------------------------------------------ world one

@pytest.mark.parametrize("policy", [
    dict(TABLES, sharding_policy="table-wise"),
    dict(TABLES, sharding_policy="2d-grid"),
    dict(TABLES, sharding_policy="2d-grid", sharding_hot_threshold=15),
    dict(TABLES, sharding_policy="2d-grid", sharding_hot_threshold=1),
], ids=["table-wise", "grid", "grid-hot", "grid-hot-all"])
@pytest.mark.parametrize("wire", ["full", "uid"])
def test_world_one_policies_equal_key_mod(policy, wire, data):
    """At world 1 (gloo in process) every policy's two passes give the
    key-mod run bit for bit: losses, AUC, the store and the dense
    parameters; the routing went through rt_bucketize_sharded; no
    aggregator at world 1."""
    files, pfeed = data
    torch.manual_seed(5)
    state = {k: v.clone() for k, v in DeepFM(
        ModelSpec(num_slots=NUM_SLOTS, slot_dim=3 + D),
        hidden=HIDDEN).state_dict().items()}
    seeds = [int(x) for x in np.random.RandomState(2).randint(
        0, 2**31 - 1, 64)]
    stage = StageFlags(**(UID if wire == "uid" else {}))
    out = {}
    for name, flags in (("key-mod", {}), ("policy", policy)):
        # a fleet's exchange serves one sharding policy
        fl = world_one()
        try:
            model = DeepFM(ModelSpec(num_slots=NUM_SLOTS, slot_dim=3 + D),
                           hidden=HIDDEN)
            model.load_state_dict(state)
            t = ShardedBoxTrainer(model, table_cfg(), pfeed,
                                  TrainerConfig(dense_lr=LR), seed=0,
                                  fleet=fl, device="cpu", stage_flags=stage,
                                  shard_flags=ShardFlags(**flags))
            assert t.aggregator is None
            t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
            t.seed_fn = iter(seeds).__next__
            res = []
            for _ in range(2):
                ds = port_dataset(pfeed, files)
                ds.set_filelist(files[:4])
                r = t.train_pass(ds)
                res.append((r["loss"],
                            t.metrics.get_metric_msg("auc")["auc"]))
            k, v = t.table.stores[0].state_items()
            o = np.argsort(k)
            out[name] = (res, k[o], v[o], t.params,
                         dict(t.table.route_counts), t.table.hot_frozen,
                         dict(t.hot_counts))
            t.close()
        finally:
            fl.stop()
    a, b = out["key-mod"], out["policy"]
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])
    assert_bits(a[2], b[2])
    for k, v in a[3].items():
        assert_bits(b[3][k], v)
    assert list(a[4]) == ["rt_bucketize"]
    assert list(b[4]) == ["rt_bucketize_sharded"]
    hot = policy.get("sharding_hot_threshold", 0)
    assert (b[5] > 0) == (hot > 0)
    if hot == 1:
        assert b[5] == a[1].size     # every key of the pass frozen
    assert bool(b[6]) == (hot > 0 and wire == "uid")
