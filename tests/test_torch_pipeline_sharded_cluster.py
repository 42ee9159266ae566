"""The pipeline over the sharded table across 4 ranks: ShardedCtrPipeline-
Runner on a (stage,) mesh of 4 gloo ranks (device_mesh_1d: rank = stage =
shard, every rank loading all the files), against the JAX
ShardedCtrPipelineRunner on 4 virtual CPU devices (tests/conftest.py),
each rank replaying its flat index's push seeds
(pipeline_parity.replay_shard_seeds), in its plain and multi-task forms.

tests/pipeline_parity.py assert_sharded_cluster: each rank's step and
pass losses (the first step rtol 1e-5, then 1e-4), the world's AUC within
1e-4 (multi-task: 2e-4, AUC_ATOL), its stage's dense slices (rtol 2e-4 /
atol 1e-6) and predict_batches against the reference's, the ranks bit-identical to each
other; the union of the ranks' shard stores after each pass against the
reference's store_view (integer columns exact, rows rtol 1e-4 / atol
1e-6); the probe step's gradients 4 times the sequential composition's,
its push rows' embed columns not all zero on every rank. Also: a pull and
a push all-to-all, an all_gather over the stage group and one host
exchange a step on every rank, and a runner over a mesh of half the world
refused.
"""

import pytest

from pipeline_parity import (assert_sharded_cluster, jax_run,
                             replay_shard_seeds, sharded_pipeline_rank,
                             write_data)
from sharded_cluster import run_cluster

P = 4
RUNS = {"plain": {"form": "plain"}, "multi_task": {"form": "multi_task"}}
# the world's AUC: the multi-task head's ctr predictions sit within 0.01
# of 0.49 after two passes, a few of the AUC table's 2^14 buckets wide,
# so the reference's and the port's, equal to 2.4e-7 (predict_batches
# holds them to 1e-6), move a few pairs across a bucket edge: 1.06e-4
AUC_ATOL = {"plain": 1e-4, "multi_task": 2e-4}


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    files, pfeed = write_data(tmp_path_factory.mktemp("torch_pipe_shd_P4"))
    spec = {"fn": sharded_pipeline_rank, "feed": pfeed, "files": files,
            "seeds": replay_shard_seeds(P), "runs": RUNS, "refusal": True}
    return run_cluster(
        P, spec, tmp_path_factory.mktemp("torch_pipe_shd_P4_run"),
        meanwhile=lambda: {n: jax_run(r["form"], P, pfeed, files,
                                      predict=True, sharded=True)
                           for n, r in RUNS.items()})


@pytest.mark.parametrize("name", sorted(RUNS))
def test_sharded_pipeline_matches_jax_across_ranks(cluster, name):
    ranks, want = cluster
    assert [r["coords"] for r in ranks] == [(s,) for s in range(P)]
    assert_sharded_cluster(ranks, name, RUNS[name]["form"], want[name],
                           auc_atol=AUC_ATOL[name])
    assert [p[1] for p in want[name]["passes"]] == [4, 4]


def test_collectives_a_step_and_the_half_mesh_refusal(cluster):
    ranks, _ = cluster
    for res in ranks:
        got = res["plain"]
        steps = sum(p[1] for p in got["passes"])
        # the probe step pulls twice (its block, then forward_backward)
        # and pushes none; the stage group sums the cotangent once a step
        c = got["collectives"]
        assert (c["a2a_pull"], c["a2a_push"], c["all_gather_stage"],
                c["all_reduce_stage"]) == (steps + 2, steps, steps + 2,
                                           steps + 1), c
        assert "all_reduce_dp" not in c
        assert got["exchanges"] >= steps + 1
        assert "spans the world" in res["refusal"], res["refusal"]
