"""The pipeline over the sharded table on a (dp 2, stage 2) mesh of 4
gloo ranks (make_mesh(MeshConfig(data=2, pipeline=2)): rank = r * 2 + s
= shard), row r's two ranks loading the files of half r, against the
reference's single-process (2, 2) ShardedCtrPipelineRunner on 4 virtual
CPU devices fed one group at a time from the two halves (reference
tests/test_multihost.py:387-460; pipeline_parity._jax_row_groups).

Each rank's losses against the reference's at rtol 2e-4, the union of the
shard stores against its store_view (integer columns exact), the dense
slices and predict_batches (each row's labels gathered over the dp group)
as tests/pipeline_parity.py assert_sharded_cluster holds them, the probe
step's gradients 2 times the sequential composition's (each row's mean).
A second case feeds uneven halves (row 1 one file, row 0 three): the
feed keys union over the world and every rank steps the world's minimum
of groups, so nothing hangs and the reference's shortest-row cap is met.
"""

import pytest

from pipeline_parity import (assert_sharded_cluster, jax_run,
                             replay_shard_seeds, sharded_pipeline_rank,
                             write_data)
from sharded_cluster import run_cluster

DP, S = 2, 2
RUNS = {"plain": {"form": "plain"}}


def _halves(files, uneven):
    return [files[:3], files[3:]] if uneven else [files[:2], files[2:]]


@pytest.fixture(scope="module", params=[False, True],
                ids=["even", "uneven"])
def cluster(request, tmp_path_factory):
    uneven = request.param
    files, pfeed = write_data(tmp_path_factory.mktemp("torch_pipe_shd_dp"),
                              lines=64, num_files=4)
    halves = _halves(files, uneven)
    spec = {"fn": sharded_pipeline_rank, "feed": pfeed, "dp": DP,
            "row_files": halves, "seeds": replay_shard_seeds(DP * S),
            "runs": RUNS}
    ranks, want = run_cluster(
        DP * S, spec, tmp_path_factory.mktemp("torch_pipe_shd_dp_run"),
        meanwhile=lambda: jax_run("plain", S, pfeed, None, dp=DP,
                                  predict=True, sharded=True,
                                  halves=halves))
    return uneven, ranks, want


def test_sharded_pipeline_dp_matches_jax(cluster):
    uneven, ranks, want = cluster
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert_sharded_cluster(ranks, "plain", "plain", want, dp=DP,
                           loss_rtol=2e-4)
    for r, res in enumerate(ranks):
        got = res["plain"]
        assert (got["dp_rank"], got["stage"]) == divmod(r, S)
        # a row's ranks route their own micro slices: cross-row duplicate
        # keys merge in the owner's dedup, no push crosses the dp group
        c = got["collectives"]
        assert c["all_reduce_dp"] > 0 and c["a2a_push"] == sum(
            p[1] for p in got["passes"])
    steps = [p[1] for p in want["passes"]]
    assert steps == ([1, 1] if uneven else [2, 2]), steps


def test_every_rank_steps_the_world_minimum(cluster):
    """Each half's files hold a group each (64 lines: 4 batches of 16):
    the even rows step 2 groups a pass, the uneven ones row 1's 1 while
    row 0 holds 3; every rank steps alike and drops the rest."""
    uneven, ranks, _ = cluster
    for res in ranks:
        got = res["plain"]
        assert [p[1] for p in got["passes"]] == ([1, 1] if uneven
                                                  else [2, 2])
