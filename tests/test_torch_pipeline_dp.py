"""Data parallelism over the pipeline: CtrPipelineRunner on a (dp 2, stage
2) mesh of 4 gloo ranks (make_mesh(MeshConfig(data=2, pipeline=2)): rank =
row-major position, each dp row pipelining its own micro-batch group),
against the JAX runner on a (dp, stage) mesh of 4 virtual CPU devices
(tests/conftest.py), in its plain and data_norm forms.

The harness and the tolerances are tests/test_torch_pipeline_cluster.py's
(tests/pipeline_parity.py assert_ctr_cluster): each stage's dense
gradients are the mean of the rows' (2 times the sequential
composition's), its summaries averaged over the rows, one push applies
every row's rows; a stage's params are bit-identical across the rows and
every rank's store across the world. The world's metric registry (stage 0
of each row feeds it, the ranks' tables summed) gives the reference's
single-process message: the instance count exact, the AUC and the error
sums within 1e-4.
"""

import numpy as np
import pytest

from pipeline_parity import (assert_ctr_cluster, jax_run, pipeline_rank,
                             replay_seeds, write_data)
from sharded_cluster import run_cluster

DP, S = 2, 2
FORMS = ("plain", "data_norm")


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    files, pfeed = write_data(tmp_path_factory.mktemp("torch_pipe_dp"))
    spec = {"fn": pipeline_rank, "feed": pfeed, "files": files,
            "seeds": replay_seeds(), "forms": FORMS, "dp": DP}
    return run_cluster(
        DP * S, spec, tmp_path_factory.mktemp("torch_pipe_dp_run"),
        meanwhile=lambda: {f: jax_run(f, S, pfeed, files, dp=DP,
                                      predict=True) for f in FORMS})


def test_make_mesh_lays_ranks_out_row_major(cluster):
    ranks, _ = cluster
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r, res in enumerate(ranks):
        got = res["plain"]
        assert (got["dp_rank"], got["stage"]) == divmod(r, S)


@pytest.mark.parametrize("form", FORMS)
def test_ctr_pipeline_dp_matches_jax(cluster, form):
    ranks, want = cluster
    assert_ctr_cluster(ranks, form, want[form], dp=DP)
    assert [p[1] for p in want[form]["passes"]] == [2, 2]


def test_world_metric_registry_equals_the_reference(cluster):
    ranks, want = cluster
    w = want["plain"]["msg"]
    for res in ranks:
        g = res["plain"]["msg"]
        assert set(g) == set(w)
        for k, v in w.items():
            if isinstance(v, (int, np.integer)):
                assert g[k] == v, k
            else:
                np.testing.assert_allclose(g[k], v, rtol=1e-4, atol=1e-6,
                                           err_msg=k)
