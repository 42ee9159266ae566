"""Pipeline parallelism across 4 ranks: GPipeRunner (at S = 4, and the
bubble case of 5 micro-batches through 4 stages) and CtrPipelineRunner
over a stage process group of 4 gloo ranks (device_mesh_1d), against the
JAX runners on 4 virtual CPU devices (tests/conftest.py).

The harness and the tolerances are tests/test_torch_pipeline_cluster.py's
(tests/pipeline_parity.py assert_gpipe_matches_jax, assert_ctr_cluster):
the gradients are 4 times the sequential composition's.
"""

import pytest

from pipeline_parity import (assert_ctr_cluster, assert_gpipe_matches_jax,
                             gpipe_inputs, gpipe_params0, jax_gpipe, jax_run,
                             pipeline_rank, replay_seeds, write_data)
from sharded_cluster import run_cluster

P = 4
GPIPE_NAMES = ("S4", "S4_bubble")
FORMS = ("plain",)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    files, pfeed = write_data(tmp_path_factory.mktemp("torch_pipe_P4"))
    spec = {"fn": pipeline_rank, "feed": pfeed, "files": files,
            "seeds": replay_seeds(), "forms": FORMS,
            "gpipe": {n: gpipe_params0(n) for n in GPIPE_NAMES}}

    def oracle():
        out = {n: jax_gpipe(n, *gpipe_inputs(n)) for n in GPIPE_NAMES}
        out.update({f: jax_run(f, P, pfeed, files, predict=True)
                    for f in FORMS})
        return out

    return run_cluster(P, spec, tmp_path_factory.mktemp("torch_pipe_P4_run"),
                       meanwhile=oracle)


@pytest.mark.parametrize("name", GPIPE_NAMES)
def test_gpipe_matches_jax_across_ranks(cluster, name):
    ranks, want = cluster
    assert [r["coords"] for r in ranks] == [(s,) for s in range(P)]
    assert_gpipe_matches_jax(ranks, name, want[name])


@pytest.mark.parametrize("form", FORMS)
def test_ctr_pipeline_matches_jax_across_ranks(cluster, form):
    ranks, want = cluster
    assert_ctr_cluster(ranks, form, want[form])
