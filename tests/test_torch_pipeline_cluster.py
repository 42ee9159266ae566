"""Pipeline parallelism across 2 ranks: GPipeRunner and CtrPipelineRunner
over a stage process group of 2 gloo ranks (device_mesh_1d), against the
JAX runners on 2 virtual CPU devices (tests/conftest.py).

Each rank is spawned by tests/sharded_cluster.py run_cluster (a process
group timeout and a wall limit; the oracle runs meanwhile) and runs the
GPipe configuration from the reference's initial params and the CTR
runner's plain and multi-task forms over all the files (the table is
replicated over the group), two passes each, the reference's push seeds
replayed, on data with live push gradients. Held (tests/pipeline_parity.py
assert_gpipe_matches_jax, assert_ctr_cluster): GPipe's forward and
sequential forward rtol 1e-5 / atol 1e-6, its step losses rtol 1e-5, its
final params rtol 2e-4 / atol 1e-6, its gradients 2 times the sequential
composition's (rtol 1e-5); the CTR runs at the single-process file's
tolerances (the first step's loss rtol 1e-5, the losses rtol 1e-4, the
world's AUC within 1e-4, the params rtol 2e-4 / atol 1e-6, the stores'
integer columns exact), every rank's stores bit-identical, predict_batches
the reference's on every rank, a trained step's gradients 2 times the
sequential composition's with live embed_w and embedx push columns.
"""

import pytest

from pipeline_parity import (assert_ctr_cluster, assert_gpipe_matches_jax,
                             gpipe_inputs, gpipe_params0, jax_gpipe, jax_run,
                             pipeline_rank, replay_seeds, write_data)
from sharded_cluster import run_cluster

P = 2
GPIPE_NAMES = ("S2",)
FORMS = ("plain", "multi_task")


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    files, pfeed = write_data(tmp_path_factory.mktemp("torch_pipe_P2"))
    spec = {"fn": pipeline_rank, "feed": pfeed, "files": files,
            "seeds": replay_seeds(), "forms": FORMS,
            "gpipe": {n: gpipe_params0(n) for n in GPIPE_NAMES}}

    def oracle():
        out = {n: jax_gpipe(n, *gpipe_inputs(n)) for n in GPIPE_NAMES}
        out.update({f: jax_run(f, P, pfeed, files, predict=True)
                    for f in FORMS})
        return out

    return run_cluster(P, spec, tmp_path_factory.mktemp("torch_pipe_P2_run"),
                       meanwhile=oracle)


@pytest.mark.parametrize("name", GPIPE_NAMES)
def test_gpipe_matches_jax_across_ranks(cluster, name):
    ranks, want = cluster
    assert [r["coords"] for r in ranks] == [(0,), (1,)]
    assert_gpipe_matches_jax(ranks, name, want[name])


@pytest.mark.parametrize("form", FORMS)
def test_ctr_pipeline_matches_jax_across_ranks(cluster, form):
    ranks, want = cluster
    assert_ctr_cluster(ranks, form, want[form])
