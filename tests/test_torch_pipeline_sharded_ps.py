"""SectionPSTrainer across 4 ranks: the pipeline over the sharded table
with every rank's shard store on one port PSServer (in the test process,
an ephemeral port, stopped in a finally), each rank's
create_trainer("SectionPSTrainer", ps_client=TcpPSClient(...)) on a
(stage,) mesh of 4 gloo ranks, every rank loading all the files; in the
same cluster the local-store run (create_trainer(
"ShardedCtrPipelineTrainer")). The oracle is the JAX
ShardedCtrPipelineRunner on 4 virtual CPU devices over the reference's
ps_store_factory on a PsLocalClient (reference tests/test_multihost.py:
463-509).

The PS run against the reference's as tests/pipeline_parity.py
assert_sharded_cluster holds a run (losses, AUC, dense slices,
predict_batches, S times the sequential composition, live push rows),
and against the local-store run at rtol 1e-4; the server's rows of every
trained key present, against the reference server's and the union of the
local run's shard stores (integer columns exact, rows rtol 1e-4 / atol
1e-6).
"""

import numpy as np
import pytest

from paddlebox_tpu_torch.ps import PSServer
from pipeline_parity import (CAP, assert_sharded_cluster, jax_run,
                             replay_shard_seeds, sharded_pipeline_rank,
                             table_cfg, union_stores, write_data)
from sharded_cluster import assert_store, jax_table_cfg, run_cluster

P = 4
TABLE_ID = 7
SHARD_NUM = 4


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    files, pfeed = write_data(tmp_path_factory.mktemp("torch_pipe_shd_ps"))
    server = PSServer()
    try:
        server.core.create_sparse_table(TABLE_ID, table_cfg(),
                                        shard_num=SHARD_NUM, seed=0)
        runs = {"local": {"form": "plain"},
                "ps": {"form": "plain", "ps": (server.port, TABLE_ID)}}
        spec = {"fn": sharded_pipeline_rank, "feed": pfeed, "files": files,
                "seeds": replay_shard_seeds(P), "runs": runs}

        def oracle():
            from paddlebox_tpu.embedding.ps_store import ps_store_factory
            from paddlebox_tpu.ps import PsLocalClient as JLocal
            client = JLocal()
            client.create_sparse_table(TABLE_ID, jax_table_cfg(cap=CAP),
                                       shard_num=SHARD_NUM, seed=0)
            out = jax_run("plain", P, pfeed, files, predict=True,
                          sharded=True, store_factory=ps_store_factory(
                              client, TABLE_ID))
            out["client"] = client
            return out

        ranks, want = run_cluster(
            P, spec, tmp_path_factory.mktemp("torch_pipe_shd_ps_run"),
            meanwhile=oracle)
        keys = union_stores(ranks, "local")[-1][0]
        got = {"rows": server.core.pull_sparse(TABLE_ID, keys, create=False),
               "size": server.core.sparse_size(TABLE_ID)}
        want["rows"] = want.pop("client").pull_sparse(TABLE_ID, keys,
                                                      create=False)
    finally:
        server.stop()
    return ranks, want, got


def test_section_ps_trainer_matches_jax_over_the_reference_ps(cluster):
    ranks, want, _ = cluster
    for res in ranks:
        assert res["ps"]["stores"] == []
    assert_sharded_cluster(ranks, "ps", "plain", want)


def test_section_ps_trainer_equals_the_local_store_cluster(cluster):
    ranks, _, _ = cluster
    for res in ranks:
        ps, local = res["ps"], res["local"]
        np.testing.assert_allclose(ps["step_losses"], local["step_losses"],
                                   rtol=1e-4)
        for (pl, ps_, pa), (ll, ls, la) in zip(ps["passes"],
                                               local["passes"]):
            assert ps_ == ls
            np.testing.assert_allclose(pl, ll, rtol=1e-4)
            assert abs(pa - la) <= 1e-4
        for k, v in local["params"].items():
            np.testing.assert_allclose(ps["params"][k], v, rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_the_server_holds_every_trained_row(cluster):
    ranks, want, got = cluster
    keys, rows = union_stores(ranks, "local")[-1]
    assert got["size"] == keys.size > 50
    assert_store((keys, got["rows"]), (keys, rows))
    assert_store((keys, got["rows"]), (keys, want["rows"]))
