"""PSGPUTrainer across ranks: the sharded trainer with every rank's shard
store on one CPU parameter server, against the JAX package's.

A PSServer of the port runs in the test process (an ephemeral port,
stopped in a finally); the port runs P = 2 and 4 gloo ranks
(tests/sharded_cluster.py, spawned, a process group timeout and a wall
limit), each create_trainer("PSGPUTrainer", ps_client=TcpPSClient(...))
(rank 0's store the primary), against the JAX ShardedBoxTrainer with the
reference's ps_store_factory over a PsLocalClient on a P-device mesh, with
use_pallas_push (interpreted); every rank replays its shard's push seeds.
A new feature's row is key-deterministic on both servers (initial_range
0). Tolerances, the reference's own (tests/test_multihost.py:229-263):
each pass's loss rtol 1e-4, the cluster AUC 1e-4 absolute, the server's
rows of every pass key rtol 1e-4 / atol 1e-6 with the integer columns
exact.

At P = 4 with an SSD budget on the server and a day boundary
(tests/test_multihost.py:295-368): the spill runs once a pass end through
rank 0's primary and never on the other ranks, the losses after the spill
are finite, and the day reaches the server once: the probed rows' unseen
days 0 -> 1 and their show decayed by the rate once.
"""

import dataclasses

import numpy as np
import pytest

from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.embedding.accessor import ValueLayout
from paddlebox_tpu_torch.ps import PSServer
from sharded_cluster import (D, INT_COLS, assert_params, cluster_spec,
                             jax_reference, jax_table_cfg, run_cluster,
                             table_cfg, use_jax_pallas, write_data)

TABLE_ID, DAY_TABLE_ID = 7, 9
SHARD_NUM = 8
DECAY = 0.5


def day_fields(ssd_dir):
    width = ValueLayout(D).width
    return dict(ssd_dir=str(ssd_dir),
                ssd_threshold_mb=128 * width * 4 / (1 << 20),
                show_click_decay_rate=DECAY, delete_after_unseen_days=30.0,
                delete_threshold=0.0)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_data(tmp_path_factory.mktemp("torch_ps_cluster"), lines=64)


def jax_oracle(files, pfeed, P):
    """The JAX run over the reference's PS: its passes and the server's
    rows of every pass key, sorted."""
    from paddlebox_tpu.config import flags as jflags
    from paddlebox_tpu.embedding.ps_store import ps_store_factory
    from paddlebox_tpu.ps import PsLocalClient as JLocal
    client = JLocal()
    client.create_sparse_table(TABLE_ID, jax_table_cfg(),
                               shard_num=SHARD_NUM, seed=0)
    with pytest.MonkeyPatch.context() as mp:
        old = {k: jflags.get_flag(k)
               for k in ("use_pallas_push", "dataset_disable_shuffle")}
        use_jax_pallas(mp)
        try:
            out = jax_reference(files, pfeed, P,
                                store_factory=ps_store_factory(client,
                                                               TABLE_ID))
        finally:
            for k, v in old.items():
                jflags.set_flag(k, v)
    keys = np.sort(np.concatenate(out["pass_keys"]))
    out["keys"] = keys
    out["rows"] = client.pull_sparse(TABLE_ID, keys, create=False)
    out["size"] = client.sparse_size(TABLE_ID)
    return out


def run_clusters(P, data, tmp_path_factory):
    files, pfeed = data
    root = tmp_path_factory.mktemp("torch_ps_cluster_P%d" % P)
    (root / "out").mkdir()
    server = PSServer()
    try:
        server.core.create_sparse_table(TABLE_ID, table_cfg(),
                                        shard_num=SHARD_NUM, seed=0)
        runs = [{"ps": (server.port, TABLE_ID)}]
        if P == 4:
            fields = day_fields(root / "server_ssd")
            server.core.create_sparse_table(
                DAY_TABLE_ID, dataclasses.replace(table_cfg(), **fields),
                shard_num=SHARD_NUM, seed=0)
            runs.append({"ps": (server.port, DAY_TABLE_ID), "day": True,
                         "table": fields})
        spec = cluster_spec(pfeed, files, P, {"deepfm": jax_reference(
            files, pfeed, P, passes=0)}, runs, 2 * 16)
        ranks, want = run_cluster(P, spec, root / "out",
                                  meanwhile=lambda: jax_oracle(files, pfeed,
                                                               P))
        core = server.core
        got = {"rows": core.pull_sparse(TABLE_ID, want["keys"],
                                        create=False),
               "size": core.sparse_size(TABLE_ID)}
        if P == 4:
            got["day_size"] = core.sparse_size(DAY_TABLE_ID)
    finally:
        server.stop()
    return P, ranks, want, got


@pytest.fixture(scope="module")
def cluster2(data, tmp_path_factory):
    return run_clusters(2, data, tmp_path_factory)


@pytest.fixture(scope="module")
def cluster4(data, tmp_path_factory):
    return run_clusters(4, data, tmp_path_factory)


@pytest.mark.parametrize("cluster", ["cluster2", "cluster4"])
def test_psgpu_trainer_matches_jax_over_the_reference_ps(cluster, request):
    P, ranks, want, got = request.getfixturevalue(cluster)
    for r, res in enumerate(ranks):
        run = res[0]
        assert run["store"] is None
        for (gl, ga, gb), (wl, wa, wb) in zip(run["passes"],
                                              want["passes"]):
            assert gb == wb
            np.testing.assert_allclose(gl, wl, rtol=1e-4)
            assert abs(ga - wa) <= 1e-4, (ga, wa)
        assert_params(run["params"], want["params"])
        # no server-side tier on this table
        assert all(t["ps_rows_spilled"] == 0 for t in run["tier"])
    assert want["keys"].size >= 16
    np.testing.assert_array_equal(got["rows"][:, INT_COLS],
                                  want["rows"][:, INT_COLS])
    np.testing.assert_allclose(got["rows"], want["rows"], rtol=1e-4,
                               atol=1e-6)
    assert (got["rows"][:, acc.SHOW] > 0).all()
    assert got["size"] == want["size"] == want["keys"].size


def test_server_spill_and_day_reach_the_server_once(cluster4):
    P, ranks, _, got = cluster4
    runs = [res[1] for res in ranks]
    # the spill ran at each pass end through rank 0's primary only
    assert all(t["ps_rows_spilled"] > 0 for t in runs[0]["tier"])
    for run in runs[1:]:
        assert all(t["ps_rows_spilled"] == 0 for t in run["tier"])
    # the pass after the spill trained on rows faulted back from the tier
    for run in runs:
        assert all(np.isfinite(l) for l, _, _ in run["passes"])
    day = runs[0]["day"]
    before, after = day["probe_before"], day["probe_after"]
    assert (before[:, acc.UNSEEN_DAYS] == 0).all()
    assert (after[:, acc.UNSEEN_DAYS] == 1).all()
    assert (before[:, acc.SHOW] > 0).all()
    np.testing.assert_allclose(after[:, acc.SHOW],
                               before[:, acc.SHOW] * DECAY, rtol=1e-6)
    assert got["day_size"] > 100
