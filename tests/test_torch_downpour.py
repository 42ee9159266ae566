"""The port's Downpour worker (ps/worker.py) against the JAX package's.

The Communicator merges duplicate keys across queued pushes and sends on
flush; PullDenseWorker refreshes its dense vector in the background. The
flat dense vector is convert.flatten_params' order, the reference's
ravel_pytree order: the same parameters give the same vector bit for bit.
DownpourTrainer with sync_comm=True (the deterministic mode) against the
reference's over a PsLocalClient each, two passes from the same initial
parameters, each pass's batches in the order local_shuffle gives both
packages from the same seed; the dense parameters carry across the passes
through each package's PS dense table. Tolerances: each pass's loss rtol
1e-5; the server's rows of every key rtol 1e-5 / atol 1e-7 with show and
click exact; the dense vector rtol 1e-5 / atol 1e-7 (float32 matmuls and
reductions in another library's order; the sparse and dense rules on the
servers are the same numpy). Over a TcpPSClient the port's run equals its
local-client run bit for bit.
"""

import time

import numpy as np
import pytest

from paddlebox_tpu_torch.config.configs import (SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.convert import flatten_params
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.embedding.accessor import PushLayout
from paddlebox_tpu_torch.ps import PSServer, PsLocalClient, TcpPSClient
from paddlebox_tpu_torch.ps.worker import (Communicator, DownpourTrainer,
                                           PullDenseWorker)
from sharded_cluster import (D, assert_bits, jax_feed, jax_model,
                             port_model, write_data)

LR = 5e-3
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3,
           feature_learning_rate=0.2, mf_learning_rate=0.2)


def port_table():
    return TableConfig(embedx_dim=D, optimizer=SparseOptimizerConfig(**OPT))


def jax_table():
    from paddlebox_tpu.config.configs import SparseOptimizerConfig as JOpt
    from paddlebox_tpu.config.configs import TableConfig as JTable
    return JTable(embedx_dim=D, optimizer=JOpt(**OPT))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    files, pfeed = write_data(tmp_path_factory.mktemp("torch_downpour"),
                              lines=128, num_files=2)
    return files, pfeed


def test_communicator_merges_and_flushes():
    cl = PsLocalClient()
    cl.create_sparse_table(0, port_table(), shard_num=2)
    push = PushLayout(D)
    # only an explicit flush sends: the threshold and interval never fire
    comm = Communicator(cl, 0, push.width, send_batch_threshold=100,
                        send_interval=10.0)
    try:
        g = np.zeros((2, push.width), np.float32)
        g[:, push.SHOW] = 1
        g[:, push.EMBED_G] = 0.5
        comm.push(np.array([5, 5], np.uint64), g)
        comm.push(np.array([5, 9], np.uint64), g)
        assert cl.sparse_size(0) == 0
        comm.flush()
        rows = cl.pull_sparse(0, np.array([5, 9], np.uint64))
        assert rows[0, acc.SHOW] == 3.0  # three merged occurrences of key 5
        assert rows[1, acc.SHOW] == 1.0
    finally:
        comm.stop()
    # the background sender: a push at the threshold goes out by itself
    comm = Communicator(cl, 0, push.width, send_batch_threshold=1,
                        send_interval=0.01)
    try:
        comm.push(np.array([11], np.uint64), g[:1])
        deadline = time.time() + 10
        while cl.sparse_size(0) < 3 and time.time() < deadline:
            time.sleep(0.01)
        assert cl.pull_sparse(0, np.array([11], np.uint64))[0, acc.SHOW] == 1
    finally:
        comm.stop()


def test_pull_dense_worker_refreshes():
    cl = PsLocalClient()
    cl.create_dense_table("w", size=4, rule="sgd", lr=1.0)
    pw = PullDenseWorker(cl, "w", interval=0.02)
    try:
        assert (pw.value == 0).all()
        cl.push_dense("w", np.ones(4, np.float32))
        deadline = time.time() + 10
        while (pw.value == 0).all() and time.time() < deadline:
            time.sleep(0.02)
        np.testing.assert_allclose(pw.value, -1.0)
        cl.push_dense("w", np.ones(4, np.float32))
        np.testing.assert_allclose(pw.refresh(), -2.0)
    finally:
        pw.stop()


def test_flat_dense_vector_is_ravel_pytree_order():
    import jax
    import jax.flatten_util
    jparams = jax_model("deepfm").init(jax.random.PRNGKey(3))
    want = np.asarray(jax.flatten_util.ravel_pytree(jparams)[0])
    assert_bits(flatten_params(port_model(jparams)), want)


def run_port(files, pfeed, jparams, client, passes=2):
    t = DownpourTrainer(port_model(jparams), port_table(), pfeed, client,
                        TrainerConfig(dense_lr=LR), seed=0, sync_comm=True,
                        device="cpu")
    t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    out = []
    try:
        for _ in range(passes):
            ds = BoxDataset(pfeed)
            ds.set_filelist(files)
            r = t.train_pass(ds)
            out.append((r["loss"], r["batches"], r["instances"],
                        t.metrics.get_metric_msg("auc")["auc"]))
        ds = BoxDataset(pfeed)
        ds.set_filelist(files)
        preds = t.predict_pass(ds)
    finally:
        t.close()
    return out, preds


def run_jax(files, pfeed, jparams, passes=2):
    import jax.numpy as jnp
    from paddlebox_tpu.config.configs import TrainerConfig as JTC
    from paddlebox_tpu.data.dataset import BoxDataset as JDataset
    from paddlebox_tpu.ps import PsLocalClient as JLocal
    from paddlebox_tpu.ps.worker import DownpourTrainer as JDownpour
    model = jax_model("deepfm")
    # the reference draws its initial parameters from model.init
    model.init = lambda rng: {k: jnp.asarray(v) for k, v in jparams.items()}
    client = JLocal()
    jfeed = jax_feed(pfeed)
    t = JDownpour(model, jax_table(), jfeed, client, JTC(dense_lr=LR),
                  seed=0, sync_comm=True)
    t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    out = []
    try:
        for _ in range(passes):
            ds = JDataset(jfeed, read_threads=1)
            ds.set_filelist(files)
            r = t.train_pass(ds)
            out.append((r["loss"], r["batches"], r["instances"],
                        t.metrics.get_metric_msg("auc")["auc"]))
        ds = JDataset(jfeed, read_threads=1)
        ds.set_filelist(files)
        preds = t.predict_pass(ds)
    finally:
        t.close()
    return out, preds, client


def server_state(client, keys, name=DownpourTrainer.DENSE_TABLE):
    return (client.pull_sparse(DownpourTrainer.SPARSE_TABLE, keys,
                               create=False), client.pull_dense(name))


@pytest.fixture(scope="module")
def runs(data):
    import jax
    files, pfeed = data
    jparams = {k: np.asarray(v) for k, v in jax_model("deepfm").init(
        jax.random.PRNGKey(0)).items()}
    jout, jpreds, jclient = run_jax(files, pfeed, jparams)
    local = PsLocalClient()
    pout, ppreds = run_port(files, pfeed, jparams, local)
    ds = BoxDataset(pfeed)
    ds.set_filelist(files)
    ds.load_into_memory()
    keys = np.unique(ds.all_keys())
    server = PSServer()
    tcp = TcpPSClient("127.0.0.1", server.port)
    try:
        tout, tpreds = run_port(files, pfeed, jparams, tcp)
        tcp_state = server_state(tcp, keys)
    finally:
        tcp.stop_server()
        tcp.close()
    return {"keys": keys,
            "jax": (jout, jpreds, server_state(jclient, keys)),
            "local": (pout, ppreds, server_state(local, keys)),
            "tcp": (tout, tpreds, tcp_state)}


def test_downpour_matches_the_reference(runs):
    (pout, ppreds, (prows, pdense)) = runs["local"]
    (jout, jpreds, (jrows, jdense)) = runs["jax"]
    for (pl, pb, pi, pa), (jl, jb, ji, ja) in zip(pout, jout):
        assert (pb, pi) == (jb, ji)
        np.testing.assert_allclose(pl, jl, rtol=1e-5)
        assert abs(pa - ja) <= 1e-4, (pa, ja)
    assert pout[1][0] < pout[0][0]          # it learns
    np.testing.assert_array_equal(prows[:, [acc.SHOW, acc.CLICK]],
                                  jrows[:, [acc.SHOW, acc.CLICK]])
    assert (prows[:, acc.SHOW] > 0).all()
    np.testing.assert_allclose(prows, jrows, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(pdense, jdense, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(ppreds[1], jpreds[1])
    np.testing.assert_allclose(ppreds[0], jpreds[0], rtol=1e-5, atol=1e-6)


def test_downpour_over_tcp_is_the_local_client_bit_for_bit(runs):
    (pout, ppreds, (prows, pdense)) = runs["local"]
    (tout, tpreds, (trows, tdense)) = runs["tcp"]
    assert tout == pout
    assert_bits(trows, prows)
    assert_bits(tdense, pdense)
    assert_bits(tpreds[0], ppreds[0])
