"""Heterogeneous training: the port's fleet/heter.py (HeterDenseService,
HeterDenseClient, HeterTrainer) against the JAX package's.

Each pair is a HeterTrainer over a PsLocalClient and a dense service on
this process's threads, reached over loopback TCP, bound to an ephemeral
port and stopped in a finally. The service's model starts from the
reference's initial parameters (the port's DeepFM loads them by
convert.params_from_jax). The worker's pushes reach the server every
batch: the port's HeterTrainer with sync_comm, the reference's with a
Communicator that flushes after each push (``_SyncComm``), so that each
batch's pull reads the last batch's push in both. Tolerances: each pass's
loss rtol 1e-5 and AUC within 1e-4; the server's rows of every key rtol
1e-5 / atol 1e-7 with show and click exact; predictions rtol 1e-5 / atol
1e-6 (float32 matmuls and reductions in another library's order; the
sparse rule on the servers is the same numpy).
"""

import pickle

import numpy as np
import pytest

from paddlebox_tpu_torch.config.configs import (SparseOptimizerConfig,
                                                TableConfig)
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.fleet.heter import (HeterDenseClient,
                                             HeterDenseService, HeterTrainer)
from paddlebox_tpu_torch.ps import PsLocalClient
from paddlebox_tpu_torch.train import factory
from paddlebox_tpu_torch.utils.rpc import FramedClient, ndarray_loads
from sharded_cluster import D, jax_feed, jax_model, port_model, write_data

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
    import jax
    files, pfeed = write_data(tmp_path_factory.mktemp("torch_heter"),
                              lines=128, num_files=2)
    jparams = {k: np.asarray(v) for k, v in jax_model("deepfm").init(
        jax.random.PRNGKey(0)).items()}
    ds = BoxDataset(pfeed)
    ds.set_filelist(files)
    ds.load_into_memory()
    return files, pfeed, jparams, np.unique(ds.all_keys())


def port_service(pfeed, jparams):
    return HeterDenseService(port_model(jparams), pfeed, dense_lr=LR,
                             device="cpu")


def jax_service(pfeed, jparams):
    import jax.numpy as jnp
    from paddlebox_tpu.fleet.heter import HeterDenseService as JService
    model = jax_model("deepfm")
    # the reference draws its initial parameters from model.init
    model.init = lambda rng: {k: jnp.asarray(v) for k, v in jparams.items()}
    return JService(model, jax_feed(pfeed), dense_lr=LR, seed=0)


def port_worker(pfeed, port):
    client = PsLocalClient()
    return HeterTrainer(client, HeterDenseClient("127.0.0.1", port),
                        port_table(), pfeed, seed=0, sync_comm=True)


def jax_worker(pfeed, port):
    from paddlebox_tpu.fleet.heter import HeterDenseClient as JClient
    from paddlebox_tpu.fleet.heter import HeterTrainer as JHeter
    from paddlebox_tpu.ps import PsLocalClient as JLocal
    from paddlebox_tpu.ps.worker import Communicator as JComm

    class _SyncComm(JComm):
        """The reference's Communicator, its pushes sent at each push."""

        def push(self, keys, grads):
            super().push(keys, grads)
            self.flush()

    t = JHeter(JLocal(), JClient("127.0.0.1", port), jax_table(),
               jax_feed(pfeed), seed=0)
    t.communicator.stop()
    t.communicator = _SyncComm(t.client, t.SPARSE_TABLE,
                               t.push_layout.width,
                               send_batch_threshold=1 << 30,
                               send_interval=3600.0)
    return t


def run_pair(files, pfeed, keys, service, worker, passes=2):
    """``passes`` passes of ``worker`` against ``service`` (stopped in a
    finally), then predict_pass: each pass's (loss, batches, instances,
    AUC), the server's rows of ``keys``, the predictions and the server's
    size around predict_pass."""
    from paddlebox_tpu.data.dataset import BoxDataset as JDataset
    jax_side = type(worker).__module__.startswith("paddlebox_tpu.")

    def dataset():
        ds = (JDataset(jax_feed(pfeed), read_threads=1) if jax_side
              else BoxDataset(pfeed))
        ds.set_filelist(files)
        return ds

    out = []
    try:
        worker.metrics.init_metric("auc", "label", "pred",
                                   table_size=1 << 14)
        for _ in range(passes):
            r = worker.train_pass(dataset())
            out.append((r["loss"], r["batches"], r["instances"],
                        worker.metrics.get_metric_msg("auc")["auc"]))
        size = worker.client.sparse_size(worker.SPARSE_TABLE)
        preds = worker.predict_pass(dataset())
        sizes = (size, worker.client.sparse_size(worker.SPARSE_TABLE))
        rows = worker.client.pull_sparse(worker.SPARSE_TABLE, keys,
                                         create=False)
    finally:
        worker.close()
        worker.heter.close()
        service.stop()
    return {"passes": out, "rows": rows, "preds": preds, "sizes": sizes}


@pytest.fixture(scope="module")
def runs(data):
    files, pfeed, jparams, keys = data
    out = {}
    for name, make_service, make_worker in (
            ("port", port_service, port_worker),
            ("jax", jax_service, jax_worker),
            ("jax_worker_port_service", port_service, jax_worker),
            ("port_worker_jax_service", jax_service, port_worker)):
        service = make_service(pfeed, jparams)
        try:
            worker = make_worker(pfeed, service.port)
        except BaseException:
            service.stop()
            raise
        out[name] = run_pair(files, pfeed, keys, service, worker)
    return out


def assert_close_runs(got, want):
    for (gl, gb, gi, ga), (wl, wb, wi, wa) in zip(got["passes"],
                                                  want["passes"]):
        assert (gb, gi) == (wb, wi)
        np.testing.assert_allclose(gl, wl, rtol=1e-5)
        assert abs(ga - wa) <= 1e-4, (ga, wa)
    cols = [acc.SHOW, acc.CLICK]
    np.testing.assert_array_equal(got["rows"][:, cols], want["rows"][:, cols])
    np.testing.assert_allclose(got["rows"], want["rows"], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(got["preds"][1], want["preds"][1])
    np.testing.assert_allclose(got["preds"][0], want["preds"][0], rtol=1e-5,
                               atol=1e-6)


def test_heter_matches_the_reference(runs):
    got, want = runs["port"], runs["jax"]
    assert_close_runs(got, want)
    assert got["passes"][1][0] < got["passes"][0][0]      # it learns
    assert (got["rows"][:, acc.SHOW] > 0).all()


@pytest.mark.parametrize("pair", ["jax_worker_port_service",
                                  "port_worker_jax_service"])
def test_heter_crosses_between_the_packages(runs, pair):
    """The reference's worker and client against the port's service, and
    the port's against the reference's: each run at the same gates as the
    port's own pair."""
    assert_close_runs(runs[pair], runs["port"])


@pytest.mark.parametrize("pair", ["port", "jax_worker_port_service"])
def test_predict_pass_inserts_nothing(runs, pair):
    before, after = runs[pair]["sizes"]
    assert before == after == runs[pair]["rows"].shape[0]
    preds, labels = runs[pair]["preds"]
    assert preds.shape == labels.shape and preds.size > 0


def test_service_refuses_globals_outside_an_ndarray_round_trip(data):
    """A frame carrying a numpy global the reference's service would take
    (a RandomState's constructor) or any other class is refused, and the
    connection serves the next frame."""
    _, pfeed, jparams, _ = data
    service = port_service(pfeed, jparams)
    client = FramedClient("127.0.0.1", service.port, ndarray_loads)
    try:
        assert b"numpy.random" in pickle.dumps(np.random.RandomState(0))
        for bad in (np.random.RandomState(0), pickle.PickleError("x")):
            with pytest.raises(RuntimeError, match="refusing to unpickle"):
                client.call({"method": "eval_step", "emb": bad,
                             "batch": {}})
        with pytest.raises(RuntimeError, match="unknown heter method"):
            client.call({"method": "no_such_step"})
    finally:
        client.close()
        service.stop()


def test_factory_builds_the_worker(data):
    files, pfeed, jparams, _ = data
    service = port_service(pfeed, jparams)
    heter = HeterDenseClient("127.0.0.1", service.port)
    try:
        for name in ("HeterTrainer", "HeterCpuWorker"):
            t = factory.create_trainer(name, PsLocalClient(), heter,
                                       port_table(), pfeed, seed=0)
            assert isinstance(t, HeterTrainer)
            t.close()
        heter.stop_server()
    finally:
        heter.close()
        service.stop()
