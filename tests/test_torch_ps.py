"""The port's CPU parameter server (ps/) and its shard store
(embedding/ps_store.py) against the JAX package's.

The server's numpy is the reference's, so on the same inputs it is bit for
bit: numpy_apply_push on random rows and gradients of every rule;
SparseTable's pull, push, assign, shrink, aging, limit_mem and save/load
over one key stream (rows bit-equal); DenseTable's rules over one gradient
stream. The clients: the local dispatch, a TCP roundtrip, a two-client
barrier, and the wire across the packages both ways (a port client
against the reference's server and the reference's client against the
port's, each table made by its own package's client: create_sparse_table
pickles the sender's TableConfig, which the other package's server
refuses). PSBackedStore reaches the server once a table-wide operation,
through its primary. At world 1 in process (gloo), PSGPUTrainer over a
PsLocalClient equals the sharded trainer over its local store bit for bit
(losses, AUC, the server's rows of the pass keys = the local store's), and
over a TcpPSClient equals the local client's run bit for bit.
"""

import pickle
import threading

import numpy as np
import pytest

from paddlebox_tpu_torch.config.configs import (SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.embedding.accessor import PushLayout, ValueLayout
from paddlebox_tpu_torch.embedding.ps_store import (PSBackedStore,
                                                    ps_store_factory)
from paddlebox_tpu_torch.ps import (DenseTable, PSCore, PSServer,
                                    PsLocalClient, SparseTable, TcpPSClient,
                                    numpy_apply_push)
from sharded_cluster import (D, LR, assert_bits, port_dataset, port_model,
                             world_one, write_data)

TABLE_ID = 7


def opt(**kw):
    return dict(dict(mf_create_thresholds=0.5, mf_initial_range=1e-3,
                     feature_learning_rate=0.1, mf_learning_rate=0.1), **kw)


def port_table(**kw):
    return TableConfig(embedx_dim=D, pass_capacity=1 << 12,
                       optimizer=SparseOptimizerConfig(**opt()), **kw)


def jax_table(**kw):
    from paddlebox_tpu.config.configs import SparseOptimizerConfig as JOpt
    from paddlebox_tpu.config.configs import TableConfig as JTable
    return JTable(embedx_dim=D, pass_capacity=1 << 12, optimizer=JOpt(**opt()),
                  **kw)


def random_rows(layout, n, rng):
    rows = layout.new_rows(n, rng, SparseOptimizerConfig(**opt()))
    rows[:, acc.SLOT] = rng.randint(0, 5, n)
    rows[:, acc.SHOW] = rng.randint(1, 20, n)
    rows[:, acc.CLICK] = rng.randint(0, 5, n)
    rows[:, acc.UNSEEN_DAYS] = rng.randint(0, 3, n)
    # half the rows past the embedx creation, half before it
    has = rng.rand(n) < 0.5
    rows[has, acc.MF_SIZE] = D
    w = rows.shape[1] - layout.embedx_w
    rows[has, layout.embedx_w:] = rng.randn(int(has.sum()), w) * 0.01
    return rows.astype(np.float32)


def random_grads(push, rows, rng):
    n = rows.shape[0]
    g = np.zeros((n, push.width), np.float32)
    g[:, push.SLOT] = rows[:, acc.SLOT]
    g[:, push.SHOW] = rng.randint(0, 4, n)      # some zero-show rows
    g[:, push.CLICK] = np.minimum(g[:, push.SHOW], rng.randint(0, 2, n))
    g[:, push.EMBED_G:] = rng.randn(n, push.width - push.EMBED_G) * 0.1
    return g


# ------------------------------------------------------------------ the rule
@pytest.mark.parametrize("rule,expand", [("adagrad", 0), ("naive", 0),
                                         ("adagrad", 3), ("naive", 3)])
def test_numpy_apply_push_is_the_reference_bit_for_bit(rule, expand):
    from paddlebox_tpu.config.configs import SparseOptimizerConfig as JOpt
    from paddlebox_tpu.embedding.accessor import ValueLayout as JLayout
    from paddlebox_tpu.ps.sgd_rule import numpy_apply_push as jpush
    layout = ValueLayout(D, rule, expand_dim=expand)
    push = PushLayout.of(layout)
    rng = np.random.RandomState(5)
    rows = random_rows(layout, 96, rng)
    grads = random_grads(push, rows, rng)
    got = numpy_apply_push(rows, grads, np.random.RandomState(1), layout,
                           SparseOptimizerConfig(**opt()))
    want = jpush(rows, grads, np.random.RandomState(1),
                 JLayout(embedx_dim=D, expand_dim=expand, optimizer=rule),
                 JOpt(**opt()))
    assert_bits(got, want)
    assert not np.array_equal(got, rows)


def test_numpy_apply_push_refuses_the_other_rules():
    for rule in ("adam", "adam_shared"):
        with pytest.raises(NotImplementedError, match="adagrad/naive"):
            numpy_apply_push(np.zeros((1, ValueLayout(D, rule).width),
                                      np.float32),
                             np.zeros((1, 4 + D), np.float32),
                             np.random.RandomState(0), ValueLayout(D, rule),
                             SparseOptimizerConfig())


# ----------------------------------------------------------------- the tables
def key_stream(rng, n_batches=6, vocab=400, size=64):
    return [rng.randint(1, vocab, size).astype(np.uint64)
            for _ in range(n_batches)]


def sparse_ops(t, push, keys_list, rng, tmp, spill=True):
    """pull, push, assign, a limit_mem, a shrink and an aging over one key
    stream; returns every row of the keys seen (create=False) after each
    step and the counts the calls returned."""
    seen = np.unique(np.concatenate(keys_list))
    out, counts = [], []
    for i, keys in enumerate(keys_list):
        rows = t.pull(keys)
        g = np.zeros((keys.size, push.width), np.float32)
        g[:, push.SLOT] = i % 3
        g[:, push.SHOW] = 1.0
        g[:, push.CLICK] = rng.randint(0, 2, keys.size)
        g[:, push.EMBED_G:] = rng.randn(keys.size,
                                        push.width - push.EMBED_G) * 0.1
        t.push(keys, g)
        if i == 2:
            rows[:, acc.SHOW] += 1.0
            t.assign(keys, rows)
        if i == 3 and spill:
            counts.append(t.check_need_limit_mem())
        if i == 4:
            t.age_unseen_days()
            counts.append(t.shrink())
        out.append(t.pull(seen, create=False))
        counts.append(len(t))
    return out, counts


def test_sparse_table_is_the_reference_bit_for_bit(tmp_path):
    from paddlebox_tpu.ps.table import SparseTable as JSparse
    width = ValueLayout(D).width
    mb = 60 * width * 4 / (1 << 20)     # a budget of 60 rows: it spills
    tables = {
        "port": SparseTable(port_table(ssd_dir=str(tmp_path / "p"),
                                       ssd_threshold_mb=mb,
                                       delete_threshold=1.2),
                            shard_num=4, seed=3),
        "jax": JSparse(jax_table(ssd_dir=str(tmp_path / "j"),
                                 ssd_threshold_mb=mb, delete_threshold=1.2),
                       shard_num=4, seed=3)}
    res = {}
    for name, t in tables.items():
        res[name] = sparse_ops(t, t.push_layout,
                               key_stream(np.random.RandomState(2)),
                               np.random.RandomState(4), tmp_path)
    assert res["port"][1] == res["jax"][1]
    spilled = res["port"][1][3]
    assert spilled > 0, res["port"][1]
    for got, want in zip(res["port"][0], res["jax"][0]):
        assert_bits(got, want)
    # save and load: each package reads its own files back
    keys = np.unique(np.concatenate(key_stream(np.random.RandomState(2))))
    for name, t in tables.items():
        before = t.pull(keys, create=False)
        t.save(str(tmp_path / ("ck_" + name)))
        t2 = type(t)(port_table() if name == "port" else jax_table(),
                     shard_num=4, seed=9)
        t2.load(str(tmp_path / ("ck_" + name)))
        res[name] = t2.pull(keys, create=False)
        # the save holds the tier's rows beside the resident ones
        assert_bits(res[name], before)
    assert_bits(res["port"], res["jax"])


def test_dense_table_rules_are_the_reference():
    from paddlebox_tpu.ps.table import DenseTable as JDense
    rng = np.random.RandomState(0)
    grads = [rng.randn(8).astype(np.float32) for _ in range(5)]
    for rule in ("adam", "sgd", "summary"):
        init = rng.randn(8).astype(np.float32)
        p, j = DenseTable(8, rule, 0.1, init), JDense(8, rule, 0.1, init)
        for g in grads:
            p.push(g)
            j.push(g)
        assert_bits(p.pull(), j.pull())
        ps, js = p.state(), j.state()
        assert ps["t"] == js["t"] and ps["rule"] == js["rule"]
        for k in ("params", "mom1", "mom2"):
            assert_bits(ps[k], js[k])
        q = DenseTable(8, rule)
        q.load_state(ps)
        assert_bits(q.pull(), p.pull())
    # one adam step from zero: -lr * m_hat / (sqrt(v_hat) + eps)
    adam = DenseTable(4, rule="adam", lr=0.1)
    adam.push(np.ones(4, np.float32))
    np.testing.assert_allclose(adam.pull(), -0.1 / (1 + 1e-8), rtol=1e-6)
    with pytest.raises(ValueError):
        DenseTable(4, rule="momentum")


# ---------------------------------------------------------------- the clients
def test_local_client_dispatch(tmp_path):
    cl = PsLocalClient()
    cl.create_sparse_table(0, port_table(), shard_num=2)
    cl.create_dense_table("fc", size=16, rule="sgd", lr=0.5)
    keys = np.array([7, 9], np.uint64)
    assert cl.pull_sparse(0, keys).shape == (2, ValueLayout(D).width)
    cl.push_dense("fc", np.ones(16, np.float32))
    np.testing.assert_allclose(cl.pull_dense("fc"), -0.5)
    assert cl.sparse_size(0) == 2
    cl.save(str(tmp_path))
    fresh = PsLocalClient(PSCore())
    fresh.create_sparse_table(0, port_table(), shard_num=2)
    fresh.create_dense_table("fc", size=16)
    fresh.load(str(tmp_path))
    np.testing.assert_allclose(fresh.pull_dense("fc"), -0.5)
    assert fresh.sparse_size(0) == 2
    cl.stop_server()


def test_tcp_roundtrip_is_the_local_client(tmp_path):
    server = PSServer()
    cl = TcpPSClient("127.0.0.1", server.port)
    local = PsLocalClient()
    try:
        for c in (cl, local):
            c.create_sparse_table(5, port_table(), shard_num=2, seed=1)
            c.create_dense_table("w", size=4, rule="adam", lr=0.01)
        push = PushLayout(D)
        out = []
        for c in (cl, local):
            keys = np.array([1, 2, 3, 2], np.uint64)
            before = c.pull_sparse(5, keys)
            g = np.zeros((4, push.width), np.float32)
            g[:, push.SHOW] = 1
            g[:, push.EMBED_G] = 1.0
            c.push_sparse(5, keys, g)
            c.push_dense("w", np.ones(4, np.float32))
            out.append((before, c.pull_sparse(5, keys), c.pull_dense("w"),
                        c.sparse_size(5)))
        for a, b in zip(*out[:2]):
            if isinstance(b, np.ndarray):
                assert_bits(a, b)
            else:
                assert a == b
        assert (out[0][1][:, acc.EMBED_W] != out[0][0][:, acc.EMBED_W]).all()
        cl.save(str(tmp_path / "ps_ck"))
        assert (tmp_path / "ps_ck" / "dense.pkl").exists()
        # a server-side error comes back as the client's RuntimeError
        with pytest.raises(RuntimeError, match="pull_dense"):
            cl.pull_dense("missing")
    finally:
        cl.stop_server()
        cl.close()


def test_tcp_barrier_two_clients():
    server = PSServer()
    results = []
    try:
        def worker(i):
            cl = TcpPSClient("127.0.0.1", server.port)
            try:
                cl.barrier(world=2, timeout=30.0)
                results.append(i)
            finally:
                cl.close()

        ths = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(60.0)
        assert sorted(results) == [0, 1]
        with pytest.raises(TimeoutError):
            server.core.barrier(world=2, timeout=0.05)
    finally:
        server.stop()


def wire_ops(c, table_id, push_width):
    """The numpy-only frames: pull, push, assign, size, limit_mem, shrink,
    age, barrier; each call's result."""
    keys = np.array([3, 11, 19, 3, 27], np.uint64)
    out = [c.pull_sparse(table_id, keys)]
    g = np.zeros((5, push_width), np.float32)
    g[:, 1] = 1.0
    g[:, 3:] = 0.25
    c.push_sparse(table_id, keys, g)
    rows = c.pull_sparse(table_id, keys)
    rows[:, acc.SHOW] += 2.0
    c.assign_sparse(table_id, keys, rows)
    out += [c.pull_sparse(table_id, keys, create=False),
            c.sparse_size(table_id), c.limit_mem(table_id, 2)]
    c.age_unseen_days(table_id)
    out += [c.shrink(table_id), c.pull_sparse(table_id, keys, create=False),
            c.sparse_size(table_id)]
    c.barrier(1, 10.0)
    return out


def test_wire_crosses_the_packages_both_ways(tmp_path):
    from paddlebox_tpu.ps import PSServer as JServer
    from paddlebox_tpu.ps import PsLocalClient as JLocal
    from paddlebox_tpu.ps import TcpPSClient as JClient
    width = PushLayout(D).width
    cfg = dict(ssd_dir=str(tmp_path / "ssd"), ssd_threshold_mb=1.0,
               delete_threshold=1.5)
    jserver, pserver = JServer(), PSServer()
    port_to_jax = TcpPSClient("127.0.0.1", jserver.port)
    jax_to_port = JClient("127.0.0.1", pserver.port)
    try:
        # each side's table made by its own package's client
        JClient("127.0.0.1", jserver.port).create_sparse_table(
            1, jax_table(**cfg), shard_num=2, seed=4)
        TcpPSClient("127.0.0.1", pserver.port).create_sparse_table(
            1, port_table(**cfg), shard_num=2, seed=4)
        jlocal, plocal = JLocal(), PsLocalClient()
        jlocal.create_sparse_table(1, jax_table(**cfg), shard_num=2, seed=4)
        plocal.create_sparse_table(1, port_table(**cfg), shard_num=2, seed=4)
        runs = {"port->jax": wire_ops(port_to_jax, 1, width),
                "jax->port": wire_ops(jax_to_port, 1, width),
                "jax local": wire_ops(jlocal, 1, width),
                "port local": wire_ops(plocal, 1, width)}
        want = runs["jax local"]
        for name, got in runs.items():
            assert len(got) == len(want), name
            for g, w in zip(got, want):
                if isinstance(w, np.ndarray):
                    assert_bits(g, w)
                else:
                    assert g == w, (name, got, want)
        assert want[3] > 0          # the limit spilled rows
        # create_sparse_table pickles the sender's TableConfig: the other
        # package's server refuses it
        with pytest.raises(RuntimeError, match="refusing to unpickle"):
            port_to_jax.create_sparse_table(2, port_table())
        with pytest.raises(RuntimeError, match="refusing to unpickle"):
            jax_to_port.create_sparse_table(2, jax_table())
    finally:
        for c in (port_to_jax, jax_to_port):
            c.stop_server()
            c.close()


def _global_frame(module, name):
    """A protocol-4 pickle whose one op resolves ``module``'s ``name``."""
    def s(x):
        b = x.encode()
        return b"\x8c" + bytes([len(b)]) + b
    return b"\x80\x04" + s(module) + s(name) + b"\x93."


@pytest.mark.parametrize("module,name", [
    ("numpy.lib.npyio", "os.system"),       # a dotted name walks past numpy
    ("numpy", "load"),                      # loads a pickle unrestricted
    ("numpy", "ndarray.__reduce__"),
    ("builtins", "eval"),
    ("paddlebox_tpu_torch.config.configs", "os"),
])
def test_server_refuses_globals_outside_an_array_round_trip(module, name):
    from paddlebox_tpu_torch.ps import service
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        service._loads(_global_frame(module, name))
    # what the frames carry still resolves
    assert service._loads(_global_frame("numpy", "ndarray")) is np.ndarray


def test_server_calls_only_the_core_operations():
    server = PSServer()
    cl = TcpPSClient("127.0.0.1", server.port)
    try:
        for method in ("__class__", "__init__", "_barrier_lock", "sparse"):
            with pytest.raises(RuntimeError, match="unknown ps method"):
                cl._call(method)
        cl.create_dense_table("w", size=2)
        assert cl.pull_dense("w").shape == (2,)
    finally:
        cl.stop_server()
        cl.close()


# ------------------------------------------------------------ the shard store
class CountingClient(PsLocalClient):
    """A local client counting the table-wide calls that reach it."""

    def __init__(self):
        super().__init__()
        self.calls = {}

    def _count(self, name):
        self.calls[name] = self.calls.get(name, 0) + 1

    def sparse_size(self, table_id):
        self._count("sparse_size")
        return self.core.sparse_size(table_id)

    def shrink(self, table_id):
        self._count("shrink")
        return self.core.shrink(table_id)

    def age_unseen_days(self, table_id):
        self._count("age_unseen_days")
        return self.core.age_unseen_days(table_id)

    def limit_mem(self, table_id, max_resident=None):
        self._count("limit_mem")
        return self.core.limit_mem(table_id, max_resident)


@pytest.mark.parametrize("process_primary", [True, False])
def test_ps_store_primary_gating(process_primary, tmp_path):
    cl = CountingClient()
    cfg = port_table(ssd_dir=str(tmp_path), ssd_threshold_mb=1.0)
    cl.create_sparse_table(TABLE_ID, cfg, shard_num=4)
    make = ps_store_factory(cl, TABLE_ID, process_primary=process_primary)
    layout = ValueLayout(D)
    stores = [make(layout, cfg, s) for s in range(4)]
    assert all(isinstance(s, PSBackedStore) for s in stores)
    assert [s.primary for s in stores] == [process_primary, False, False,
                                           False]
    keys = np.arange(1, 41, dtype=np.uint64)
    stores[1].chunk_keys = 16           # chunked: 16 + 16 + 8
    rows = stores[1].lookup_or_create(keys)
    rows[:, acc.SHOW] = 9.0
    stores[2].write_back(keys, rows)
    np.testing.assert_array_equal(stores[3].lookup(keys)[:, acc.SHOW], 9.0)
    miss = stores[0].lookup(np.array([999], np.uint64))
    assert (miss == 0).all()
    assert sum(len(s) for s in stores) == (40 if process_primary else 0)
    for s in stores:
        s.shrink()
        s.age_unseen_days()
        s.tick_spill_age()
        s.spill(8)
    once = 1 if process_primary else 0
    assert cl.calls == ({"sparse_size": once, "shrink": once,
                         "age_unseen_days": 2 * once, "limit_mem": once}
                        if process_primary else {})
    if process_primary:
        # aged twice (age + tick), every row spilled but 8 to the tier
        assert cl.core.sparse_size(TABLE_ID) <= 8
    for name in ("state_items",):
        with pytest.raises(NotImplementedError, match="server-side"):
            getattr(stores[0], name)()
    for name in ("save", "load"):
        with pytest.raises(NotImplementedError, match="server-side"):
            getattr(stores[0], name)("x")
    # the probes the pass table makes: no prefetch, no journal sink
    assert not hasattr(stores[0], "lookup_present")
    assert not hasattr(stores[0], "set_journal_sink")
    assert stores[0].spill_table_wide


# ------------------------------------------- PSGPUTrainer at world 1 in process
@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_data(tmp_path_factory.mktemp("torch_ps"), lines=96)


def run_world_one(fl, files, pfeed, kind, client=None):
    from paddlebox_tpu_torch.train import factory
    name = "ShardedBoxTrainer" if kind == "local" else "PSGPUTrainer"
    kw = {} if kind == "local" else dict(ps_client=client,
                                         ps_table_id=TABLE_ID)
    t = factory.create_trainer(
        name, port_model(None), table_cfg_small(), pfeed,
        TrainerConfig(dense_lr=LR, scan_chunk=1), seed=0, fleet=fl,
        device="cpu", **kw)
    t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    t.seed_fn = iter(range(1000, 2000)).__next__
    res = []
    try:
        for _ in range(2):
            ds = port_dataset(pfeed, files)
            ds.set_filelist(files[:4])
            r = t.train_pass(ds)
            res.append((r["loss"], t.metrics.get_metric_msg("auc")["auc"]))
        keys = np.sort(t.table.shard_keys(0))
        store = t.table.shard.store
        rows = (store.lookup(keys) if kind == "local"
                else client.pull_sparse(TABLE_ID, keys, create=False))
        view_err = None
        try:
            t.table.store_view()
        except TypeError as e:
            view_err = str(e)
        return {"passes": res, "keys": keys, "rows": rows,
                "primary": getattr(store, "primary", None),
                "counters": dict(t.table.counters), "view_err": view_err,
                "prefetch": t.table.promote_prefetch_ctx()}
    finally:
        t.close()


def table_cfg_small():
    return TableConfig(embedx_dim=D, pass_capacity=1024,
                       optimizer=SparseOptimizerConfig(
                           mf_create_thresholds=0.0, mf_initial_range=1e-3))


def test_psgpu_trainer_at_world_one_is_the_local_store_run(data):
    """The server-side rows are key-deterministic (initial_range 0): the
    PS-backed shard and the local store train bit-identically, over the
    in-process client and over TCP."""
    files, pfeed = data
    server = PSServer()
    tcp = TcpPSClient("127.0.0.1", server.port)
    local = PsLocalClient()
    for c in (local, tcp):
        c.create_sparse_table(TABLE_ID, table_cfg_small(), shard_num=8)
    fl = world_one()
    try:
        out = {"local": run_world_one(fl, files, pfeed, "local"),
               "ps": run_world_one(fl, files, pfeed, "ps", local),
               "tcp": run_world_one(fl, files, pfeed, "ps", tcp)}
    finally:
        fl.stop()
        tcp.stop_server()
        tcp.close()
    want = out["local"]
    for name in ("ps", "tcp"):
        got = out[name]
        assert got["passes"] == want["passes"], name
        np.testing.assert_array_equal(got["keys"], want["keys"])
        assert_bits(got["rows"], want["rows"])
        assert got["primary"] is True
        assert "PS-backed shards checkpoint server-side" in got["view_err"]
        # no preload prefetch over a store without lookup_present
        assert got["prefetch"] is None
        assert got["counters"]["pass_rows_promote_hit"] > 0
    assert want["view_err"] is None and want["prefetch"] is not None
    assert local.sparse_size(TABLE_ID) == want["keys"].size
