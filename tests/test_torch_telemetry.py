"""The cluster telemetry plane against the JAX package's: the framed RPC
transport (frames interchangeable both ways), the KV store (every
operation, the port's client on the reference's server and the other way
round), the elastic heartbeat manager (a stopped rank declared dead
within stale_after, DeadRankError through RecoverableRunner),
merge_cluster_reports and HealthMonitor.update on the same scripted
reports (the stale, warning, error, depth, burn, drift, calibration,
recompile and donation penalties), the ClusterAggregator over the store
transport (its merge, stale ranks and publish backoff) and the trainer's
wiring (make_cluster_aggregator, obs_rank_world; None at world 1).
"""

import copy
import threading
import time

import numpy as np
import pytest

from paddlebox_tpu_torch.config.flags import ObsFlags
from paddlebox_tpu_torch.fleet.elastic import DeadRankError, ElasticManager
from paddlebox_tpu_torch.fleet.fleet import Fleet
from paddlebox_tpu_torch.fleet.role_maker import RoleMaker
from paddlebox_tpu_torch.fleet.store import KVStoreServer, TcpStoreClient
from paddlebox_tpu_torch.obs import (aggregate, health,
                                     make_cluster_aggregator,
                                     obs_rank_world)
from paddlebox_tpu_torch.obs.report import ListSink
from paddlebox_tpu_torch.train.recovery import RecoverableRunner
from paddlebox_tpu_torch.utils import rpc


# --------------------------------------------------------------- the RPC

def handler(req):
    if req.get("op") == "boom":
        raise KeyError("boom")
    return {"echo": req, "n": len(req)}


@pytest.mark.parametrize("client_pkg", ["port", "ref"])
@pytest.mark.parametrize("server_pkg", ["port", "ref"])
def test_rpc_frames_interchange(client_pkg, server_pkg):
    """Every client against every server: the same results, the server's
    error as the client's RuntimeError, a class refused by plain_loads,
    and a frame over max_frame_bytes answered with an error."""
    from paddlebox_tpu.utils import rpc as jrpc
    mod = rpc if client_pkg == "port" else jrpc
    smod = rpc if server_pkg == "port" else jrpc
    srv = smod.FramedServer(handler)
    small = smod.FramedServer(handler, max_frame_bytes=64)
    try:
        cl = mod.FramedClient("127.0.0.1", srv.port, timeout=10)
        req = {"op": "x", "key": "k", "value": b"\x00\x01" * 50,
               "n": [1, 2.5, None, ("t",)]}
        assert cl.call(req) == handler(req)
        with pytest.raises(RuntimeError, match="boom"):
            cl.call({"op": "boom"})
        assert cl.call({"op": "after"}) == handler({"op": "after"})
        with pytest.raises(RuntimeError, match="refusing to unpickle"):
            cl.call({"op": "x", "v": np.float64(1.0)})
        cl.close()
        cl2 = mod.FramedClient("127.0.0.1", small.port, timeout=10)
        with pytest.raises(RuntimeError, match="exceeds server max"):
            cl2.call({"op": "x", "v": b"y" * 256})
        cl2.close()
    finally:
        srv.stop()
        small.stop()


def test_rpc_dial_fails_within_the_timeout():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.monotonic()
    with pytest.raises(OSError):
        rpc.FramedClient("127.0.0.1", port, timeout=2.0)
    assert time.monotonic() - t0 < 5.0


def test_make_loads_allows_what_its_predicate_allows():
    import pickle
    loads = rpc.make_loads(lambda m, n: m == "collections")
    import collections
    od = collections.OrderedDict(a=1)
    assert loads(pickle.dumps(od)) == od
    with pytest.raises(pickle.UnpicklingError):
        loads(pickle.dumps(np.zeros(2)))


# --------------------------------------------------------------- the store

def store_script(cl):
    """Every store operation; the results in order (errors by type)."""
    out = []

    def do(fn, *a, **k):
        try:
            out.append(fn(*a, **k))
        except Exception as e:  # the operation's result
            out.append(type(e).__name__ + ":" + str(e).split(":")[0])

    do(cl.get, "missing")
    do(cl.set, "a", b"1")
    do(cl.set, "b/c", b"\x00" * 10)
    do(cl.get, "a")
    do(cl.wait, "a", 1.0)
    do(cl.wait, "never", 0.2)
    do(cl.add, "n")
    do(cl.add, "n", 5)
    do(cl.counter, "n")
    do(cl.counter, "zero")
    do(cl.wait_counter_ge, "n", 3, 1.0)
    do(cl.wait_counter_ge, "n", 100, 0.2)
    do(cl.keys)
    do(cl.delete, "a")
    do(cl.delete, "n")
    do(cl.counter, "n")
    do(cl.get, "a")
    do(cl.keys)
    return out


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("port", "port"), ("port", "ref"), ("ref", "port")])
def test_store_operations_match_the_reference(client_pkg, server_pkg):
    from paddlebox_tpu.fleet import store as jstore
    ref_srv = jstore.KVStoreServer("127.0.0.1", 0)
    want = store_script(jstore.TcpStoreClient("127.0.0.1", ref_srv.port))
    ref_srv.stop()
    srv = (KVStoreServer if server_pkg == "port"
           else jstore.KVStoreServer)("127.0.0.1", 0)
    cls = TcpStoreClient if client_pkg == "port" else jstore.TcpStoreClient
    try:
        cl = cls("127.0.0.1", srv.port, timeout=10)
        assert store_script(cl) == want
        assert want[5].startswith("RuntimeError") \
            and want[11].startswith("RuntimeError")
        cl.close()
    finally:
        srv.stop()


def test_store_wait_wakes_on_a_set_from_another_client():
    srv = KVStoreServer("127.0.0.1", 0)
    try:
        a = TcpStoreClient("127.0.0.1", srv.port)
        b = TcpStoreClient("127.0.0.1", srv.port)
        got = {}
        th = threading.Thread(target=lambda: got.update(
            v=a.wait("late", 10.0), c=a.wait_counter_ge("c", 2, 10.0)))
        th.start()
        time.sleep(0.1)
        b.set("late", b"here")
        b.add("c")
        b.add("c")
        th.join(10.0)
        assert got == {"v": b"here", "c": 2}
    finally:
        srv.stop()


# ------------------------------------------------------------- elastic

def watch_death(mod, server_cls, client_cls, interval=0.05, stale=0.5):
    """Two managers of one store; rank 1 stops: (dead ranks, seconds from
    its stop to rank 0's verdict, faults seen, the alive check before)."""
    srv = server_cls("127.0.0.1", 0)
    try:
        faults = []
        m0 = mod.ElasticManager(client_cls("127.0.0.1", srv.port), 0, 2,
                                heartbeat_interval=interval,
                                stale_after=stale, on_fault=faults.append)
        m1 = mod.ElasticManager(client_cls("127.0.0.1", srv.port), 1, 2,
                                heartbeat_interval=interval,
                                stale_after=stale)
        m0.start()
        m1.start()
        time.sleep(4 * interval + stale)
        alive = m0.dead_ranks
        m0.check()
        m1.stop()
        t0 = time.monotonic()
        while not m0.dead_ranks and time.monotonic() - t0 < 10:
            time.sleep(interval / 2)
        secs = time.monotonic() - t0
        dead = m0.dead_ranks
        with pytest.raises(mod.DeadRankError, match=r"\[1\]"):
            m0.check()
        m0.stop()
        return dead, secs, faults, alive
    finally:
        srv.stop()


def test_elastic_declares_a_stopped_rank_dead_as_the_reference():
    from paddlebox_tpu.fleet import elastic as jelastic
    from paddlebox_tpu.fleet import store as jstore
    import paddlebox_tpu_torch.fleet.elastic as pelastic
    got = watch_death(pelastic, KVStoreServer, TcpStoreClient)
    want = watch_death(jelastic, jstore.KVStoreServer, jstore.TcpStoreClient)
    for dead, secs, faults, alive in (got, want):
        assert dead == [1] and faults == [[1]] and alive == []
        # stale_after of silence on the watcher's clock, a heartbeat or two
        # of slack
        assert 0.3 < secs < 0.5 + 1.0


class StubTrainer:
    def __init__(self, on_pass):
        self.on_pass = on_pass
        self.passes = 0
        self.params, self.opt_state = {}, {}

    def train_pass(self, ds):
        self.passes += 1
        self.on_pass(self.passes)
        return {"loss": 0.0}

    def random_state(self):
        return {}


class StubCkpt:
    def __init__(self, root):
        import types
        self.cfg = types.SimpleNamespace(batch_model_dir=root + "/b",
                                         xbox_model_dir=root + "/x")
        self.saved = []

    def save_base(self, *a, **k):
        self.saved.append(k["day"])

    def wait(self):
        pass


def test_dead_rank_error_stops_the_recoverable_runner(tmp_path):
    """A peer stops during pass 0: the runner saves pass 0, and the check
    before pass 1 raises DeadRankError."""
    srv = KVStoreServer("127.0.0.1", 0)
    try:
        m0 = ElasticManager(TcpStoreClient("127.0.0.1", srv.port), 0, 2,
                            heartbeat_interval=0.05, stale_after=0.3)
        m1 = ElasticManager(TcpStoreClient("127.0.0.1", srv.port), 1, 2,
                            heartbeat_interval=0.05, stale_after=0.3)
        m0.start()
        m1.start()
        time.sleep(0.3)

        def on_pass(i):
            m1.stop()
            t0 = time.monotonic()
            while not m0.dead_ranks and time.monotonic() - t0 < 10:
                time.sleep(0.02)

        trainer, ckpt = StubTrainer(on_pass), StubCkpt(str(tmp_path))
        runner = RecoverableRunner(trainer, ckpt, "20240101", elastic=m0)
        with pytest.raises(DeadRankError):
            runner.run([None, None, None], resume=False)
        assert trainer.passes == 1 and ckpt.saved == ["20240101/pass-0"]
        m0.stop()
    finally:
        srv.stop()


# ------------------------------------------------------ merge and health

def scripted_reports():
    """Windows of per-rank StepReports over 4 ranks exercising every
    penalty, the histogram sum and the per-rank metrics."""
    def rep(rank, step, **kw):
        r = {"type": "step_report", "v": 1, "ts": 1.0, "rank": rank,
             "step": step, "examples_per_sec": 100.0 + 7 * rank,
             "stats": {"hostplane_exchange_bytes": 1000 * (rank + 1)},
             "gauges": {"beat_age_s": 0.5, "chan_dataset_depth": 3.0},
             "timers": {"step": {"ms": 10.0 + rank, "calls": 4}},
             "hists": {"hostplane_exchange_us": {
                 "counts": [0, rank, 2, 1 + rank] + [0] * (rank % 3)}}}
        for k, v in kw.items():
            sect, name = k.split("__")
            r[sect][name] = v
        return r

    return [
        [rep(0, 5), rep(1, 5), rep(2, 5), rep(3, 6)],
        [rep(0, 10), rep(2, 10, stats__log_warning_lines=2),
         rep(3, 10, stats__log_error_lines=1,
             gauges__chan_dataset_depth=100.0)],
        [rep(0, 15, gauges__beat_age_s=45.0),
         rep(2, 15, gauges__data_drift_score=0.7,
             gauges__quality_copc=1.6),
         rep(3, 15, stats__device_recompiles=2,
             gauges__serving_slo_burn=1.5)],
        [rep(0, 20, stats__donation_miss=1, stats__rpc_handler_errors=3),
         rep(1, 20, gauges__tier_hit_burn=2.0,
             gauges__serving_freshness_burn=1.2,
             gauges__quality_copc=0.5),
         rep(2, 20), rep(3, 20, gauges__data_drift_score=0.49)],
    ]


def strip_ts(rec):
    rec = copy.deepcopy(rec)
    rec.pop("ts", None)
    return rec


def test_merge_and_health_match_the_reference():
    """merge_cluster_reports of each window (stale ranks added as the
    aggregator adds them) and HealthMonitor.update over the windows: the
    reference's dicts, ts aside."""
    from paddlebox_tpu.obs import aggregate as jaggregate
    from paddlebox_tpu.obs import health as jhealth
    hm = health.HealthMonitor(4, drift_warn=0.5)
    jhm = jhealth.HealthMonitor(4, drift_warn=0.5)
    flags_seen = set()
    for window in scripted_reports():
        got = aggregate.merge_cluster_reports(copy.deepcopy(window))
        want = jaggregate.merge_cluster_reports(copy.deepcopy(window))
        assert got == want
        stale = sorted(set(range(4)) - {r["rank"] for r in window})
        got["stale_ranks"] = want["stale_ranks"] = stale
        h, jh = hm.update(got), jhm.update(want)
        assert strip_ts(h) == strip_ts(jh)
        for entry in h["ranks"].values():
            flags_seen.update(f.split("_windows")[0].rstrip("_0123456789")
                              if f.startswith("stale") else f
                              for f in entry.get("flags", ()))
    assert flags_seen >= {"stale", "warning_lines", "error_lines",
                          "queue_depth", "beat_stalled", "data_drift",
                          "miscalibrated", "device_recompiles", "slo_burn",
                          "donation_miss", "tier_hit_low", "freshness_burn"}
    assert strip_ts(hm.last_health) == strip_ts(jhm.last_health)
    # rank 1 missed windows 2 and 3: dead at the second
    assert hm.last_health["ranks"]["1"]["stale_windows"] == 0


class FailingTransport:
    def __init__(self, fail):
        self.fail = fail
        self.sent = []

    def publish(self, payload):
        if self.fail():
            raise ConnectionError("down")
        self.sent.append(payload)

    def drain(self):
        return []


def test_publish_backoff_matches_the_reference():
    """Failures past MAX_PUBLISH_FAILURES skip 1, 2, 4, ... publishes (up
    to BACKOFF_SKIP_CAP within BACKOFF_CAP_S on an injected clock); a
    success resets: the same sequence of attempts as the reference's."""
    from paddlebox_tpu.obs import aggregate as jaggregate
    pattern = [True] * 14 + [False] * 3 + [True] * 6 + [False] * 2
    seqs = []
    for mod in (aggregate, jaggregate):
        now = [0.0]
        calls = []
        outcome = iter(pattern + [False] * 40)

        def fail(calls=calls, outcome=outcome):
            calls.append(now[0])
            return next(outcome)

        agg = mod.ClusterAggregator(FailingTransport(fail), 1, 2,
                                    clock=lambda: now[0])
        for i in range(60):
            now[0] = float(i)
            agg.publish({"rank": 1, "step": i})
        seqs.append(calls)
    assert seqs[0] == seqs[1]
    assert len(seqs[0]) < 60


def drive_store_aggregators(mod, store_mod, health_mod):
    """Rank 0 and rank 1 aggregators over one KV store: rank 1 publishes,
    rank 0 merges; then a window without rank 1. The records rank 0's
    sink got (ts aside)."""
    srv = store_mod.KVStoreServer("127.0.0.1", 0)
    try:
        cl = [store_mod.TcpStoreClient("127.0.0.1", srv.port)
              for _ in range(2)]
        sink = ListSink()
        hm = health_mod.HealthMonitor(2)
        a0 = mod.ClusterAggregator(
            mod.StoreObsTransport(cl[0], "run/obs", 0, 2), 0, 2, sink=sink,
            health=hm)
        a1 = mod.ClusterAggregator(
            mod.StoreObsTransport(cl[1], "run/obs", 1, 2), 1, 2)
        w = scripted_reports()[0]
        assert a1.publish(w[1]) is None
        m = a0.publish(w[0])
        assert m["ranks"] == [0, 1] and m["stale_ranks"] == []
        a0.publish(scripted_reports()[1][0])
        a1.publish(w[1])              # a re-publish is a new window
        a0.publish(w[0])
        return [strip_ts(r) for r in sink.records]
    finally:
        srv.stop()


def test_store_aggregation_matches_the_reference():
    """The store transport end to end: the merged records and health
    records rank 0 emits equal the reference's over its own store,
    including a window where rank 1 is stale."""
    from paddlebox_tpu.fleet import store as jstore
    from paddlebox_tpu.obs import aggregate as jaggregate
    from paddlebox_tpu.obs import health as jhealth
    import paddlebox_tpu_torch.fleet.store as pstore
    got = drive_store_aggregators(aggregate, pstore, health)
    want = drive_store_aggregators(jaggregate, jstore, jhealth)
    assert got == want
    kinds = [r["type"] for r in got]
    assert kinds == ["cluster_report", "cluster_health"] * 3
    assert got[2]["stale_ranks"] == [1] and got[4]["stale_ranks"] == []


def test_wiring_at_world_one():
    """make_cluster_aggregator and make_transport give None without a
    second rank; obs_rank_world reads the mesh, else the fleet."""
    fl = Fleet().init(RoleMaker(0, 1))
    assert fl.store_client() is None
    assert fl.obs_namespace() == "0/obs"
    assert aggregate.make_transport(fleet=fl) is None
    assert make_cluster_aggregator(fleet=fl, flags=ObsFlags()) is None
    assert obs_rank_world(None, fl) == (0, 1)
    assert obs_rank_world(type("M", (), {"rank": 3, "world": 4})(), fl) \
        == (3, 4)
    assert obs_rank_world() == (0, 1)
    assert fl.make_shuffler() is None


class FakeFleet:
    initialized = True

    def __init__(self, client, rank, world):
        self.client, self.rank, self.world = client, rank, world

    def store_client(self):
        return self.client

    def obs_namespace(self):
        return "7/obs"

    def worker_index(self):
        return self.rank

    def worker_num(self):
        return self.world


def test_make_cluster_aggregator_over_a_fleet_store(tmp_path):
    """Above world 1: the store transport under the fleet's namespace;
    rank 0 gets the sink of obs_report_path and a HealthMonitor with
    data_quality_warn as its drift bar, the other ranks neither."""
    srv = KVStoreServer("127.0.0.1", 0)
    try:
        cl = TcpStoreClient("127.0.0.1", srv.port)
        flags = ObsFlags(obs_report_path=str(tmp_path / "r.jsonl"),
                         data_quality_warn=0.25)
        a0 = make_cluster_aggregator(FakeFleet(cl, 0, 3), 0, 3, flags)
        a2 = make_cluster_aggregator(FakeFleet(cl, 2, 3), 2, 3, flags)
        assert isinstance(a0.transport, aggregate.StoreObsTransport)
        assert a0.transport._ns == "7/obs" and a2.transport.rank == 2
        assert a0.health.drift_warn == 0.25 and a0.health.world == 3
        assert a2.health is None
        a2.publish({"rank": 2, "step": 1})
        a0.publish({"rank": 0, "step": 1})
        a0.close()
        a2.close()
        lines = (tmp_path / "r.jsonl").read_text().splitlines()
        assert len(lines) == 2 and '"stale_ranks": [1]' in lines[0]
    finally:
        srv.stop()
