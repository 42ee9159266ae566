"""The port's serving wire (paddlebox_tpu_torch/serving/codec.py, server.py,
client.py, refresh.py's JournalDeltaSource) against the JAX package's.

The wire is held both ways: a port client against a reference server and a
reference client against a port server give the oracle's rows bit for
bit, and both codecs build equal frames. Then the reference's own cases on
the port, in-process over loopback: the plain codec's refusal of a class,
drain, the shard refusal, coalescing on and off, the replica backoff, the
fleet's parity (hits, misses, the hot tier, a swap mid-pull, a dead
replica), the journal-fed overlay (both packages' sources over one journal
the port's TouchedRowJournal wrote give the same file and watermark), the
SLO-burn gauge and the server's span under the client's trace id. Rows are
compared bit for bit; gauges and percentiles by name and presence.
"""

import os
import socket
import threading
import time
import types

import numpy as np
import pytest

from paddlebox_tpu.serving import client as jclient
from paddlebox_tpu.serving import codec as jcodec
from paddlebox_tpu.serving import refresh as jrefresh
from paddlebox_tpu.serving import server as jserver
from paddlebox_tpu.serving import store as jstore

from paddlebox_tpu_torch.config.flags import ServingFlags
from paddlebox_tpu_torch.obs.tracer import (get_tracer, next_trace_id,
                                            step_trace_id)
from paddlebox_tpu_torch.parallel.sharding import KeyModPolicy
from paddlebox_tpu_torch.serving import codec
from paddlebox_tpu_torch.serving.client import (BACKOFF_SKIP_CAP,
                                                FleetClient, ServingClient)
from paddlebox_tpu_torch.serving.refresh import (JournalDeltaSource,
                                                 ViewManager)
from paddlebox_tpu_torch.serving.server import ServingServer
from paddlebox_tpu_torch.serving.store import (MmapViewStack, ShardSpec,
                                               write_xbox_columnar)
from paddlebox_tpu_torch.train.journal import TouchedRowJournal
from paddlebox_tpu_torch.utils import journal_format as jf
from paddlebox_tpu_torch.utils.rpc import FramedClient
from paddlebox_tpu_torch.utils.stats import gauge_get, stat_get

EMBEDX = 4
DIM = 1 + EMBEDX        # embed_w and embedx: the served row
WIDTH = 7 + 1 + EMBEDX  # header, adagrad state, embedx: the store row


def make_view(tmp_path, n=2000, seed=0, name="view.xcol"):
    rng = np.random.RandomState(seed)
    keys = np.unique(rng.randint(1, 1 << 40, n).astype(np.uint64))
    rows = rng.randn(keys.size, DIM).astype(np.float32)
    path = os.path.join(str(tmp_path), name)
    write_xbox_columnar(path, keys, rows)
    return path, keys, rows


def view_root(tmp_path, full):
    """An xbox root whose day0 base is ``full``."""
    root = str(tmp_path / "xbox")
    day = os.path.join(root, "day0")
    os.makedirs(day)
    os.replace(full, os.path.join(day, "view.xcol"))
    with open(os.path.join(day, "DONE"), "w") as f:
        f.write(str(time.time()))
    return root, os.path.join(day, "view.xcol")


def shard_server(full_path, index, policy, hot=None):
    """A box in this process: a filtered stack behind a real server."""
    spec = ShardSpec(index, policy, hot_keys=hot)
    stack = MmapViewStack([], shard_spec=spec, extra_files=(full_path,))
    return ServingServer(manager=ViewManager(stack), watch=False)


def mixed_probe(rng, keys, n_hit=200, n_miss=30):
    probe = np.concatenate([
        rng.choice(keys, n_hit, replace=True),
        rng.randint(1 << 41, 1 << 42, n_miss).astype(np.uint64)])
    rng.shuffle(probe)
    return probe


def bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ------------------------------------------------------------- the wire

def test_codec_frames_equal_across_packages():
    keys = np.array([3, 1 << 63, 7], np.uint64)
    for kw in ({}, {"trace": next_trace_id()}, {"shard": 2},
               {"trace": 5, "shard": 0}):
        req = codec.encode_pull(keys, **kw)
        assert req == jcodec.encode_pull(keys, **kw)
        assert codec.decode_trace(req) == jcodec.decode_trace(req)
        assert codec.decode_shard(req) == jcodec.decode_shard(req)
        assert np.array_equal(codec.decode_pull_keys(req), keys)
    rows = np.arange(12, dtype=np.float32).reshape(3, 4)
    for wm in (None, 0.0, 1.7e9):
        resp = codec.encode_rows(rows, 4, watermark=wm)
        assert resp == jcodec.encode_rows(rows, 4, watermark=wm)
        assert codec.decode_watermark(resp) == jcodec.decode_watermark(resp)
        assert np.array_equal(bits(codec.decode_rows(resp)), bits(rows))
    assert codec.decode_trace({"trace": "x"}) is None
    assert codec.decode_watermark({"wm": "x"}) is None
    with pytest.raises(ValueError, match="length mismatch"):
        codec.decode_pull_keys({"keys": b"xx", "n": 3})
    with pytest.raises(ValueError, match="needs bytes"):
        codec.decode_pull_keys({"keys": [1], "n": 1})
    with pytest.raises(ValueError, match="length mismatch"):
        codec.decode_rows({"rows": b"x", "n": 1, "dim": 1})


@pytest.mark.parametrize("direction", ["port_client", "reference_client"])
def test_wire_both_ways_gives_the_oracle_rows(tmp_path, direction):
    """A port client against a reference server, and a reference client
    against a port server: the rows equal the full view's bit for bit,
    the generation is 0, stats and ping answer."""
    full, keys, _rows = make_view(tmp_path)
    oracle = MmapViewStack.from_files([full])
    if direction == "port_client":
        server = jserver.ServingServer(
            manager=jrefresh.ViewManager(
                jstore.MmapViewStack.from_files([full])), watch=False)
        client = ServingClient([("127.0.0.1", server.port)])
    else:
        server = ServingServer(
            manager=ViewManager(MmapViewStack.from_files([full])),
            watch=False)
        client = jclient.ServingClient([("127.0.0.1", server.port)])
    try:
        rng = np.random.RandomState(1)
        for _ in range(3):
            probe = mixed_probe(rng, keys)
            assert np.array_equal(bits(client.pull(probe)),
                                  bits(oracle.lookup(probe)))
        assert client.last_gen == 0
        assert client.ping()["gen"] == 0
        st = client.stats()
        assert st["gen"] == 0 and st["view_rows"] == keys.size
        assert st["requests"] >= 3
    finally:
        client.close()
        server.drain(timeout=5)


def test_codec_rejects_class_payloads_with_the_stream_intact(tmp_path):
    """A pickled numpy array on the serving port is refused by the
    transport, and the same connection then serves a plain pull; a
    malformed plain frame fails loud and the stream stays in place."""
    full, keys, _rows = make_view(tmp_path, n=200)
    server = ServingServer(
        manager=ViewManager(MmapViewStack.from_files([full])), watch=False)
    raw = FramedClient("127.0.0.1", server.port)
    try:
        with pytest.raises(RuntimeError, match="refusing to unpickle"):
            raw.call({"method": "pull", "keys": keys[:3], "n": 3})
        resp = raw.call(codec.encode_pull(keys[:3]))
        assert codec.decode_rows(resp).shape == (3, DIM)
        with pytest.raises(RuntimeError, match="length mismatch"):
            raw.call({"method": "pull", "keys": b"xx", "n": 3})
        with pytest.raises(RuntimeError, match="unknown serving method"):
            raw.call({"method": "nope"})
        assert raw.call({"method": "ping"})["gen"] == 0
    finally:
        raw.close()
        server.drain(timeout=5)


def test_server_drain_refuses_then_stops(tmp_path):
    full, keys, _rows = make_view(tmp_path, n=50)
    root, _ = view_root(tmp_path, full)
    server = ServingServer(root, days=["day0"], watch=False)
    client = ServingClient([("127.0.0.1", server.port)])
    client.pull(keys[:1])
    assert server.drain(timeout=5.0)
    assert server.drain(timeout=5.0)          # idempotent
    with pytest.raises((ConnectionError, RuntimeError)):
        client.pull(keys[:1])
    client.close()


def test_drain_rpc_refuses_new_pulls_and_fails_over(tmp_path):
    """The drain request is answered, then the replica refuses pulls as
    retryable: a client with a second replica fails over to it."""
    full, keys, _rows = make_view(tmp_path, n=50)
    a = ServingServer(manager=ViewManager(MmapViewStack.from_files([full])),
                      watch=False)
    b = ServingServer(manager=ViewManager(MmapViewStack.from_files([full])),
                      watch=False)
    client = ServingClient([("127.0.0.1", a.port), ("127.0.0.1", b.port)])
    try:
        assert client._call_at(0, {"method": "drain"}) == {"draining": True}
        deadline = time.time() + 10.0
        while not a._draining and time.time() < deadline:
            time.sleep(0.01)
        assert a._draining
        for _ in range(4):
            client.pull(keys[:4])
    finally:
        client.close()
        a.drain(timeout=5)
        b.drain(timeout=5)


def test_shard_validation_refuses_misrouted_pull(tmp_path):
    """A box that serves shard 1 refuses a pull routed to shard 0 and
    accepts one routed to it or undeclared."""
    full, keys, _rows = make_view(tmp_path)
    flags = ServingFlags(serving_shard_index=1, serving_num_shards=2,
                         serving_shard_policy="key-mod")
    spec = ShardSpec(1, KeyModPolicy(2))
    stack = MmapViewStack([], shard_spec=spec, extra_files=(full,))
    server = ServingServer(manager=ViewManager(stack), watch=False,
                           flags=flags)
    assert server.shard_spec.describe() == spec.describe()
    client = ServingClient([("127.0.0.1", server.port)])
    try:
        client.pull(keys[:4], shard=1)
        with pytest.raises(RuntimeError, match="shard"):
            client.pull(keys[:4], shard=0)
        client.pull(keys[:4])
    finally:
        client.close()
        server.drain(timeout=2)


# ----------------------------------------------------------- the fleet

def test_fleet_parity_key_mod_and_hot_tier(tmp_path):
    """Three boxes answer any pull as one box with the full view does,
    bit for bit; with a hot set, its keys are answered by whichever box
    the rotation picks."""
    full, keys, _rows = make_view(tmp_path)
    oracle = MmapViewStack.from_files([full])
    rng = np.random.RandomState(2)
    hot = np.sort(rng.choice(keys, 16, replace=False))
    for n_box, h in ((3, None), (2, hot)):
        policy = KeyModPolicy(n_box)
        servers = [shard_server(full, s, policy, hot=h)
                   for s in range(n_box)]
        fc = FleetClient([[("127.0.0.1", s.port)] for s in servers],
                         policy=policy, hot_keys=h)
        routed = stat_get("serving_fleet_hot_routed")
        try:
            for _ in range(4):
                probe = mixed_probe(rng, keys)
                if h is not None:
                    probe = np.concatenate([h, probe])
                assert np.array_equal(bits(fc.pull(probe)),
                                      bits(oracle.lookup(probe)))
        finally:
            fc.close()
            for s in servers:
                s.drain(timeout=2)
        if h is not None:
            assert stat_get("serving_fleet_hot_routed") - routed >= 4 * h.size
    with pytest.raises(ValueError, match="endpoint groups"):
        FleetClient([[("127.0.0.1", 1)]], policy=KeyModPolicy(2))


def test_fleet_parity_across_mid_pull_swap(tmp_path):
    """Pulls racing a swap on every box give rows of one generation or
    the other, never a torn row."""
    full_a, keys, rows_a = make_view(tmp_path, seed=3, name="a.xcol")
    path_b = os.path.join(str(tmp_path), "b.xcol")
    rows_b = rows_a + 1.0
    write_xbox_columnar(path_b, keys, rows_b)
    policy = KeyModPolicy(2)
    servers = [shard_server(full_a, s, policy) for s in range(2)]
    fc = FleetClient([[("127.0.0.1", s.port)] for s in servers],
                     policy=policy)
    got, errs = [], []

    def puller(seed):
        rng = np.random.RandomState(seed)
        try:
            for _ in range(12):
                probe = rng.choice(keys, 64, replace=False)
                got.append((probe, fc.pull(probe)))
        except Exception as e:  # noqa: BLE001 (asserted below)
            errs.append(e)

    threads = [threading.Thread(target=puller, args=(i,)) for i in range(4)]
    try:
        for t in threads:
            t.start()
        for idx, s in enumerate(servers):
            s.manager.swap(MmapViewStack(
                [], shard_spec=ShardSpec(idx, policy),
                extra_files=(path_b,)))
        for t in threads:
            t.join(timeout=60.0)
            assert not t.is_alive()
    finally:
        fc.close()
        for s in servers:
            s.drain(timeout=2)
    assert not errs, errs
    lut_a = dict(zip(keys.tolist(), bits(rows_a)))
    lut_b = dict(zip(keys.tolist(), bits(rows_b)))
    for probe, out in got:
        for k, row in zip(probe.tolist(), bits(out)):
            assert (np.array_equal(row, lut_a[k])
                    or np.array_equal(row, lut_b[k])), k


def test_coalescer_reduces_per_shard_rpcs(tmp_path):
    """At concurrency 8 the boxes see fewer RPCs than one a pull a box,
    and every answer is exact."""
    full, keys, _rows = make_view(tmp_path)
    policy = KeyModPolicy(2)
    servers = [shard_server(full, s, policy) for s in range(2)]
    oracle = MmapViewStack.from_files([full])
    fc = FleetClient([[("127.0.0.1", s.port)] for s in servers],
                     policy=policy)
    base = stat_get("serving_requests")
    coalesced = stat_get("serving_fleet_coalesced")
    n_threads, n_pulls = 8, 15
    errs = []

    def worker(seed):
        rng = np.random.RandomState(seed)
        try:
            for _ in range(n_pulls):
                probe = rng.choice(keys, 128)
                assert np.array_equal(bits(fc.pull(probe)),
                                      bits(oracle.lookup(probe)))
        except Exception as e:  # noqa: BLE001 (asserted below)
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
            assert not t.is_alive()
    finally:
        fc.close()
        for s in servers:
            s.drain(timeout=2)
    assert not errs, errs
    rpcs = stat_get("serving_requests") - base
    assert rpcs < 0.75 * 2 * n_threads * n_pulls, rpcs
    assert stat_get("serving_fleet_coalesced") > coalesced


def test_coalesce_off_sends_one_rpc_per_pull(tmp_path):
    full, keys, _rows = make_view(tmp_path, n=300)
    policy = KeyModPolicy(1)
    server = shard_server(full, 0, policy)
    fc = FleetClient([[("127.0.0.1", server.port)]], policy=policy,
                     coalesce=False)
    base = stat_get("serving_requests")
    try:
        for _ in range(5):
            fc.pull(keys[:32])
    finally:
        fc.close()
        server.drain(timeout=2)
    assert stat_get("serving_requests") - base == 5


def test_client_backoff_skips_dead_replica_then_reprobes(tmp_path):
    """A dead replica is skipped for a growing number of attempts (at
    most BACKOFF_SKIP_CAP) while its sibling serves; once it is back on
    the same port, one probe reaches it and its backoff resets."""
    full, keys, _rows = make_view(tmp_path, n=300)
    live = shard_server(full, 0, KeyModPolicy(1))
    dead_port = free_port()
    client = ServingClient([("127.0.0.1", dead_port),
                            ("127.0.0.1", live.port)])
    skips = stat_get("serving_client_skips")
    reprobes = stat_get("serving_client_reprobes")
    revived = None
    try:
        for _ in range(12):
            client.pull(keys[:8])
        with client._lock:
            assert client._fail_streak[0] >= 2
            assert client._skip_left[0] <= BACKOFF_SKIP_CAP
        assert stat_get("serving_client_skips") > skips
        revived = ServingServer(
            manager=ViewManager(MmapViewStack.from_files([full])),
            watch=False, port=dead_port)
        for _ in range(2 * BACKOFF_SKIP_CAP + 4):
            client.pull(keys[:8])
        with client._lock:
            assert client._fail_streak[0] == 0
        assert stat_get("serving_client_reprobes") > reprobes
    finally:
        client.close()
        live.drain(timeout=2)
        if revived is not None:
            revived.drain(timeout=2)


def test_fleet_survives_one_dead_replica(tmp_path):
    full, keys, _rows = make_view(tmp_path)
    policy = KeyModPolicy(2)
    s0 = shard_server(full, 0, policy)
    s1 = shard_server(full, 1, policy)
    oracle = MmapViewStack.from_files([full])
    fc = FleetClient([[("127.0.0.1", free_port()), ("127.0.0.1", s0.port)],
                      [("127.0.0.1", s1.port)]], policy=policy)
    try:
        rng = np.random.RandomState(5)
        for _ in range(6):
            probe = mixed_probe(rng, keys, 80, 8)
            assert np.array_equal(bits(fc.pull(probe)),
                                  bits(oracle.lookup(probe)))
        st = fc.fleet_stats()
        assert st["boxes"] == 2 and len(st["replicas"]) == 2
        assert st["p50_us"] is not None and st["p99_us"] is not None
        assert st["qps"] is None                  # the first call
        assert fc.fleet_stats()["qps"] is not None
    finally:
        fc.close()
        s0.drain(timeout=2)
        s1.drain(timeout=2)


# ----------------------------------------------------------- the journal

def journal(tmp_path, name="_journal", embedx=EMBEDX):
    layout = types.SimpleNamespace(width=7 + 1 + embedx, embedx_dim=embedx,
                                   optimizer="adagrad")
    return TouchedRowJournal(os.path.join(str(tmp_path), name), layout, None)


def test_journal_sources_of_both_packages_agree(tmp_path):
    """One journal the port's TouchedRowJournal wrote (rows, an update, a
    watermark, a stat-save event, then a shrink), tailed by both
    packages' JournalDeltaSource poll by poll: the same changes, overlay
    files of the same bytes and the same watermark."""
    j = journal(tmp_path)
    src = JournalDeltaSource([j.dir], scratch_dir=str(tmp_path / "p"))
    jsrc = jrefresh.JournalDeltaSource([j.dir],
                                       scratch_dir=str(tmp_path / "r"))
    os.makedirs(str(tmp_path / "p"))
    os.makedirs(str(tmp_path / "r"))
    cols = jf.xbox_embed_cols(EMBEDX, "adagrad")
    keys = np.array([11, 7, 1 << 62], np.uint64)
    vals = np.arange(3 * WIDTH, dtype=np.float32).reshape(3, WIDTH)
    steps = [lambda: j.append_rows(keys, vals),
             lambda: None,
             lambda: j.append_rows(keys[:1], vals[:1] + 100),
             lambda: j.publish(born_min=1.5e9, born_max=1.6e9),
             lambda: j.append_event(jf.EV_STAT_SAVE_DELTA),
             lambda: j.append_event(jf.EV_SHRINK)]
    try:
        for i, step in enumerate(steps):
            step()
            changed = src.poll()
            assert changed == jsrc.poll(), i
            out, jout = src.compile_overlay(), jsrc.compile_overlay()
            assert (out is None) == (jout is None), i
            if out is not None:
                with open(out, "rb") as a, open(jout, "rb") as b:
                    assert a.read() == b.read(), i
            assert src.applied_watermark() == jsrc.applied_watermark(), i
            if i == 0:
                stack = MmapViewStack.from_files([out])
                assert np.array_equal(bits(stack.lookup(keys)),
                                      bits(vals[:, cols]))
            if i == 1:
                assert not changed              # polled again: nothing new
        assert src.applied_watermark() == 1.6e9
        assert out is None                      # the shrink dropped it
    finally:
        src.close()
        jsrc.close()
        j.close()


def test_journal_source_multi_dir_and_layout_mismatch(tmp_path):
    j0, j1 = journal(tmp_path, "j0"), journal(tmp_path, "j1")
    src = JournalDeltaSource([j0.dir, j1.dir])
    try:
        v = np.ones((1, WIDTH), np.float32)
        j0.append_rows(np.array([1], np.uint64), v)
        j1.append_rows(np.array([2], np.uint64), v * 2)
        assert src.poll()
        stack = MmapViewStack.from_files([src.compile_overlay()])
        out = stack.lookup(np.array([1, 2], np.uint64))
        assert out[0, 0] == 1.0 and out[1, 0] == 2.0
    finally:
        src.close()
        j0.close()
        j1.close()
    other = journal(tmp_path, "j2", embedx=EMBEDX + 2)
    other.append_rows(np.array([3], np.uint64),
                      np.ones((1, WIDTH + 2), np.float32))
    src2 = JournalDeltaSource([j0.dir, other.dir])
    try:
        with pytest.raises(ValueError, match="projection"):
            src2.poll()
    finally:
        src2.close()
        other.close()
    with pytest.raises(ValueError, match="at least one"):
        JournalDeltaSource([])


def test_journal_fed_server_lands_rows_and_stamps_the_watermark(tmp_path):
    """A touched row is served bit for bit one refresh poll after the
    journal flushes it, with no delta save; untouched keys still come
    from the view; a published watermark reaches the responses."""
    full, keys, _rows = make_view(tmp_path)
    root, view = view_root(tmp_path, full)
    j = journal(tmp_path)
    server = ServingServer(root, days=["day0"], flags=ServingFlags(
        serving_journal_dir=j.dir, serving_refresh_secs=0.1))
    client = ServingClient([("127.0.0.1", server.port)])
    try:
        tk = keys[:3]
        tv = np.arange(3 * WIDTH, dtype=np.float32).reshape(3, WIDTH) + 9
        expect = tv[:, jf.xbox_embed_cols(EMBEDX, "adagrad")]
        j.append_rows(tk, tv)
        deadline = time.time() + 10.0
        while not np.array_equal(bits(client.pull(tk)), bits(expect)):
            assert time.time() < deadline, "journal rows never served"
            time.sleep(0.02)
        probe = keys[10:20]
        assert np.array_equal(bits(client.pull(probe)),
                              bits(MmapViewStack.from_files([view])
                                   .lookup(probe)))
        born = time.time() - 5.0
        j.publish(born_min=born - 1.0, born_max=born)
        deadline = time.time() + 10.0
        while client.last_watermark != born:
            assert time.time() < deadline, "watermark never served"
            client.pull(tk)
            time.sleep(0.02)
        assert server._stats()["watermark_ts"] == born
    finally:
        client.close()
        server.drain(timeout=2)
        j.close()


# ----------------------------------------------------------- telemetry

def test_trace_ids_and_slo_burn_gauge(tmp_path):
    """next_trace_id: bit 63 set, one salt a process, a counter below, no
    collision with step_trace_id. A pull's trace id is on both the
    client's span and the server's; every report window (4 pulls) sets
    serving_slo_burn = the window's p99 over serving_slo_us, and the
    record carries the lookup histogram and the cache hit rate."""
    a, b = next_trace_id(), next_trace_id()
    assert a >> 63 == 1 and b == a + 1 and (a >> 48) == (b >> 48)
    # a step id's rank stays below 2^15, so its bit 63 is clear
    assert step_trace_id(0x7FFF, (1 << 48) - 1) >> 63 == 0
    full, keys, _rows = make_view(tmp_path, n=300)
    root, _ = view_root(tmp_path, full)
    server = ServingServer(root, days=["day0"], watch=False,
                           flags=ServingFlags(serving_report_requests=4))
    client = ServingClient([("127.0.0.1", server.port)])
    get_tracer().clear()
    try:
        probe = mixed_probe(np.random.RandomState(17), keys)
        for _ in range(5):
            client.pull(probe)
        rep = server.reporter.peek()
        assert rep is not None and rep["role"] == "serving"
        assert rep["hists"]["serving_lookup_us"]["p99"] > 0
        assert rep["cache_hit_rate"] is not None
        assert "freshness_e2e_secs_p99" in rep
        burn = rep["gauges"].get("serving_slo_burn")
        assert burn is not None and burn > 0
        assert "serving_tier_hit_rate" in rep["gauges"]
        assert gauge_get("serving_slo_burn") == burn
        spans = get_tracer().all_spans()
        client_t = {s[5] for s in spans if s[0] == "serving_pull_client"}
        server_t = {s[5] for s in spans if s[0] == "serving_pull"}
        shared = (client_t & server_t) - {None}
        assert shared and all(t >> 63 for t in shared)
    finally:
        client.close()
        server.drain(timeout=5)
