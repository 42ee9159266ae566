"""The fleet executor (fleet/executor.py) against the JAX package's cases
(tests/test_executor.py:41-84): an interceptor pipeline on one carrier,
and across two carriers over the TCP message bus; then a route between
the packages, a port carrier and a reference carrier exchanging messages
(the same frames on the wire). Every interceptor thread and server thread
a carrier started ends with its stop()."""

import threading
import time

import pytest

from paddlebox_tpu_torch.fleet.executor import (Carrier, FleetExecutor,
                                                Interceptor,
                                                InterceptorMessage)


def _threads_settle(before, timeout=10.0):
    """The threads started since ``before`` that are still alive once
    ``timeout`` seconds have passed or none is left."""
    deadline = time.monotonic() + timeout
    while True:
        alive = [t for t in threading.enumerate()
                 if t not in before and t.is_alive()]
        if not alive or time.monotonic() > deadline:
            return alive
        time.sleep(0.02)


def test_interceptor_pipeline_single_carrier():
    """A three-stage pipeline: source x2 -> +10 -> sink (the compute
    interceptor chain of carrier.cc)."""
    before = set(threading.enumerate())
    ex = FleetExecutor()
    c = ex.carrier
    try:
        c.add_interceptor(Interceptor(1, lambda it, m: it.send(
            2, m.payload * 2)))
        c.add_interceptor(Interceptor(2, lambda it, m: it.send(
            3, m.payload + 10)))
        ex.add_sink(3, expect=5)
        assert sorted(ex.run(1, [1, 2, 3, 4, 5], timeout=20)) == \
            [12, 14, 16, 18, 20]
    finally:
        c.stop()
    assert _threads_settle(before) == []


def test_interceptor_pipeline_cross_carrier():
    """Stage 2 lives on a second carrier reached over the TCP message bus
    (message_bus.cc), and its output goes back to the first."""
    before = set(threading.enumerate())
    ex = FleetExecutor()
    c1, c2 = ex.carrier, Carrier(carrier_id=1)
    try:
        c1.add_interceptor(Interceptor(10, lambda it, m: it.send(
            20, m.payload + 1)))
        c2.add_interceptor(Interceptor(20, lambda it, m: it.send(
            30, m.payload * 3)))
        ex.add_sink(30, expect=4)
        c1.register_route(20, "127.0.0.1", c2.port)
        c2.register_route(30, "127.0.0.1", c1.port)
        assert sorted(ex.run(10, [0, 1, 2, 3], timeout=20)) == [3, 6, 9, 12]
        with pytest.raises(KeyError, match="no route"):
            c1.send(InterceptorMessage(10, 99, "DATA", 0))
    finally:
        c1.stop()
        c2.stop()
    assert _threads_settle(before) == []


def test_run_times_out_without_its_sink():
    ex = FleetExecutor()
    try:
        ex.carrier.add_interceptor(Interceptor(1, lambda it, m: None))
        ex.add_sink(2, expect=1)
        with pytest.raises(TimeoutError):
            ex.run(1, [0], timeout=0.2)
    finally:
        ex.carrier.stop()


def test_port_and_reference_carriers_exchange_messages():
    """A route between the packages: the port's source sends to a stage on
    the reference's carrier, which sends to the port's sink; and the
    reference's executor reaches a stage on the port's carrier."""
    from paddlebox_tpu.fleet.executor import Carrier as JCarrier
    from paddlebox_tpu.fleet.executor import FleetExecutor as JExecutor
    from paddlebox_tpu.fleet.executor import Interceptor as JInterceptor

    ex, jc = FleetExecutor(), JCarrier(carrier_id=1)
    try:
        ex.carrier.add_interceptor(Interceptor(1, lambda it, m: it.send(
            2, {"v": m.payload, "via": ["port"]})))
        jc.add_interceptor(JInterceptor(2, lambda it, m: it.send(
            3, {"v": m.payload["v"] * 5, "via": m.payload["via"] + ["jax"]})))
        ex.add_sink(3, expect=3)
        ex.carrier.register_route(2, "127.0.0.1", jc.port)
        jc.register_route(3, "127.0.0.1", ex.carrier.port)
        got = ex.run(1, [1, 2, 3], timeout=20)
        assert sorted(g["v"] for g in got) == [5, 10, 15]
        assert all(g["via"] == ["port", "jax"] for g in got)
    finally:
        ex.carrier.stop()
        jc.stop()

    jex, pc = JExecutor(), Carrier(carrier_id=1)
    try:
        jex.carrier.add_interceptor(JInterceptor(1, lambda it, m: it.send(
            2, m.payload - 1)))
        pc.add_interceptor(Interceptor(2, lambda it, m: it.send(
            3, m.payload * 10)))
        jex.add_sink(3, expect=2)
        jex.carrier.register_route(2, "127.0.0.1", pc.port)
        pc.register_route(3, "127.0.0.1", jex.carrier.port)
        assert sorted(jex.run(1, [1, 2], timeout=20)) == [0, 10]
    finally:
        jex.carrier.stop()
        pc.stop()
