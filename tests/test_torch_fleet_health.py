"""The serving fleet's /health section (obs/exporter.py
set_fleet_health_provider) against the JAX package's exporter.

Both packages' exporters run on ephemeral ports, each bound to the same
scripted reporter: one whose aggregator carries a merged cluster_health
record (rank 0 of a multi-rank job), one with none (the rank's liveness
record). Under a scripted provider, a raising provider and a cleared one,
each package's /health answers records with the same keys and the same
serving_fleet section (the error's repr included); the liveness record's
timestamps differ by the clock only.
"""

import json
import types
import urllib.request

import pytest

from paddlebox_tpu_torch.obs import exporter

FLEET = {"type": "serving_fleet", "v": 1, "replicas": 3, "qps": 1250.5,
         "p50_us": 812.0, "p99_us": 4100.0, "healthy": [0, 1, 2]}
CLUSTER_HEALTH = {"type": "cluster_health", "v": 1, "ts": 1.7e9,
                  "world": 2, "score": 0.97, "ranks": {"0": {"ok": True},
                                                       "1": {"ok": True}}}


def _reporter(merged):
    """A reporter whose aggregator's health plane holds CLUSTER_HEALTH
    (``merged``) or which has no aggregator."""
    agg = (types.SimpleNamespace(health=types.SimpleNamespace(
        last_health=dict(CLUSTER_HEALTH)), last_cluster_report=None)
           if merged else None)
    return types.SimpleNamespace(aggregator=agg,
                                 peek=lambda: {"step": 42, "ts": 1.7e9})


class _Boom(RuntimeError):
    pass


def _raising():
    raise _Boom("fleet mid-teardown")


PROVIDERS = {"scripted": lambda: dict(FLEET), "raising": _raising,
             "cleared": None}


def _health(exp):
    url = "http://127.0.0.1:%d/health" % exp.port
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read().decode())


@pytest.fixture
def exporters():
    from paddlebox_tpu.obs import exporter as jexporter
    made = []
    try:
        yield lambda mod, rep: made.append(mod.ObsExporter(0).bind(rep)) \
            or made[-1]
    finally:
        for e in made:
            e.close()
        exporter.set_fleet_health_provider(None)
        jexporter.set_fleet_health_provider(None)


@pytest.mark.parametrize("merged", [True, False],
                         ids=["rank0_merged", "liveness"])
@pytest.mark.parametrize("provider", sorted(PROVIDERS))
def test_health_section_as_the_reference(exporters, merged, provider):
    from paddlebox_tpu.obs import exporter as jexporter
    records = []
    for mod in (exporter, jexporter):
        # the previous provider is replaced, then (cleared) removed
        mod.set_fleet_health_provider(lambda: {"type": "stale"})
        mod.set_fleet_health_provider(PROVIDERS[provider])
        records.append(_health(exporters(mod, _reporter(merged))))
    got, want = records
    assert set(got) == set(want)
    assert got["type"] == want["type"] == (
        "cluster_health" if merged else "rank_liveness")
    if provider == "cleared":
        assert "serving_fleet" not in got
    else:
        assert got["serving_fleet"] == want["serving_fleet"]
    if provider == "scripted":
        assert got["serving_fleet"] == FLEET
    if provider == "raising":
        assert got["serving_fleet"] == {
            "type": "serving_fleet",
            "error": "_Boom('fleet mid-teardown')"}
    if merged:
        assert {k: v for k, v in got.items() if k != "serving_fleet"} \
            == CLUSTER_HEALTH
    else:
        for k in ("rank", "last_report_step", "last_report_ts", "note",
                  "v"):
            assert got[k] == want[k], k
