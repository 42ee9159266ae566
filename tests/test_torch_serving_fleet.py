"""The port's spawned serving fleet (paddlebox_tpu_torch/serving/fleet.py):
one MultiBoxFleet of 2 boxes x 1 replica over one xbox root and a hot set.

Its pulls equal the single-box stack bit for bit (hits, misses, hot keys);
its replicas hold no torch (the spawned process maps no libtorch); an
ObsExporter's /health carries the fleet's serving_fleet section while it
is up and not after close; an unknown flag override raises in the parent
before anything is spawned. Not marked slow: a replica loads no torch and
comes up in about a second.
"""

import json
import os
import time
import urllib.request

import numpy as np
import pytest
import torch

from paddlebox_tpu.parallel.sharding import KeyModPolicy as JKeyModPolicy
from paddlebox_tpu.serving import store as jstore

from paddlebox_tpu_torch.obs.exporter import ObsExporter
from paddlebox_tpu_torch.serving.fleet import MultiBoxFleet, split_overrides
from paddlebox_tpu_torch.serving.store import (MmapViewStack, write_hot_keys,
                                               write_xbox_columnar)

DIM = 5
WALL_S = 60.0


def bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def maps_libtorch(pid):
    with open("/proc/%d/maps" % pid) as f:
        return "libtorch" in f.read()


def health(port):
    with urllib.request.urlopen("http://127.0.0.1:%d/health" % port,
                                timeout=10) as r:
        return json.loads(r.read())


def test_unknown_override_raises_before_spawning(tmp_path):
    assert split_overrides({"serving_slo_us": 5.0, "obs_trace": False,
                            "sharding_num_tables": 8}) == {
        "ServingFlags": {"serving_slo_us": 5.0},
        "ObsFlags": {"obs_trace": False},
        "ShardFlags": {"sharding_num_tables": 8}}
    with pytest.raises(ValueError, match="serving_cache_size"):
        MultiBoxFleet(str(tmp_path), boxes=2,
                      flag_overrides={"serving_cache_size": 1})


def test_multibox_fleet_spawned_pulls_equal_the_single_box(tmp_path):
    t0 = time.monotonic()
    rng = np.random.RandomState(7)
    keys = np.unique(rng.randint(1, 1 << 40, 3000).astype(np.uint64))
    rows = rng.randn(keys.size, DIM).astype(np.float32)
    root = str(tmp_path / "xbox")
    day = os.path.join(root, "day0")
    os.makedirs(day)
    view = write_xbox_columnar(os.path.join(day, "view.xcol"), keys, rows)
    with open(os.path.join(day, "DONE"), "w") as f:
        f.write(str(time.time()))
    hot_path = write_hot_keys(str(tmp_path / "hot.keys"),
                              rng.choice(keys, 64, replace=False))
    oracle = MmapViewStack.from_files([view])
    exp = ObsExporter(0)
    fleet = MultiBoxFleet(root, days=["day0"], boxes=2, replicas=1,
                          policy_name="key-mod", hot_keys_path=hot_path,
                          flag_overrides={"serving_cache_rows": 512},
                          start_timeout=WALL_S)
    try:
        pids = [p for b in fleet.boxes for p in b.pids]
        assert len(pids) == 2
        # the probe sees torch where it is loaded: in this process
        assert torch.zeros(1).numel() == 1 and maps_libtorch(os.getpid())
        assert not any(maps_libtorch(p) for p in pids)
        fc = fleet.client(timeout=10.0)
        try:
            for _ in range(3):
                probe = np.concatenate([
                    fleet.hot_keys[:16], rng.choice(keys, 300),
                    rng.randint(1 << 41, 1 << 42, 30).astype(np.uint64)])
                assert np.array_equal(bits(fc.pull(probe)),
                                      bits(oracle.lookup(probe)))
        finally:
            fc.close()
        # each box filtered the view to its slice, under the reference's
        # file name for that slice
        for b in range(2):
            jspec = jstore.ShardSpec(b, JKeyModPolicy(2),
                                     hot_keys=fleet.hot_keys)
            assert os.path.exists("%s.%s" % (view, jspec._tag))
        sec = health(exp.port)["serving_fleet"]
        assert sec["type"] == "serving_fleet" and sec["boxes"] == 2
        assert sec["hot_rows"] == 64 and len(sec["replicas"]) == 2
        assert sec["requests"] >= 3 and sec["p99_us"] is not None
        assert sec["policy"] == fleet.policy.describe()
    finally:
        fleet.close()
        after = health(exp.port)
        exp.close()
    assert "serving_fleet" not in after
    assert not fleet.boxes
    assert time.monotonic() - t0 < WALL_S
