"""The model-parallel towers across ranks: MeshTowerTrainer with TpDeepFM and
EpMMoE over an ``mp`` process group of P = 2 and 4 gloo ranks, against the
JAX MeshTowerTrainer on a P-device mesh of virtual CPU devices
(tests/conftest.py).

Each rank is spawned by tests/sharded_cluster.py run_cluster (a process
group timeout and a wall limit) and trains both models over all the files
(the slab and the batch are replicated over the group), two passes each,
the reference's push seeds replayed. Tolerances (tests/mesh_tower_parity.py
assert_matches_jax, the reference's own gates):

  * each pass's loss rtol 1e-4 and AUC within 1e-4; the dense params,
    the ranks' tensors stacked back to the reference's [P, ...] layout,
    rtol 2e-4 / atol 1e-6; the store after each pass rtol 1e-4 / atol
    1e-6, its integer columns (show and click) exact;
  * each rank's sharded leaves against its own slice of the reference's
    stacked leaves, at the same gate;
  * across the group the losses, AUC, stores after each pass and
    replicated leaves are bit-identical: every rank applies the same push
    (a gradient summed twice would show here as a replicated leaf P times
    too large, which P = 1 cannot catch).
"""

import numpy as np
import pytest

from paddlebox_tpu_torch.convert import tower_params_to_jax
from mesh_tower_parity import (MODELS, assert_bits, assert_matches_jax,
                               assert_same_stores, jax_run, port_run,
                               replay_seeds, write_data)
from sharded_cluster import join_group, run_cluster


def _tower_rank(rank, world, port, spec):
    """A spawned rank: both models over the world's mp group."""
    join_group(rank, world, port)
    return {name: port_run(name, world, spec["feed"], spec["files"],
                           spec["seeds"])
            for name in MODELS}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_data(tmp_path_factory.mktemp("torch_mesh_tower_cluster"))


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def clusters(request, data, tmp_path_factory):
    P = request.param
    files, pfeed = data
    spec = {"fn": _tower_rank, "feed": pfeed, "files": files,
            "seeds": replay_seeds()}
    # the oracle runs while the ranks do
    ranks, want = run_cluster(
        P, spec, tmp_path_factory.mktemp("torch_mesh_tower_P%d" % P),
        meanwhile=lambda: {n: jax_run(n, P, pfeed, files) for n in MODELS})
    for w in want.values():
        assert sum(b for _, _, b in w["passes"]) <= len(spec["seeds"])
    return P, ranks, want


@pytest.mark.parametrize("name", MODELS)
def test_mesh_tower_matches_jax_across_ranks(clusters, name):
    P, ranks, want = clusters
    w = want[name]
    got = [r[name] for r in ranks]
    assert [(g["P"], g["rank"]) for g in got] == [(P, r) for r in range(P)]
    sharded = got[0]["sharded"]
    assert sharded == w["sharded"]
    # the initial tensors: each rank's slice of host_init's leaves
    for r, g in enumerate(got):
        for k, v in w["params0"].items():
            assert_bits(g["params0"][k], v[r] if sharded[k] else v)
    params = tower_params_to_jax([g["params"] for g in got], sharded)
    for g in got:
        assert_matches_jax(g["passes"], g["stores"], params, w)
    for r, g in enumerate(got):
        for k, v in w["params"].items():
            if sharded[k]:
                np.testing.assert_allclose(g["params"][k], v[r], rtol=2e-4,
                                           atol=1e-6,
                                           err_msg="%s rank %d" % (k, r))
    losses = [p[0] for p in got[0]["passes"]]
    assert losses[1] < losses[0], losses


@pytest.mark.parametrize("name", MODELS)
def test_ranks_hold_bit_identical_stores(clusters, name):
    _, ranks, _ = clusters
    first = ranks[0][name]
    for res in ranks[1:]:
        got = res[name]
        assert got["passes"] == first["passes"]
        assert_same_stores(got["stores"], first["stores"])
        for k, v in first["params"].items():
            if not first["sharded"][k]:
                assert_bits(got["params"][k], v)
