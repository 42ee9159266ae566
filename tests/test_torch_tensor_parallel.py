"""The port's tensor- and expert-parallel functions
(parallel/tensor_parallel.py) against the JAX package's.

The port runs P = 2 and 4 gloo ranks, each spawned by the test
(tests/sharded_cluster.py run_cluster, a process group timeout and a wall
limit), each holding its shard of the same seeded numpy parameters; the
oracle is the reference's functions under shard_map on a P-device mesh of
virtual CPU devices (tests/conftest.py). Each rank's forward output, the
gradients of the 1/P-scaled replicated loss (tp_loss_scale) as autograd
gives them (through the psum's transpose), and the gradients after
tp_fix_grads / ep_gate_psum are held to the reference's on the same
device, rtol 1e-5 / atol 1e-7 (float32 matmuls and sums in another
library's order). In process without a group (LOCAL), each function is the
one-shard identity of its collective.
"""

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch.parallel import tensor_parallel as ptp
from sharded_cluster import join_group, run_cluster

B, D_IN, D_H, D_OUT = 16, 12, 32, 6
E, E_IN, E_H, E_OUT = 8, 10, 12, 4
TP_SHARDED = {"w1": True, "b1": True, "w2": True, "b2": False}
EP_KEYS = ("ew1", "eb1", "ew2", "eb2")


def tp_params(P):
    rng = np.random.RandomState(0)
    p = ptp.tp_mlp_init(rng, P, D_IN, D_H, D_OUT)
    # random biases: zeros would let a misplaced bias pass
    p["b1"] = (rng.randn(*p["b1"].shape) * 0.1).astype(np.float32)
    p["b2"] = (rng.randn(*p["b2"].shape) * 0.1).astype(np.float32)
    return p, rng.randn(B, D_IN).astype(np.float32)


def ep_params():
    rng = np.random.RandomState(1)
    p = ptp.ep_experts_init(rng, E, E_IN, E_H, E_OUT)
    p["eb1"] = (rng.randn(*p["eb1"].shape) * 0.1).astype(np.float32)
    p["eb2"] = (rng.randn(*p["eb2"].shape) * 0.1).astype(np.float32)
    return p, rng.randn(B, E_IN).astype(np.float32)


def _leaf(a):
    return torch.tensor(a, requires_grad=True)


def _grads(local):
    return {k: v.grad.clone() for k, v in local.items()}


def _np(d):
    return {k: v.detach().numpy() for k, v in d.items()}


def _tp_rank(rank, world, port, spec):
    """A spawned rank: the TP block and the EP mixture on this rank's
    shard, forward and gradients, raw and fixed."""
    join_group(rank, world, port)
    p, x = tp_params(world)
    local = {k: _leaf(v if k == "b2" else v[rank]) for k, v in p.items()}
    y = ptp.tp_mlp_apply(local, torch.from_numpy(x))
    ptp.tp_loss_scale((y ** 2).sum() * 1e-3).backward()
    raw = _grads(local)
    out = {"tp_y": y.detach().numpy(), "tp_raw": _np(raw),
           "tp_fixed": _np(ptp.tp_fix_grads(raw, TP_SHARDED))}
    p, x = ep_params()
    el = E // world
    local = {k: _leaf(v[rank * el:(rank + 1) * el] if k in EP_KEYS else v)
             for k, v in p.items()}
    y = ptp.ep_experts_apply(local, torch.from_numpy(x))
    ptp.tp_loss_scale((y ** 2).sum() * 1e-3).backward()
    raw = _grads(local)
    out.update(ep_y=y.detach().numpy(), ep_raw=_np(raw),
               ep_fixed=_np(ptp.ep_gate_psum(raw)))
    out["size_rank"] = (ptp.group_size(), ptp.group_rank(),
                        ptp.group_size(ptp.LOCAL), ptp.group_rank(ptp.LOCAL))
    return out


def jax_reference(P):
    """The reference's functions under shard_map on a P-device mesh: the
    outputs, each device's raw gradients and the fixed ones, [P, ...]
    stacked by device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS
    from paddlebox_tpu.parallel import tensor_parallel as jtp
    from paddlebox_tpu.parallel.mesh import device_mesh_1d

    mesh = device_mesh_1d(P, axis="mp")
    out = {}
    p, x = tp_params(P)
    specs = {"w1": PS("mp"), "b1": PS("mp"), "w2": PS("mp"), "b2": PS()}
    stacked = {k: PS("mp") for k in specs}

    def local_of(p):
        return {k: (v[0] if k != "b2" else v) for k, v in p.items()}

    def tp_step(p, x):
        local = local_of(p)

        def loss(local):
            y = jtp.tp_mlp_apply(local, x, "mp")
            return jtp.tp_loss_scale(jnp.sum(jnp.square(y)) * 1e-3, "mp")

        g = jax.grad(loss)(local)
        fixed = jtp.tp_fix_grads(g, TP_SHARDED, "mp")
        return (jtp.tp_mlp_apply(local, x, "mp"),
                {k: v[None] for k, v in g.items()},
                {k: v[None] for k, v in fixed.items()})

    y, raw, fixed = jax.jit(jax.shard_map(
        tp_step, mesh=mesh, in_specs=(specs, PS()),
        out_specs=(PS(), stacked, stacked), check_vma=False))(
        p, jnp.asarray(x))
    out["tp"] = (np.asarray(y), jax.tree.map(np.asarray, raw),
                 jax.tree.map(np.asarray, fixed))

    p, x = ep_params()
    especs = {k: (PS("mp") if k in EP_KEYS else PS()) for k in p}
    estacked = {k: PS("mp") for k in p}

    def ep_step(p, x):
        def loss(p):
            y = jtp.ep_experts_apply(p, x, "mp")
            return jnp.sum(jnp.square(y)) * 1e-3 / jax.lax.axis_size("mp")

        g = jax.grad(loss)(p)
        fixed = jtp.ep_gate_psum(g, "mp")

        def per_dev(t):
            return {k: (v if k in EP_KEYS else v[None]) for k, v in t.items()}

        return (jtp.ep_experts_apply(p, x, "mp"), per_dev(g),
                per_dev(fixed))

    y, raw, fixed = jax.jit(jax.shard_map(
        ep_step, mesh=mesh, in_specs=(especs, PS()),
        out_specs=(PS(), estacked, estacked), check_vma=False))(
        p, jnp.asarray(x))
    out["ep"] = (np.asarray(y), jax.tree.map(np.asarray, raw),
                 jax.tree.map(np.asarray, fixed))
    return out


def _close(got, want, msg):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7, err_msg=msg)


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def clusters(request, tmp_path_factory):
    P = request.param
    ranks = run_cluster(P, {"fn": _tp_rank},
                        tmp_path_factory.mktemp("torch_tp_P%d" % P))
    return P, ranks, jax_reference(P)


def _per_device(tree, r, el=None):
    """Device r's block of a [P, ...] (or, for an expert leaf, [E, ...])
    stacked gradient tree."""
    return {k: (v[r * el:(r + 1) * el] if el and k in EP_KEYS else v[r])
            for k, v in tree.items()}


@pytest.mark.parametrize("fn", ["tp", "ep"])
def test_outputs_and_gradients_match_shard_map(clusters, fn):
    P, ranks, want = clusters
    wy, wraw, wfixed = want[fn]
    el = E // P if fn == "ep" else None
    for r, res in enumerate(ranks):
        _close(res[fn + "_y"], wy, "%s forward, rank %d" % (fn, r))
        for name, got, w in (("raw", res[fn + "_raw"], wraw),
                             ("fixed", res[fn + "_fixed"], wfixed)):
            wd = _per_device(w, r, el)
            assert set(got) == set(wd)
            for k, v in wd.items():
                _close(got[k], v, "%s %s grad %s, rank %d" % (fn, name, k, r))
        assert res["size_rank"] == (P, r, 1, 0)


def test_fixed_gradients_are_the_dense_ones(clusters):
    """Under the 1/P loss the split leaves' gradients are the dense
    block's, and the fixed replicated ones (b2, the gate) too."""
    import jax
    import jax.numpy as jnp
    P, ranks, _ = clusters
    p, x = tp_params(P)
    w1 = np.concatenate(list(p["w1"]), axis=1)
    b1 = np.concatenate(list(p["b1"]))
    w2 = np.concatenate(list(p["w2"]), axis=0)

    def dense(w1, b1, w2, b2):
        return jnp.sum(jnp.square(jax.nn.relu(x @ w1 + b1) @ w2 + b2)) * 1e-3

    gw1, gb1, gw2, gb2 = jax.grad(dense, argnums=(0, 1, 2, 3))(
        w1, b1, w2, p["b2"])
    fixed = [r["tp_fixed"] for r in ranks]
    _close(np.concatenate([f["w1"] for f in fixed], axis=1), gw1, "w1")
    _close(np.concatenate([f["b1"] for f in fixed]), gb1, "b1")
    _close(np.concatenate([f["w2"] for f in fixed], axis=0), gw2, "w2")
    for f in fixed:
        np.testing.assert_allclose(f["b2"], gb2, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(ranks[0]["tp_raw"]["b2"] * P, gb2,
                                   rtol=1e-4, atol=1e-6)


def test_one_shard_is_the_identity_of_each_collective():
    p, x = tp_params(1)
    local = {k: torch.from_numpy(v if k == "b2" else v[0])
             for k, v in p.items()}
    xt = torch.from_numpy(x)
    want = torch.relu(xt @ local["w1"] + local["b1"]) @ local["w2"] + \
        local["b2"]
    got = ptp.tp_mlp_apply(local, xt, ptp.LOCAL)
    assert torch.equal(got, want)
    assert ptp.tp_loss_scale(torch.tensor(3.0), ptp.LOCAL) == 3.0
    g = {k: torch.ones(2) for k in TP_SHARDED}
    fixed = ptp.tp_fix_grads(g, TP_SHARDED, ptp.LOCAL)
    assert all(torch.equal(fixed[k], g[k]) for k in g)
    with pytest.raises(ValueError, match="divisible"):
        ptp.tp_mlp_init(np.random.RandomState(0), 3, 4, 8, 2)
