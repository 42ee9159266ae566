"""The model-parallel towers at one shard: models/wide_tower.py and
parallel/mesh_tower.py against the JAX package's on the CPU.

Same inputs, made from a seed with numpy, go through both packages.
Tolerances:

  * ``host_init``: the reference's numpy arrays bit for bit;
  * ``apply_local`` and its gradients (the pooled input's and every
    leaf's) at P = 1 against the reference's under shard_map on a
    one-device mesh: rtol 1e-5 / atol 1e-6;
  * MeshTowerTrainer at P = 1 over two passes against the JAX trainer with
    use_pallas_push (its kernel interpreted) and the push seeds replayed:
    each pass's loss rtol 1e-4 and AUC within 1e-4, the dense params rtol
    2e-4 / atol 1e-6 (the reference's own gates,
    tests/test_mesh_tower.py:115-147), the store after each pass rtol
    1e-4 / atol 1e-6 with its integer columns (show and click) exact;
  * the blocked and rebuild writes against scatter: bit for bit.

Gloo clusters of 2 and 4 ranks are tests/test_torch_mesh_tower_cluster.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as PS

from paddlebox_tpu_torch.config.configs import TrainerConfig
from paddlebox_tpu_torch.convert import (tower_params_from_jax,
                                         tower_params_to_jax)
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.parallel.mesh_tower import MeshTowerTrainer
from paddlebox_tpu_torch.train import factory
from mesh_tower_parity import (BATCH, D, MODELS, NUM_SLOTS, assert_bits,
                               assert_matches_jax, assert_same_stores,
                               jax_feed, jax_model, jax_run, jax_table_cfg,
                               port_model, port_run, replay_seeds,
                               table_cfg, write_data)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_data(tmp_path_factory.mktemp("torch_wide_tower"))


@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("name", MODELS)
def test_host_init_bit_equal_to_reference(name, P):
    got, gs = port_model(name, P).host_init(7)
    want, ws = jax_model(name, P).host_init(7)
    assert gs == ws and set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert_bits(got[k], v)
    # the conversion slices rank r's leaves and stacks them back
    ranks = [tower_params_from_jax(got, gs, r) for r in range(P)]
    for k, v in tower_params_to_jax(ranks, gs).items():
        assert_bits(v, want[k])


def test_ep_mmoe_refuses_indivisible_experts():
    for make in (port_model, jax_model):
        with pytest.raises(ValueError, match="not divisible"):
            make("ep_mmoe", 3)


@pytest.mark.parametrize("name", MODELS)
def test_apply_local_and_grads_match_shard_map(name):
    """One shard: the port's apply_local and autograd against the
    reference's apply_local under shard_map on a one-device mp mesh and
    jax.vjp of a seeded cotangent."""
    host, sharded = jax_model(name, 1).host_init(5)
    rng = np.random.RandomState(9)
    pooled = rng.randn(BATCH, NUM_SLOTS, 3 + D).astype(np.float32)
    cot = rng.randn(BATCH).astype(np.float32)
    jm = jax_model(name, 1)
    mesh = Mesh(np.array(jax.devices()[:1]), ("mp",))
    spec = {k: PS("mp") if s else PS() for k, s in sharded.items()}

    def local(p, x):
        p = {k: (v[0] if sharded[k] else v) for k, v in p.items()}
        return jm.apply_local(p, x, "mp")

    fn = jax.shard_map(local, mesh=mesh, in_specs=(spec, PS()),
                       out_specs=PS(), check_vma=False)
    jp = {k: jnp.asarray(v) for k, v in host.items()}
    want, vjp = jax.vjp(fn, jp, jnp.asarray(pooled))
    wgrads, wdx = vjp(jnp.asarray(cot))
    tensors = {k: t.requires_grad_(True)
               for k, t in tower_params_from_jax(host, sharded, 0).items()}
    x = torch.from_numpy(pooled).requires_grad_(True)
    got = port_model(name, 1).apply_local(tensors, x)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(wdx), rtol=1e-5,
                               atol=1e-6)
    for k, t in tensors.items():
        w = np.asarray(wgrads[k])
        np.testing.assert_allclose(t.grad.numpy(), w[0] if sharded[k] else w,
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def runs(data):
    """{model: (the port's run, the JAX run)} at P = 1: two passes, then
    the port's predict_batches."""
    files, pfeed = data
    seeds = replay_seeds()
    out = {}
    for name in MODELS:
        want = jax_run(name, 1, pfeed, files)
        assert sum(b for _, _, b in want["passes"]) <= len(seeds)
        out[name] = (port_run(name, 1, pfeed, files, seeds, predict=True),
                     want)
    return out


@pytest.mark.parametrize("name", MODELS)
def test_mesh_tower_matches_jax_at_one_shard(runs, name):
    got, want = runs[name]
    assert (got["P"], got["rank"]) == (1, 0)
    assert got["sharded"] == want["sharded"]
    for k, v in want["params0"].items():
        w = v[0] if want["sharded"][k] else v
        assert_bits(got["params0"][k], w)
    assert_matches_jax(got["passes"], got["stores"],
                       tower_params_to_jax([got["params"]], got["sharded"]),
                       want)
    losses = [p[0] for p in got["passes"]]
    assert losses[1] < losses[0], losses


@pytest.mark.parametrize("name", MODELS)
def test_predict_batches_creates_no_row(runs, name):
    got, _ = runs[name]
    preds, labels = got["predict"]
    rows_before, rows_after = got["rows_around_predict"]
    assert rows_before == rows_after == got["stores"][-1][0].size
    assert preds.shape == labels.shape and preds.size > 0
    assert ((preds > 0) & (preds < 1)).all()


@pytest.mark.parametrize("push", ["blocked", "rebuild"])
def test_writes_equal_scatter_bit_for_bit(data, runs, push):
    """TpDeepFM under push_write blocked and rebuild: the same losses,
    AUC, stores after each pass and tensors as the scatter run's."""
    files, pfeed = data
    ref, _ = runs["tp_deepfm"]
    got = port_run("tp_deepfm", 1, pfeed, files, replay_seeds(), push=push)
    assert got["passes"] == ref["passes"]
    assert_same_stores(got["stores"], ref["stores"])
    for k, v in ref["params"].items():
        assert_bits(got["params"][k], v)


def test_refusals_as_the_reference(data):
    """sparse_chunk_sync and a group whose size is not the model's shard
    count raise ValueError in both packages; the factory builds the
    trainer by the reference's name."""
    from paddlebox_tpu.config.configs import TrainerConfig as JTC
    from paddlebox_tpu.parallel.mesh_tower import MeshTowerTrainer as JTower
    files, pfeed = data
    jfeed = jax_feed(pfeed)
    with pytest.raises(ValueError, match="sparse_chunk_sync"):
        MeshTowerTrainer(port_model("tp_deepfm", 1), table_cfg(), pfeed,
                         TrainerConfig(sparse_chunk_sync=True),
                         device="cpu")
    with pytest.raises(ValueError, match="sparse_chunk_sync"):
        JTower(jax_model("tp_deepfm", 1), jax_table_cfg(), jfeed,
               JTC(sparse_chunk_sync=True))
    # a model of two shards in this one process (no process group)
    with pytest.raises(ValueError, match="n_shards"):
        MeshTowerTrainer(port_model("tp_deepfm", 2), table_cfg(), pfeed,
                         device="cpu")
    with pytest.raises(ValueError, match="n_shards"):
        JTower(jax_model("tp_deepfm", 2), jax_table_cfg(), jfeed,
               mesh=Mesh(np.array(jax.devices()[:1]), ("mp",)))
    with pytest.raises(ValueError, match="dense adam"):
        MeshTowerTrainer(port_model("tp_deepfm", 1), table_cfg(), pfeed,
                         TrainerConfig(dense_optimizer="sgd"), device="cpu")
    t = factory.create_trainer("MeshTowerTrainer", port_model("ep_mmoe", 1),
                               table_cfg(), pfeed, device="cpu")
    assert isinstance(t, MeshTowerTrainer) and t.P == 1
    assert t.tensors["ew1"].shape == (8, NUM_SLOTS * (3 + D), 16)
    ds = BoxDataset(pfeed)
    ds.set_filelist(files)
    r = t.train_pass(ds)
    assert r["batches"] > 0 and np.isfinite(r["loss"])
    keys, rows = t.table.store.state_items()
    assert keys.size > 0 and (rows[:, acc.SHOW] > 0).all()
