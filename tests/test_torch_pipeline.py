"""Pipeline parallelism at one stage, in one process, against the JAX
package on the same numpy-seeded inputs (tests/pipeline_parity.py holds
the configuration, the runs and the oracles).

Modules: ctr_stage_host_params bit for bit; ctr_pipeline_loss and
ctr_pipeline_sections on the same tensors (rtol 1e-6); the GPipe schedule
at S = 1 against the reference's on one device; then two passes of
CtrPipelineRunner in each form (plain, multi-task with the conversion
label, data_norm, the expand block) against the reference's S = 1 run,
whose push is the Pallas kernel interpreted (the expand block's
apply_push with its creation replaced by the port's hash), on data whose
push rows carry embedx gradients: the first step's loss rtol 1e-5, every
step's and pass's loss rtol 1e-4, the AUC within 1e-4, the dense params
rtol 2e-4 / atol 1e-6, the store's integer columns bit-equal and its
rows rtol 1e-4 / atol 1e-6; the first step's gradients equal to the
sequential composition's (S = 1). Then stream_depth 0 and 2 bit-identical,
a failing stager or step stopping the stager, the dump_fields lines and
predict_batches against the reference's, the factory's names (the
pipeline over the sharded table among them), MeshConfig's sizes and
make_mesh's refusal, and the Adam moments carried across by
convert.pipeline_params_from_jax.
"""

import os

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch.config.configs import MeshConfig
from paddlebox_tpu_torch.convert import (pipeline_params_from_jax,
                                         pipeline_params_to_jax)
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.parallel.mesh import device_mesh_1d, make_mesh
from paddlebox_tpu_torch.parallel.pipeline import (ctr_pipeline_loss,
                                                   ctr_pipeline_sections,
                                                   ctr_stage_host_params,
                                                   dn_summary_apply)
from pipeline_parity import (BATCH, D, FORMS, NUM_SLOTS, assert_bits,
                             assert_ctr_matches_jax, assert_same_stores,
                             assert_s_times_sequential, jax_run, port_run,
                             replay_seeds, write_data)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_data(tmp_path_factory.mktemp("torch_pipeline"))


# ------------------------------------------------------------- the modules

@pytest.mark.parametrize("n_tasks,dn", [(1, False), (2, True)])
def test_ctr_stage_host_params_bit_for_bit(n_tasks, dn):
    from paddlebox_tpu.parallel.pipeline import \
        ctr_stage_host_params as jparams
    want = jparams(5, 3, 2, 28, 16, n_tasks=n_tasks, use_data_norm=dn)
    got = ctr_stage_host_params(5, 3, 2, 28, 16, n_tasks=n_tasks,
                                use_data_norm=dn)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype
        assert_bits(got[k], v)
    # stage s's slice, and the stages stacked back
    tensors, adam = pipeline_params_from_jax(want, 1)
    assert adam is None
    for k, v in want.items():
        assert_bits(tensors[k].numpy(), v[1])
    back = pipeline_params_to_jax([pipeline_params_from_jax(want, s)[0]
                                   for s in range(3)])
    for k, v in want.items():
        assert_bits(back[k], v)


def _section_inputs(rng, M=3, K=40, E=0):
    seg = np.sort(rng.randint(0, BATCH * NUM_SLOTS, (M, K))).astype(
        np.int32)
    n_valid = [K - 5, K - 3, K]
    valid = np.zeros((M, K), bool)
    for t, n in enumerate(n_valid):
        valid[t, :n] = True
        seg[t, n:] = BATCH * NUM_SLOTS - 1
    emb = rng.rand(M, K, 3 + D).astype(np.float32)
    emb[..., :2] = rng.randint(0, 5, (M, K, 2))
    exp = rng.randn(M, K, E).astype(np.float32) if E else None
    return seg, valid, n_valid, emb, exp


@pytest.mark.parametrize("E,dn", [(0, False), (3, True)])
def test_ctr_pipeline_sections_match_jax(E, dn):
    import jax
    import jax.numpy as jnp
    from paddlebox_tpu.parallel.pipeline import \
        ctr_pipeline_sections as jsections
    from paddlebox_tpu.parallel.pipeline import \
        dn_summary_apply as jdn_apply
    rng = np.random.RandomState(0)
    seg, valid, n_valid, emb, exp = _section_inputs(rng, E=E)
    pooled_dim = NUM_SLOTS * (3 + D + E)
    host = ctr_stage_host_params(1, 1, 2, pooled_dim, 16,
                                 use_data_norm=dn)
    host = {k: np.array(v[0]) for k, v in host.items()}
    if dn:
        host["dn_sum"] = rng.randn(pooled_dim).astype(np.float32)
    jb, je, jh, jproj = jsections(BATCH, NUM_SLOTS, True, E, dn, 3 + D)
    pb, pe, ph, pproj = ctr_pipeline_sections(BATCH, NUM_SLOTS, True, E, dn,
                                              3 + D)
    tp = {k: torch.from_numpy(v) for k, v in host.items()}
    jp = {k: jnp.asarray(v) for k, v in host.items()}
    jx = jproj(jnp.asarray(emb), None if exp is None else jnp.asarray(exp),
               jnp.asarray(seg), jnp.asarray(valid))
    px = pproj(torch.from_numpy(emb),
               None if exp is None else torch.from_numpy(exp),
               torch.from_numpy(seg), torch.from_numpy(valid), n_valid)
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=1e-6,
                               atol=1e-6)
    for tm in range(3):
        y = pe(tp, px, tm)
        np.testing.assert_allclose(y.numpy(), np.asarray(je(jp, jx, tm)),
                                   rtol=1e-6, atol=1e-6)
        z = pb(tp, y)
        np.testing.assert_allclose(
            z.numpy(), np.asarray(jb(jp, jnp.asarray(y.numpy()))),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            ph(tp, z).numpy(), np.asarray(jh(jp, jnp.asarray(z.numpy()))),
            rtol=1e-6, atol=1e-6)
    if dn:
        got = dn_summary_apply(tp, px, 0.999, 3 + D)
        want = jdn_apply(jp, jx, 0.999, 3 + D, None)
        for k in ("dn_size", "dn_sum", "dn_sqsum"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, err_msg=k)
    del jax


@pytest.mark.parametrize("tasks", [("ctr",), ("ctr", "cvr")])
def test_ctr_pipeline_loss_matches_jax(tasks):
    import jax.numpy as jnp
    from paddlebox_tpu.parallel.pipeline import ctr_pipeline_loss as jloss
    rng = np.random.RandomState(1)
    M, T = 3, len(tasks)
    shape = (M, BATCH) if T == 1 else (M, BATCH, T)
    logits = (3 * rng.randn(*shape)).astype(np.float32)
    labels = rng.randint(0, 2, (M, BATCH)).astype(np.int32)
    iv = rng.rand(M, BATCH) < 0.9
    tl = {t: rng.randint(0, 2, (M, BATCH)).astype(np.int32) for t in tasks}
    wl, wp = jloss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(iv),
                   {t: jnp.asarray(v) for t, v in tl.items()}
                   if T > 1 else None, tasks)
    gl, gp = ctr_pipeline_loss(torch.from_numpy(logits),
                               torch.from_numpy(labels), torch.from_numpy(iv),
                               {t: torch.from_numpy(v) for t, v in tl.items()}
                               if T > 1 else None, tasks)
    np.testing.assert_allclose(float(gl), float(wl), rtol=1e-6)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-6)


def test_gpipe_schedule_at_one_stage_matches_jax():
    from paddlebox_tpu.parallel.pipeline import GPipeRunner as JG
    from paddlebox_tpu.parallel.pipeline import PipelineConfig as JC
    from paddlebox_tpu_torch.parallel.pipeline import (GPipeRunner,
                                                       PipelineConfig)
    cfg = dict(n_stages=1, n_micro=4, d_model=8, layers_per_stage=2,
               lr=1e-2)
    jr = JG(JC(**cfg), seed=3)
    p0 = {k: np.array(v) for k, v in jr.params.items()}
    r = GPipeRunner(PipelineConfig(**cfg), init_fn=lambda _: p0,
                    device="cpu")
    assert r.stage.size == 1 and r.stage.index == 0
    rng = np.random.RandomState(0)
    x = rng.randn(16, 8).astype(np.float32)
    y = rng.randn(16, 8).astype(np.float32)
    np.testing.assert_allclose(r.forward(x).numpy(), np.asarray(jr.forward(x)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r.sequential_forward(x).numpy(),
                               np.asarray(jr.sequential_forward(x)),
                               rtol=1e-5, atol=1e-6)
    for _ in range(4):
        np.testing.assert_allclose(r.train_step(x, y), jr.train_step(x, y),
                                   rtol=1e-5)
    for k, v in jr.params.items():
        np.testing.assert_allclose(r.params[k], np.asarray(v)[0], rtol=2e-4,
                                   atol=1e-6, err_msg=k)


# ------------------------------------------------------ the CTR pipeline

@pytest.fixture(scope="module")
def jax_runs(data, tmp_path_factory):
    """The reference's S = 1 runs of every form, the plain one with its
    dump and predict_batches, made once for the module."""
    files, pfeed = data
    dump = str(tmp_path_factory.mktemp("jax_pipeline_dump"))
    return {f: jax_run(f, 1, pfeed, files, predict=f == "plain",
                       dump_path=dump if f == "plain" else None)
            for f in FORMS} | {"dump": dump}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_ctr_pipeline_two_passes_match_jax(form, data, jax_runs):
    files, pfeed = data
    got = port_run(form, 1, pfeed, files, replay_seeds())
    want = jax_runs[form]
    assert [p[1] for p in got["passes"]] == [4, 4]
    assert_ctr_matches_jax(got, want, 0)
    assert_s_times_sequential(form, pipeline_params_to_jax([got["params"]]),
                              [(0, 0, got["probe"])])
    losses = [p[0] for p in got["passes"]]
    assert losses[1] < losses[0], losses


def test_stream_depth_0_and_2_bit_identical(data):
    files, pfeed = data
    runs = [port_run("plain", 1, pfeed, files, replay_seeds(), depth=d)
            for d in (0, 2)]
    a, b = runs
    assert a["passes"] == b["passes"]
    assert a["step_losses"] == b["step_losses"]
    assert_same_stores(a["stores"], b["stores"])
    assert a["slabs"] == b["slabs"]
    for k, v in a["params"].items():
        assert_bits(b["params"][k], v)


@pytest.mark.parametrize("where", ["stage", "step"])
def test_a_failing_pass_stops_its_stager(data, where):
    """An error in the stager (device_batch) or in a step propagates from
    train_pass, and the prefetch thread is gone when it does (it is
    drained while joined, so one blocked on a full queue ends too)."""
    import threading
    from pipeline_parity import port_runner
    files, pfeed = data
    r = port_runner("plain", 1, pfeed, replay_seeds(), depth=2)
    name = "device_batch" if where == "stage" else "train_step_staged"
    inner, calls = getattr(r, name), []

    def failing(*a):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("%s failed" % where)
        return inner(*a)

    setattr(r, name, failing)
    ds = BoxDataset(pfeed)
    ds.set_filelist(files)
    with pytest.raises(RuntimeError, match="%s failed" % where):
        r.train_pass(ds)
    assert not [t for t in threading.enumerate()
                if t.name == "pipe-prefetch" and t.is_alive()]
    r.table.end_pass()
    r.close()


def _dump_lines(path):
    """The dump's lines in write order (one writer thread, one file),
    without the instance id column: the record path's ids are the
    records' (empty here), the columnar path's the positions."""
    (name,) = os.listdir(path)
    with open(os.path.join(path, name)) as fh:
        return [ln.split("\t")[1:] for ln in fh.read().splitlines()]


def test_dump_fields_and_predict_match_jax(data, jax_runs, tmp_path):
    files, pfeed = data
    got = port_run("plain", 1, pfeed, files, replay_seeds(), predict=True,
                   dump_path=str(tmp_path))
    want = jax_runs["plain"]
    gl, wl = _dump_lines(str(tmp_path)), _dump_lines(jax_runs["dump"])
    assert len(gl) == len(wl) == 2 * 256
    assert [ln[0] for ln in gl] == [ln[0] for ln in wl]
    gp = np.array([float(ln[1].split("pred:")[1]) for ln in gl])
    wp = np.array([float(ln[1].split("pred:")[1]) for ln in wl])
    np.testing.assert_allclose(gp, wp, rtol=1e-4, atol=1e-5)
    (gpred, glab), (wpred, wlab) = got["predict"], want["predict"]
    np.testing.assert_array_equal(glab, wlab)
    assert gpred.shape == wpred.shape == (256,)
    np.testing.assert_allclose(gpred, wpred, rtol=1e-4, atol=1e-6)


def test_adam_moments_carry_across(data):
    """Adam's moments of a reference state land on the runner's tensors bit
    for bit (convert.pipeline_params_from_jax, restore_dense)."""
    import optax
    from pipeline_parity import port_runner
    files, pfeed = data
    r = port_runner("plain", 1, pfeed, replay_seeds())
    host = {k: v[None] for k, v in r.params.items()}
    rng = np.random.RandomState(3)
    mu = {k: rng.randn(*v.shape).astype(np.float32) for k, v in host.items()}
    nu = {k: rng.rand(*v.shape).astype(np.float32) for k, v in host.items()}
    state = (optax.ScaleByAdamState(count=np.int32(7), mu=mu, nu=nu),
             optax.EmptyState())
    r.restore_dense(host, state)
    for k, t in r.tensors.items():
        st = r.dense_opt.state[t]
        assert float(st["step"]) == 7.0
        assert_bits(st["exp_avg"].numpy(), mu[k][0])
        assert_bits(st["exp_avg_sq"].numpy(), nu[k][0])
        assert_bits(t.detach().numpy(), host[k][0])
    r.close()


# ------------------------------------------------ the factory and the mesh

def test_factory_names_resolve(data):
    from paddlebox_tpu_torch.parallel.pipeline import (CtrPipelineRunner,
                                                       GPipeRunner,
                                                       PipelineConfig)
    from paddlebox_tpu_torch.train.factory import create_trainer
    from pipeline_parity import table_cfg
    _, pfeed = data
    r = create_trainer("PipelineTrainer",
                       PipelineConfig(n_stages=1, n_micro=4, d_model=8,
                                      layers_per_stage=1), device="cpu")
    assert isinstance(r, GPipeRunner)
    for name in ("CtrPipelineTrainer", "HeterPipelineTrainer"):
        r2 = create_trainer(name, table_cfg(), pfeed, n_stages=1, d_model=8,
                            n_micro=4, seed=0, device="cpu")
        assert isinstance(r2, CtrPipelineRunner)
        r2.close()
    # the pipeline over the sharded table builds on a world-1 fleet, and
    # SectionPSTrainer wants its PS client
    from paddlebox_tpu_torch.parallel.pipeline import \
        ShardedCtrPipelineRunner
    from paddlebox_tpu_torch.ps import PsLocalClient
    from sharded_cluster import world_one
    fl = world_one()
    try:
        client = PsLocalClient()
        client.create_sparse_table(0, table_cfg(), shard_num=2)
        for name, kw in (("ShardedCtrPipelineTrainer", {}),
                         ("SectionPSTrainer", {"ps_client": client})):
            r3 = create_trainer(name, table_cfg(), pfeed, n_stages=1,
                                d_model=8, n_micro=4, seed=0, fleet=fl,
                                device="cpu", **kw)
            assert isinstance(r3, ShardedCtrPipelineRunner)
            assert (r3.P, r3.stage.size, r3.batches_per_step) == (1, 1, 4)
            r3.close()
    finally:
        fl.stop()
    with pytest.raises(ValueError, match="ps_client"):
        create_trainer("SectionPSTrainer", table_cfg(), pfeed)


def test_mesh_config_takes_sizes_and_make_mesh_refuses_a_larger_mesh():
    cfg = MeshConfig(data=2, model=3, pipeline=4)
    assert (cfg.data, cfg.model, cfg.pipeline) == (2, 3, 4)
    for bad in ({"data": 0}, {"pipeline": -1}, {"model": 1.5},
                {"data": True}):
        with pytest.raises(ValueError, match="positive int"):
            MeshConfig(**bad)
    with pytest.raises(ValueError, match="mesh needs 2 devices, have 1"):
        make_mesh(MeshConfig(pipeline=2))
    with pytest.raises(ValueError, match="requested 3 devices, have 1"):
        device_mesh_1d(3)
    m = make_mesh(MeshConfig(data=1, pipeline=1,
                             axis_names=("data", "pipeline")))
    assert m.names == ("data", "pipeline") and m.sizes == (1, 1)
    assert m.coords == (0, 0) and m.member
    from paddlebox_tpu_torch.parallel.tensor_parallel import LOCAL
    assert m.group("data") is LOCAL and m.group("pipeline") is LOCAL
    # the reference lays the same axes out
    from paddlebox_tpu.config.configs import MeshConfig as JMesh
    from paddlebox_tpu.parallel.mesh import make_mesh as jmake
    jm = jmake(JMesh(data=1, pipeline=1, axis_names=("data", "pipeline")))
    assert tuple(jm.axis_names) == m.names
    assert tuple(jm.devices.shape) == m.sizes
