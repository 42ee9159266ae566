"""The pipeline over the sharded table at world 1, in one process over
gloo, against the JAX package on the same numpy-seeded inputs
(tests/pipeline_parity.py holds the configuration, the runs and the
oracles).

ShardedCtrPipelineRunner (rank = shard on a one-rank (stage,) mesh of a
world-1 fleet) over two passes in each form (plain, multi-task with the
conversion label, data_norm, the expand block) against the reference's
ShardedCtrPipelineRunner on one device, whose push is the Pallas kernel
interpreted (the expand block's apply_push with its creation replaced by
the port's hash), replaying its push seeds (the third stream:
pipeline_parity.replay_shard_seeds), on data whose push rows carry
embedx gradients: the first step's loss rtol 1e-5, every step's and
pass's loss rtol 1e-4, the AUC within 1e-4, the dense params rtol 2e-4 /
atol 1e-6, the store's integer columns bit-equal and its rows rtol 1e-4
/ atol 1e-6; the probe step's gradients equal to the sequential
composition's (S = 1). Then, bit for bit: the sharded runner against the
replicated CtrPipelineRunner replaying one seed stream, in each form; the
blocked and rebuild writes and the uid, delta and ids-only wires against
the scatter write on the full wire; stream_depth 0 against 2;
SectionPSTrainer over a PsLocalClient against the local store, the
server's rows against the store's. Also: the dump_fields lines,
predict_batches and the metric registry against the reference's; a pull
and a push all-to-all and one host exchange a step; run_day's deltas and
base, read back by the xbox reader; the refusals.
"""

import os

import numpy as np
import pytest

from paddlebox_tpu_torch.convert import pipeline_params_to_jax
from paddlebox_tpu_torch.data.dataset import BoxDataset
from pipeline_parity import (FORMS, assert_bits, assert_ctr_matches_jax,
                             assert_s_times_sequential, assert_same_stores,
                             jax_run, port_run, port_runner,
                             replay_seeds, replay_shard_seeds, sorted_store,
                             table_cfg, write_data)
from sharded_cluster import world_one

SEEDS = replay_shard_seeds(1)[0]
PS_TABLE = 3


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_data(tmp_path_factory.mktemp("torch_pipe_sharded"))


@pytest.fixture
def fl():
    fleet = world_one()
    try:
        yield fleet
    finally:
        fleet.stop()


@pytest.fixture(scope="module")
def jax_runs(data, tmp_path_factory):
    """The reference's sharded runs of every form on one device, the plain
    one with its dump and predict_batches, made once for the module."""
    files, pfeed = data
    dump = str(tmp_path_factory.mktemp("jax_pipe_sharded_dump"))
    return {f: jax_run(f, 1, pfeed, files, predict=f == "plain",
                       dump_path=dump if f == "plain" else None,
                       sharded=True)
            for f in FORMS} | {"dump": dump}


def assert_same_run(a, b):
    assert a["passes"] == b["passes"]
    assert a["step_losses"] == b["step_losses"]
    assert_same_stores(a["stores"], b["stores"])
    assert a["slabs"] == b["slabs"]
    for k, v in a["params"].items():
        assert_bits(b["params"][k], v)


# ---------------------------------------------------- against the reference

@pytest.mark.parametrize("form", sorted(FORMS))
def test_sharded_pipeline_two_passes_match_jax(form, data, jax_runs, fl):
    files, pfeed = data
    got = port_run(form, 1, pfeed, files, SEEDS, sharded={"fleet": fl})
    want = jax_runs[form]
    assert [p[1] for p in got["passes"]] == [4, 4]
    assert_ctr_matches_jax(got, want, 0)
    assert_s_times_sequential(form, pipeline_params_to_jax([got["params"]]),
                              [(0, 0, got["probe"])])
    losses = [p[0] for p in got["passes"]]
    assert losses[1] < losses[0], losses


def _dump_lines(path):
    (name,) = os.listdir(path)
    with open(os.path.join(path, name)) as fh:
        return [ln.split("\t")[1:] for ln in fh.read().splitlines()]


def test_dump_predict_and_registry_match_jax(data, jax_runs, fl, tmp_path):
    files, pfeed = data
    got = port_run("plain", 1, pfeed, files, SEEDS, predict=True,
                   dump_path=str(tmp_path), sharded={"fleet": fl})
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
    g, w = got["msg"], want["msg"]
    assert set(g) == set(w)
    for k, v in w.items():
        if isinstance(v, (int, np.integer)):
            assert g[k] == v, k
        else:
            np.testing.assert_allclose(g[k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=k)


# ------------------------------------------------------------ bit for bit

@pytest.mark.parametrize("form", sorted(FORMS))
def test_sharded_equals_replicated_bit_for_bit(form, data, fl):
    """At world 1 the shard is the whole table: the bucket merge and the
    owner's dedup keep the replicated runner's numbers exactly."""
    files, pfeed = data
    seeds = replay_seeds()
    a = port_run(form, 1, pfeed, files, seeds, sharded={"fleet": fl})
    b = port_run(form, 1, pfeed, files, seeds)
    assert_same_run(a, b)
    np.testing.assert_array_equal(a["probe"]["demb"].view(np.uint32),
                                  b["probe"]["demb"].view(np.uint32))
    # the probe's block from the shard's slab by key = the replicated
    # runner's gather by id, at the valid keys
    kv = a["probe"]["key_valid"]
    np.testing.assert_array_equal(kv, b["probe"]["key_valid"])
    for k in ("emb", "exp"):
        if b["probe"][k] is not None:
            np.testing.assert_array_equal(a["probe"][k][kv],
                                          b["probe"][k][kv])


@pytest.mark.parametrize("push_write,stage", [
    ("blocked", {}), ("rebuild", {}), ("scatter", {"h2d_lean": True}),
    ("scatter", {"h2d_lean": True, "wire_delta_ids": True}),
    ("scatter", {"h2d_lean": True, "h2d_uid_wire": False})],
    ids=["blocked", "rebuild", "uid", "delta", "ids_only"])
def test_writes_and_wires_bit_identical(push_write, stage, data, fl):
    files, pfeed = data
    base = port_run("plain", 1, pfeed, files, SEEDS,
                    sharded={"fleet": fl, "push_write": "scatter"})
    got = port_run("plain", 1, pfeed, files, SEEDS,
                   sharded={"fleet": fl, "push_write": push_write,
                            "stage": stage})
    assert got["push_write"] == push_write
    assert_same_run(got, base)
    lean = bool(stage)
    steps = sum(p[1] for p in got["passes"])
    # the lean wires' ids ride a device a2a of the buckets
    assert got["collectives"].get("a2a_ids", 0) == (steps + 2 if lean
                                                    else 0)


def test_stream_depth_0_and_2_bit_identical(data, fl):
    files, pfeed = data
    a, b = [port_run("plain", 1, pfeed, files, SEEDS, depth=d,
                     sharded={"fleet": fl}) for d in (0, 2)]
    assert_same_run(a, b)


def test_a_pull_and_a_push_a2a_and_one_exchange_a_step(data, fl):
    """Every world collective is called at world 1 too: the pull's and the
    push's all-to-alls a step (the probe step pulls twice and pushes
    none) and one host exchange a staged group; no stage or dp collective
    on groups of one."""
    files, pfeed = data
    got = port_run("plain", 1, pfeed, files, SEEDS, sharded={"fleet": fl})
    steps = sum(p[1] for p in got["passes"])
    assert steps == 8
    assert got["collectives"] == {"a2a_pull": steps + 2, "a2a_push": steps}
    assert got["exchanges"] == steps + 1


# ------------------------------------------------------- SectionPSTrainer

def test_section_ps_trainer_equals_the_local_store(data, fl):
    from paddlebox_tpu_torch.embedding import accessor as acc
    from paddlebox_tpu_torch.parallel.pipeline import \
        ShardedCtrPipelineRunner
    from paddlebox_tpu_torch.ps import PsLocalClient
    from paddlebox_tpu_torch.train.factory import create_trainer
    files, pfeed = data
    client = PsLocalClient()
    client.create_sparse_table(PS_TABLE, table_cfg(), shard_num=4, seed=0)
    runs = {}
    for name in ("local", "ps"):
        kw = ({"ps_client": client, "ps_table_id": PS_TABLE}
              if name == "ps" else {})
        r = create_trainer(
            "SectionPSTrainer" if kw else "ShardedCtrPipelineTrainer",
            table_cfg(), pfeed, n_stages=1, d_model=16, lr=5e-3, n_micro=4,
            seed=3, fleet=fl, device="cpu", **kw)
        assert type(r) is ShardedCtrPipelineRunner
        if kw:
            assert r.table.shard.store.primary
        r.seed_fn = iter(SEEDS).__next__
        losses = []
        for _ in range(2):
            ds = BoxDataset(pfeed)
            ds.set_filelist(files)
            losses.append(r.train_pass(ds)["loss"])
        if kw:
            with pytest.raises(TypeError, match="server-side"):
                r.table.store_view()
        else:
            keys, rows = sorted_store(r.table.store)
        runs[name] = (losses, r.params)
        r.close()
    assert runs["ps"][0] == runs["local"][0]
    for k, v in runs["local"][1].items():
        assert_bits(runs["ps"][1][k], v)
    assert client.sparse_size(PS_TABLE) == keys.size > 50
    got = client.pull_sparse(PS_TABLE, keys, create=False)
    assert (got[:, acc.SHOW] > 0).all()
    assert_bits(got, rows)


def test_section_ps_trainer_refuses_without_a_client():
    from paddlebox_tpu_torch.train.factory import create_trainer
    with pytest.raises(ValueError, match="SectionPSTrainer needs ps_client"):
        create_trainer("SectionPSTrainer")


# ------------------------------------------------------------- the day

def test_run_day_saves_deltas_and_a_base_the_reader_resolves(data, fl,
                                                             tmp_path):
    """run_day over two passes at world 1 (reference test_pipeline.py:
    869-903): a delta after each pass and the base at the day's end, the
    base's rows the store's, the dense save the runner's stacked stage,
    and the xbox reader resolving the hottest trained rows to their
    embed_w and embedx columns."""
    from paddlebox_tpu_torch.config.configs import CheckpointConfig
    from paddlebox_tpu_torch.config.flags import CkptFlags
    from paddlebox_tpu_torch.embedding import accessor as acc
    from paddlebox_tpu_torch.embedding import ckpt_store
    from paddlebox_tpu_torch.train import checkpoint as pckpt
    files, pfeed = data
    r = port_runner("plain", 1, pfeed, SEEDS, sharded={"fleet": fl})
    cm = pckpt.CheckpointManager(CheckpointConfig(
        batch_model_dir=str(tmp_path / "batch"),
        xbox_model_dir=str(tmp_path / "xbox"), save_delta_every_passes=1,
        async_save=False), r.table, CkptFlags())
    assert cm.store is r.table.shard.store
    dss = []
    for _ in range(2):
        ds = BoxDataset(pfeed)
        ds.set_filelist(files)
        dss.append(ds)
    stats, (batch_dir, _) = pckpt.run_day(r, dss, cm, "d0", preload=False)
    assert [s["steps"] for s in stats] == [4, 4]
    reader = pckpt.XboxModelReader(str(tmp_path / "xbox"), "d0")
    assert reader.deltas_applied == 2
    keys, vals = sorted_store(r.table.store)
    assert keys.size > 50 and vals[:, acc.SHOW].sum() > 0
    # the base holds every row the day's shrink (end_day) kept
    base = pckpt.read_batch_sparse(batch_dir)
    assert np.isin(keys, np.asarray(base["keys"], np.uint64)).all()
    hot = keys[np.argsort(vals[:, acc.SHOW], kind="stable")[-5:]]
    rows = reader.lookup(hot)
    assert rows.shape == (5, 1 + 4)
    assert np.abs(rows).sum() > 0
    with open(os.path.join(batch_dir, "dense.pkl"), "rb") as fh:
        dense = ckpt_store.safe_load(fh)
    for k, v in r.params.items():
        assert_bits(np.asarray(dense["params"][k])[0], v)
    assert dense["opt_state"]["count"] == 8
    r.close()


# ------------------------------------------------------------ refusals

def test_refusals(data, fl):
    from paddlebox_tpu_torch.parallel.pipeline import \
        ShardedCtrPipelineRunner
    _, pfeed = data
    with pytest.raises(ValueError, match="must divide by n_stages=2"):
        ShardedCtrPipelineRunner(table_cfg(), pfeed, n_stages=2, n_micro=3,
                                 fleet=fl, device="cpu")
    with pytest.raises(ValueError, match="mesh stage axis 1 != n_stages 2"):
        ShardedCtrPipelineRunner(table_cfg(), pfeed, n_stages=2, n_micro=4,
                                 fleet=fl, device="cpu")
    r = ShardedCtrPipelineRunner(table_cfg(), pfeed, n_stages=1, n_micro=4,
                                 fleet=fl, device="cpu")
    with pytest.raises(ValueError, match="n_micro=4 batches"):
        r.host_batch([])
    r.close()
    assert fl.mesh is not None       # a fleet the caller passed stays up
