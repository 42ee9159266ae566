"""The sharded trainer's modes against the JAX package's and the port's
own runs: the blocked and rebuild writes, the uid, delta and ids-only
wires, K-step, ZeRO-1, the 2-D mesh and sync_one_ring, the bf16 a2a, the
expand block and device-collect AUC.

Clusters of P gloo ranks (tests/sharded_cluster.py: spawned ranks of one
thread, a process group timeout, a TCPStore on an ephemeral port, a wall
limit here) against the JAX ShardedBoxTrainer on a P-device mesh of
virtual CPU devices, its push kernel interpreted, every rank replaying
its shard's push seeds. Tolerances, unless a test says otherwise: each
pass's loss rtol 1e-4; the cluster AUC 1e-4 absolute; the store's integer
columns bit-equal and its float columns rtol 1e-4 / atol 1e-6; the dense
parameters rtol 1e-4 / atol 1e-6 (f32 reductions in another order by XLA,
ATen and gloo). Within the port every write and wire gives the scatter
run's bits, as the reference pins its own (tests/test_sharded.py:501-522),
and sync_one_ring on a 2 x 2 mesh gives the flat run's.

A world of one in process (gloo): each mode equals the single-device
BoxTrainer bit for bit, as the card's world-1 runs are held to the main
path; ZeRO-1, whose hand-written Adam rounds otherwise than
torch.optim.Adam, within the dense tolerance.
"""

import dataclasses

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch.config.configs import TrainerConfig
from paddlebox_tpu_torch.config.flags import PushFlags, StageFlags
from paddlebox_tpu_torch.embedding.pass_table import dedup_uids_sorted
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.models.nn_cross import CtrDnnExpand
from paddlebox_tpu_torch.parallel.mesh import device_mesh_2d
from paddlebox_tpu_torch.parallel.sharded_table import (
    ShardedPassTable, exchange_push_uids_p2p, stage_push_dedup)
from paddlebox_tpu_torch.parallel.sharded_trainer import ShardedBoxTrainer
from paddlebox_tpu_torch.train.trainer import BoxTrainer
from sharded_cluster import (D, E, HIDDEN, INT_COLS, LR, NUM_SLOTS,
                             assert_bits,
                             assert_matches_jax, assert_params,
                             assert_same_run, cluster_spec, flat_leaves,
                             jax_reference, port_dataset, run_cluster,
                             table_cfg, use_jax_pallas, world_one,
                             write_data)

# the wires as StageFlags fields
WIRES = {"full": {}, "uid": dict(h2d_lean=True),
         "delta": dict(h2d_lean=True, wire_delta_ids=True),
         "ids_only": dict(h2d_lean=True, h2d_uid_wire=False)}
# blocked writes at P = 2 and 4 need a block that divides the shard
BLOCK_ROWS = 64


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """8 files of 96 lines: 3 batches a file, so one file a rank is a pass
    of an odd step count (K-step's pass-end sync)."""
    return write_data(tmp_path_factory.mktemp("torch_sharded_modes"),
                      lines=96)


@pytest.fixture
def jax_pallas(monkeypatch):
    use_jax_pallas(monkeypatch)


def n_steps_of(ref):
    return sum(p[2] for p in ref["passes"])


# ------------------------------------------------------ world one, in process

W1_SEEDS = [int(x) for x in np.random.RandomState(1).randint(0, 2**31 - 1,
                                                             64)]

# (sharded trainer keywords, BoxTrainer keywords, model, bit for bit)
W1_MODES = {
    "blocked": (dict(push_flags=PushFlags("blocked")),
                dict(flags=PushFlags("blocked")), "deepfm", True),
    "rebuild": (dict(push_flags=PushFlags("rebuild")),
                dict(flags=PushFlags("rebuild")), "deepfm", True),
    "uid": (dict(stage_flags=StageFlags(**WIRES["uid"])), {}, "deepfm",
            True),
    "delta": (dict(stage_flags=StageFlags(**WIRES["delta"])), {}, "deepfm",
              True),
    "ids_only": (dict(stage_flags=StageFlags(**WIRES["ids_only"])), {},
                 "deepfm", True),
    "uid_blocked": (dict(stage_flags=StageFlags(**WIRES["uid"]),
                         push_flags=PushFlags("blocked")),
                    dict(flags=PushFlags("blocked")), "deepfm", True),
    "k_step": (dict(cfg=dict(sync_mode="k_step", sync_weight_step=2)), {},
               "deepfm", True),
    "mesh_1x1": (dict(mesh2d=(1, 1)), {}, "deepfm", True),
    "one_ring": (dict(mesh2d=(1, 1), cfg=dict(sync_one_ring=True)), {},
                 "deepfm", True),
    "expand": ({}, {}, "expand", True),
    "zero1": (dict(cfg=dict(sync_mode="sharding")), {}, "deepfm", False),
}


def w1_model(name, state):
    spec = ModelSpec(num_slots=NUM_SLOTS, slot_dim=3 + D)
    m = (CtrDnnExpand(spec, E, hidden=HIDDEN) if name == "expand"
         else DeepFM(spec, hidden=HIDDEN))
    m.load_state_dict(state)
    return m


def w1_passes(t, pfeed, files, store):
    t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
    t.seed_fn = iter(W1_SEEDS).__next__
    res = []
    for _ in range(2):
        ds = port_dataset(pfeed, files)
        ds.set_filelist(files)
        r = t.train_pass(ds)
        res.append((r["loss"], t.metrics.get_metric_msg("auc")["auc"]))
    k, v = store().state_items()
    o = np.argsort(k)
    return res, k[o], v[o], t.params


@pytest.mark.parametrize("mode", sorted(W1_MODES))
def test_world_one_mode_equals_the_single_device_trainer(mode, data):
    """At world 1 (gloo in process) each mode gives BoxTrainer's two
    passes bit for bit (losses, AUC, the store, the dense parameters);
    ZeRO-1 within the dense tolerance."""
    files, pfeed = data
    skw, bkw, model, exact = W1_MODES[mode]
    skw = dict(skw)
    torch.manual_seed(3)
    spec = ModelSpec(num_slots=NUM_SLOTS, slot_dim=3 + D)
    base = (CtrDnnExpand(spec, E, hidden=HIDDEN) if model == "expand"
            else DeepFM(spec, hidden=HIDDEN))
    state = {k: v.clone() for k, v in base.state_dict().items()}
    table = table_cfg(E if model == "expand" else 0)
    fields = dict(dense_lr=LR, scan_chunk=4, **skw.pop("cfg", {}))
    single = BoxTrainer(w1_model(model, state), table, pfeed,
                        TrainerConfig(dense_lr=LR, scan_chunk=4), seed=0,
                        device="cpu", stage_flags=skw.get("stage_flags"),
                        **bkw)
    fl = world_one()
    try:
        mesh2d = skw.pop("mesh2d", None)
        mesh = device_mesh_2d(fl.mesh, *mesh2d) if mesh2d else None
        sharded = ShardedBoxTrainer(w1_model(model, state), table, pfeed,
                                    TrainerConfig(**fields), seed=0,
                                    fleet=fl, device="cpu", mesh=mesh,
                                    **skw)
        got = w1_passes(sharded, pfeed, files[:4],
                        lambda: sharded.table.stores[0])
        want = w1_passes(single, pfeed, files[:4], lambda: single.table.store)
        np.testing.assert_array_equal(got[1], want[1])
        if exact:
            assert got[0] == want[0]
            assert_bits(got[2], want[2])
            gp = flat_leaves(got[3])
            for k, v in flat_leaves(want[3]).items():
                assert_bits(gp[k], v)
        else:
            np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
            np.testing.assert_allclose(got[2], want[2], rtol=1e-4,
                                       atol=1e-6)
            assert_params(got[3], want[3])
        c = sharded.collective_counts
        steps = 2 * 12
        if mode in ("uid", "delta", "ids_only", "uid_blocked"):
            assert c["a2a_ids"] == steps
        if mode == "k_step":
            # every 2 steps; 12 steps a pass end on a sync
            assert c["param_sync"] == steps // 2
        if mode == "mesh_1x1":
            assert c["reduce_scatter"] == c["all_gather"] == steps
        if mode == "one_ring":
            assert c["all_reduce"] == steps and not c["reduce_scatter"]
        if mode == "zero1":
            assert c["reduce_scatter"] == c["all_gather"] == steps
            mu, nu, t = sharded.opt_state
            assert int(t) == steps and mu.shape == nu.shape == (
                1, sharded._n_dense)
    finally:
        single.close()
        fl.stop()


def test_mode_errors(data):
    """The reference's refusals: ZeRO-1 implements adam only, it excludes
    K-step; a mesh is a ShardMesh; a process hosts one shard; a 2-D mesh's
    shape fits the world; the ids-only wire has no products for the
    blocked write."""
    _, pfeed = data
    model = DeepFM(ModelSpec(num_slots=NUM_SLOTS, slot_dim=3 + D),
                   hidden=HIDDEN)
    with pytest.raises(ValueError, match="adam only"):
        ShardedBoxTrainer(model, table_cfg(), pfeed,
                          TrainerConfig(sharding=True,
                                        dense_optimizer="sgd"),
                          device="cpu")
    with pytest.raises(ValueError, match="exclusive"):
        ShardedBoxTrainer(model, table_cfg(), pfeed,
                          TrainerConfig(sync_mode="k_step", sharding=True,
                                        sync_weight_step=2), device="cpu")
    with pytest.raises(TypeError, match="ShardMesh"):
        ShardedBoxTrainer(model, table_cfg(), pfeed, mesh=object(),
                          device="cpu")
    with pytest.raises(ValueError, match="one shard a process"):
        ShardedPassTable(table_cfg(), 2, 64, owned_shards=[0, 1],
                         device="cpu")
    fl = world_one()
    try:
        with pytest.raises(ValueError, match="nodes x"):
            device_mesh_2d(fl.mesh, 2, 1)
        m = device_mesh_2d(fl.mesh)
        assert (m.nodes, m.chips, m.chip, m.hier) == (1, 1, 0, True)
        assert not fl.mesh.hier
        with pytest.raises(ValueError, match="stages no push products"):
            ShardedBoxTrainer(model, table_cfg(), pfeed, fleet=fl,
                              device="cpu", push_flags=PushFlags("blocked"),
                              stage_flags=StageFlags(**WIRES["ids_only"]))
    finally:
        fl.stop()


# ------------------------------------------------------------ host plane

class FakeMesh:
    """P ranks of MeshComm's exchange in threads of one process: each
    rank's ``exchange(parts)`` returns {source: the part it sent here}."""

    def __init__(self, world, rank, board, barrier):
        self.world, self.rank = world, rank
        self.positions_of = {r: [r] for r in range(world)}
        self._board, self._barrier = board, barrier

    def rank_of_position(self):
        return {r: r for r in range(self.world)}

    def exchange(self, parts):
        for dst, part in parts.items():
            self._board[(self.rank, dst)] = part
        self._barrier.wait()
        got = {src: self._board[(src, self.rank)] for src in range(self.world)}
        self._barrier.wait()
        return got


def threaded_exchange(P, fn):
    """fn(mesh) on P threads over one FakeMesh board: results by rank."""
    import threading
    board, barrier = {}, threading.Barrier(P)
    out = [None] * P

    def run(r):
        out[r] = fn(FakeMesh(P, r, board, barrier))

    threads = [threading.Thread(target=run, args=(r,)) for r in range(P)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    return out


def route_batches(P, kb=512):
    """Each rank's [P, KB] buckets of one batch (deduplicated per column,
    the trash id shard_cap - 1 padding), from the port's router."""
    rng = np.random.RandomState(200 + P)
    batches = []
    for _ in range(P):
        keys = rng.randint(0, 3000, 512).astype(np.uint64)
        valid = np.ones(512, bool)
        valid[-64:] = False
        batches.append((keys, valid))
    t = ShardedPassTable(
        dataclasses.replace(table_cfg(), pass_capacity=P * 4096), P, kb,
        owned_shards=[0], device="cpu")
    t.begin_feed_pass()
    t.add_keys(np.concatenate([k for k, _ in batches]))
    t.end_feed_pass()
    return [t.bucketize(k, v.copy()).buckets for k, v in batches], t.shard_cap


@pytest.mark.parametrize("P", [2, 4])
def test_exchange_push_uids_matches_the_reference(P):
    """Dedup before the wire: every owner's uids equal the reference's
    exchange_push_uids_p2p over the same buckets and the sorted dedup of
    its whole incoming column; the real-id count is the column's non-trash
    ids."""
    from paddlebox_tpu.parallel.sharded_table import \
        exchange_push_uids_p2p as jexchange
    buckets, cap = route_batches(P)
    got = threaded_exchange(P, lambda m: exchange_push_uids_p2p(
        buckets[m.rank][None], [m.rank], P, cap, m))
    want = threaded_exchange(P, lambda m: jexchange(
        buckets[m.rank][None], [m.rank], P, cap, m))
    for d in range(P):
        uids, n_real = got[d]
        inc = np.concatenate([buckets[s][d] for s in range(P)])
        np.testing.assert_array_equal(uids[d], want[d][d])
        np.testing.assert_array_equal(uids[d], dedup_uids_sorted(inc, cap))
        assert n_real[d] == int((inc != cap - 1).sum())


@pytest.mark.parametrize("P", [2, 4])
def test_stage_push_dedup_arms_match_the_reference(P):
    """The rebuild arm's position map and the uid-only arm's sorted uids
    against the reference's stage_push_dedup (its sorted tier: the port's
    dedup always sorts)."""
    from concurrent.futures import ThreadPoolExecutor
    from paddlebox_tpu.parallel.sharded_table import \
        stage_push_dedup as jstage
    buckets, cap = route_batches(P)
    with ThreadPoolExecutor(2) as pool:
        want_r = jstage(buckets, list(range(P)), P, cap, False, None,
                        rebuild=True, pool=pool, sort_uids=True)
        want_u = jstage(buckets, list(range(P)), P, cap, False, None,
                        rebuild=True, pool=pool, uid_only=True)
    assert "push_pos" not in want_u
    for d in range(P):
        inc = np.stack([buckets[s][d] for s in range(P)])
        got = stage_push_dedup({d: inc}, cap, rebuild=True)
        for k in ("push_uids", "push_perm", "push_inv", "push_pos"):
            np.testing.assert_array_equal(got[k][0], want_r[k][d], err_msg=k)
        uid = stage_push_dedup({d: inc}, cap, rebuild=True, uid_only=True)
        assert set(uid) == {"push_uids", "n_uniq"}
        np.testing.assert_array_equal(uid["push_uids"][0],
                                      want_u["push_uids"][d])
        via = stage_push_dedup(None, cap, uid_only=True,
                               uids_by_dest={d: want_u["push_uids"][d]})
        np.testing.assert_array_equal(via["push_uids"][0],
                                      want_u["push_uids"][d])
        assert via["n_uniq"] == uid["n_uniq"] == got["n_uniq"]


# ------------------------------------------------------------- clusters

@pytest.mark.parametrize("P", [2, 4])
def test_writes_and_wires_match_jax(P, data, jax_pallas, tmp_path):
    """The blocked and rebuild writes and the uid, delta and ids-only wires
    against the JAX runs of the same write (the full host dedup under
    h2d_uid_wire off, the uid wire on); every one bit-identical to the
    port's scatter run; the lean wires' ids on the device a2a."""
    files, pfeed = data
    full = dict(h2d_uid_wire=False)
    jruns = {"scatter": full, "uid": {}}
    if P == 2:
        jruns.update(blocked=dict(full, push_write="blocked",
                                  push_block_rows=BLOCK_ROWS),
                     rebuild=dict(full, push_write="rebuild"))
    refs = {name: jax_reference(files, pfeed, P, flags=fl)
            for name, fl in jruns.items()}
    runs = [{"name": "scatter", "push": "scatter"},
            {"name": "blocked", "push": "blocked", "push_rows": BLOCK_ROWS},
            {"name": "rebuild", "push": "rebuild"},
            {"name": "uid", "stage": WIRES["uid"]},
            {"name": "uid_rebuild", "push": "rebuild",
             "stage": WIRES["uid"]},
            {"name": "delta", "stage": WIRES["delta"]},
            {"name": "ids_only", "stage": WIRES["ids_only"]}]
    ref = refs["scatter"]
    got = run_cluster(P, cluster_spec(pfeed, files, P, {"deepfm": ref}, runs,
                                      n_steps_of(ref)), tmp_path)
    steps = n_steps_of(ref)
    for r, ranks in enumerate(got):
        for i, (run, res) in enumerate(zip(runs, ranks)):
            assert_same_run(res, ranks[0])
            want = refs.get(run["name"], ref)
            assert_matches_jax(res, want, r)
            c = res["collectives"]
            lean = "stage" in run
            assert c.get("a2a_ids", 0) == (steps if lean else 0), c
            # one host exchange a step (the fleet's, over every run)
            assert res["exchanges"] == steps * (i + 1)
    for name in refs:
        # the JAX writes agree among themselves too
        for a, b in zip(refs[name]["stores"], ref["stores"]):
            np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("P", [2, 4])
def test_k_step_matches_jax(P, data, jax_pallas, tmp_path):
    """K-step with K = 2 over passes of 3 steps (one file a rank): local
    dense steps, a sync every second step and at each pass end (a
    missing pass-end sync leaves the replicas apart); DeepFM, and at P = 2
    CtrDnn, whose data_norm summaries diverge until the sync."""
    files, pfeed = data
    files = files[:P]
    fields = dict(sync_mode="k_step", sync_weight_step=2)
    models = ["deepfm"] + (["ctr_dnn"] if P == 2 else [])
    refs = {m: jax_reference(files, pfeed, P, model_name=m, fields=fields)
            for m in models}
    ref = refs["deepfm"]
    assert [p[2] for p in ref["passes"]] == [3, 3]
    runs = [{"model": m, "cfg": fields} for m in models]
    got = run_cluster(P, cluster_spec(pfeed, files, P, refs, runs,
                                      n_steps_of(ref)), tmp_path)
    for r, ranks in enumerate(got):
        for run, res in zip(runs, ranks):
            assert_matches_jax(res, refs[run["model"]], r)
            # a sync at step 2 and at the end of each 3-step pass
            assert res["collectives"]["param_sync"] == 4
            assert "all_reduce" not in res["collectives"]
            # the replicas equal after the pass-end sync
            for k, v in flat_leaves(res["params"]).items():
                assert_bits(flat_leaves(got[0][runs.index(run)]["params"])[k],
                            v)


@pytest.mark.parametrize("P", [2, 4])
def test_zero1_matches_jax(P, data, jax_pallas, tmp_path):
    """ZeRO-1: the flat grads reduce-scattered, this rank's slice updated
    by the reference's Adam, the slices all-gathered; each rank's moment
    slice held to the JAX shard's, the step count equal."""
    files, pfeed = data
    fields = dict(sync_mode="sharding")
    ref = jax_reference(files, pfeed, P, fields=fields)
    runs = [{"cfg": fields}]
    got = run_cluster(P, cluster_spec(pfeed, files, P, {"deepfm": ref}, runs,
                                      n_steps_of(ref)), tmp_path)
    jmu, jnu, jt = ref["opt_state"]
    assert jmu.shape[0] == P
    for r, ranks in enumerate(got):
        res = ranks[0]
        assert_matches_jax(res, ref, r)
        mu, nu, t = res["opt_state"]
        assert int(t) == int(jt) == n_steps_of(ref)
        assert mu.shape == (1, jmu.shape[1])
        np.testing.assert_allclose(mu[0], jmu[r], rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(nu[0], jnu[r], rtol=1e-3, atol=1e-11)
        c = res["collectives"]
        assert c["reduce_scatter"] == c["all_gather"] == n_steps_of(ref)


@pytest.mark.parametrize("mode", ["step", "sharding"])
def test_2d_mesh_matches_jax_and_the_flat_run(mode, data, jax_pallas,
                                              tmp_path):
    """The 2 x 2 mesh at P = 4 (CtrDnn with data_norm, as the reference's
    own test): reduce-scatter over the chips, all_reduce over the nodes,
    all_gather over the chips, ZeRO-1's moments over the chip axis;
    against JAX device_mesh_2d(2, 2) and within rtol 1e-4 of the port's
    flat run; sync_one_ring on the 2 x 2 mesh is the flat run bit for
    bit."""
    files, pfeed = data
    P = 4
    fields = dict(sync_mode=mode)
    ref = jax_reference(files, pfeed, P, model_name="ctr_dnn", fields=fields,
                        mesh2d=(2, 2))
    runs = [{"model": "ctr_dnn", "cfg": fields},
            {"model": "ctr_dnn", "cfg": fields, "mesh2d": (2, 2)}]
    if mode == "step":
        runs.append({"model": "ctr_dnn", "mesh2d": (2, 2),
                     "cfg": dict(fields, sync_one_ring=True)})
    got = run_cluster(P, cluster_spec(pfeed, files, P, {"ctr_dnn": ref},
                                      runs, n_steps_of(ref)), tmp_path)
    steps = n_steps_of(ref)
    for r, ranks in enumerate(got):
        flat, hier = ranks[0], ranks[1]
        assert_matches_jax(hier, ref, r)
        np.testing.assert_allclose([p[0] for p in hier["passes"]],
                                   [p[0] for p in flat["passes"]], rtol=1e-4)
        np.testing.assert_allclose(hier["store"][1], flat["store"][1],
                                   rtol=1e-4, atol=1e-6)
        assert_params(hier["params"], flat["params"])
        c = hier["collectives"]
        assert c["reduce_scatter"] == c["all_reduce_node"] == steps
        assert c["all_gather"] == steps
        if mode == "sharding":
            # moments over the chip axis: half the flat vector a rank
            n = sum(v.size for v in flat_leaves(flat["params"]).values())
            assert hier["opt_state"][0].shape[1] == -(-n // 2)
            assert flat["opt_state"][0].shape[1] == -(-n // P)
        else:
            assert_same_run(ranks[2], flat)
            assert ranks[2]["collectives"]["all_reduce"] == steps


def test_bf16_a2a_matches_jax_and_tracks_f32(data, jax_pallas, tmp_path):
    """a2a_dtype 'bfloat16' at P = 2 over three passes: against the JAX
    run at bf16 (losses rtol 1e-3, the store's integer columns bit-equal,
    its float columns and the dense parameters rtol 2e-2 / atol 1e-4:
    a one-ulp f32 difference may round to another bf16), and within the
    reference's rtol 3e-2 of the port's f32 run, still learning; the
    a2as' bytes: the pull's values halved, the push rows' gradient
    columns halved beside an f32 a2a of their three count columns."""
    files, pfeed = data
    P = 2
    ref = jax_reference(files, pfeed, P, fields=dict(a2a_dtype="bfloat16"),
                        passes=3)
    runs = [{"passes": 3}, {"passes": 3, "cfg": dict(a2a_dtype="bfloat16")}]
    got = run_cluster(P, cluster_spec(pfeed, files, P, {"deepfm": ref}, runs,
                                      n_steps_of(ref)), tmp_path)
    for r, ranks in enumerate(got):
        f32, bf = ranks
        for (gl, ga, gb), (wl, wa, wb) in zip(bf["passes"], ref["passes"]):
            assert gb == wb
            np.testing.assert_allclose(gl, wl, rtol=1e-3)
            assert abs(ga - wa) <= 1e-3, (ga, wa)
        (gk, gv), (wk, wv) = bf["store"], ref["stores"][r]
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gv[:, INT_COLS], wv[:, INT_COLS])
        np.testing.assert_allclose(gv, wv, rtol=2e-2, atol=1e-4)
        assert_params(bf["params"], ref["params"], rtol=2e-2, atol=1e-4)
        l16 = [p[0] for p in bf["passes"]]
        np.testing.assert_allclose(l16, [p[0] for p in f32["passes"]],
                                   rtol=3e-2)
        assert l16[-1] < l16[0], l16
        b32, b16 = f32["a2a_bytes"], bf["a2a_bytes"]
        assert b16["a2a_pull"] * 2 == b32["a2a_pull"]
        width = 4 + D       # the push row: slot, show, click, grads
        assert b16["a2a_push_meta"] == b32["a2a_push"] * 3 // width
        assert b16["a2a_push"] == b32["a2a_push"] * (width - 3) // width // 2


def test_expand_block_matches_jax(data, jax_pallas, tmp_path):
    """CtrDnnExpand (expand 8) at P = 2: the extended pull's base and
    expand columns on one a2a, split after the restore, the expand rows
    sum-pooled, their grads pushed through the fused push's expand form,
    against the JAX run (its push through apply_push with the port's
    creation hash)."""
    files, pfeed = data
    P = 2
    ref = jax_reference(files, pfeed, P, model_name="expand")
    runs = [{"model": "expand"}]
    got = run_cluster(P, cluster_spec(pfeed, files, P, {"expand": ref}, runs,
                                      n_steps_of(ref)), tmp_path)
    for r, ranks in enumerate(got):
        res = ranks[0]
        assert_matches_jax(res, ref, r)
        assert res["store"][1].shape[1] == ref["stores"][r][1].shape[1]


def test_device_collect_auc_matches_the_host_mode(data, jax_pallas,
                                                   tmp_path):
    """Device-collect AUC at P = 2 against the JAX ShardedBoxTrainer in its
    own mode_collect_in_device over the same inputs (the pass's loss and
    AUC, store and dense state at the cluster tolerances; mae, rmse,
    actual_ctr and predicted_ctr rtol 1e-4, bucket_error atol 5e-3, the
    reference's gates of tests/test_sharded.py:429-471), and against the
    port's host mode at those gates (AUC rtol 2e-3); the collect mode
    reads two tensors a pass to the host and never the predictions."""
    files, pfeed = data
    P = 2
    metric = dict(mask_var="mask")
    collect = dict(metric, mode_collect_in_device=True)
    ref = jax_reference(files, pfeed, P, passes=3, metric=collect)
    runs = [{"metric": metric, "passes": 3},
            {"metric": collect, "passes": 3}]
    spec = cluster_spec(pfeed, files, P, {"deepfm": ref}, runs,
                        n_steps_of(ref))
    got = run_cluster(P, spec, tmp_path)
    for r, ranks in enumerate(got):
        host, dev = ranks
        assert_matches_jax(dev, ref, r)
        # the same training: the metrics read nothing the step writes
        assert [p[0] for p in host["passes"]] == [p[0] for p in dev["passes"]]
        assert dev["d2h_reads"] == 2 * 3
        assert host["d2h_reads"] >= 3
        for mj, mh, md in zip(ref["msgs"], host["msgs"], dev["msgs"]):
            assert md["size"] == mh["size"] == mj["size"]
            assert abs(md["auc"] - mj["auc"]) <= 1e-4, (md["auc"],
                                                         mj["auc"])
            np.testing.assert_allclose(md["auc"], mh["auc"], rtol=2e-3)
            for want in (mj, mh):
                for k in ("mae", "rmse", "actual_ctr", "predicted_ctr"):
                    np.testing.assert_allclose(md[k], want[k], rtol=1e-4,
                                               err_msg=k)
                np.testing.assert_allclose(md["bucket_error"],
                                           want["bucket_error"], atol=5e-3)
