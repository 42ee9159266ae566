"""Sequence parallelism across ranks: the port's ring and Ulysses attention
and its SeqCtrTrainer over an ``sp`` process group, against the JAX
package's under shard_map on a P-device mesh of virtual CPU devices
(tests/conftest.py).

The port runs P = 2 and 4 gloo ranks, each spawned by the test
(tests/sharded_cluster.py run_cluster, a process group timeout and a wall
limit). Tolerances:

  * ring_attention and ulysses_attention, causal and not: each rank's
    output chunk and the gradients of its q, k and v chunks (one seeded
    cotangent through the whole sequence) against the reference's vjp of
    its shard_mapped function, rtol 1e-5 / atol 1e-6;
  * SeqCtrTrainer with a BstSeqCtr of n_shards = P (ring and Ulysses), two
    passes over all the files on every rank, the reference's push seeds
    replayed (PRNGKey(seed + 29), one split a step) against the JAX
    SeqCtrTrainer on a P-device sp mesh with use_pallas_push (its kernel
    interpreted): each pass's loss rtol 1e-4 and AUC 1e-4 absolute, the
    dense parameters rtol 1e-4 / atol 1e-6, the store's integer columns
    exact and its rows rtol 1e-4 / atol 1e-7, predict_batches' predictions
    rtol 1e-4 / atol 1e-6 (float32 attention, reductions and all-reduces
    in another order);
  * across the group's ranks the losses, dense parameters, stores and
    predictions are bit-identical: every rank applies the same push to
    its replicated slab.
"""

import functools

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch.config.configs import (DataFeedConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)
from paddlebox_tpu_torch.convert import params_from_jax
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.bst import BstSeqCtr
from paddlebox_tpu_torch.parallel import ring_attention as pring
from paddlebox_tpu_torch.parallel.seq_trainer import SeqCtrTrainer
from sharded_cluster import assert_bits, join_group, run_cluster

D = 4
NUM_SLOTS = 4
BATCH = 16
MAX_LEN = 10
SEQ_LEN = 8           # shorter than MAX_LEN: long histories are cut
SEQ_SLOT = 1
CAP = 1024
LR = 5e-3
OPT = dict(mf_create_thresholds=0.0, mf_initial_range=1e-3)
INT_COLS = [acc.SLOT, acc.SHOW, acc.CLICK, acc.UNSEEN_DAYS, acc.MF_SIZE]
BST = dict(heads=4, d_head=4, d_seq=8, hidden=(16, 8))
ATTN = [(name, causal) for name in ("ring_attention", "ulysses_attention")
        for causal in (False, True)]
QKV = dict(B=2, T=16, H=8, Dh=8)
MAX_STEPS = 64        # push seeds replayed: more than two passes take


def qkv_w():
    rng = np.random.RandomState(3)
    shape = (QKV["B"], QKV["T"], QKV["H"], QKV["Dh"])
    return [rng.randn(*shape).astype(np.float32) for _ in range(4)]


def ptable():
    return TableConfig(embedx_dim=D, pass_capacity=CAP,
                       optimizer=SparseOptimizerConfig(**OPT))


def _seq_rank(rank, world, port, spec):
    """A spawned rank: the attention forms on its chunk, then each
    attention's SeqCtrTrainer over the world's sp group."""
    join_group(rank, world, port)
    tl = QKV["T"] // world
    chunk = slice(rank * tl, (rank + 1) * tl)
    q, k, v, w = (torch.from_numpy(np.ascontiguousarray(a[:, chunk]))
                  for a in qkv_w())
    out = {"attn": {}, "trainer": {}}
    for name, causal in ATTN:
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = getattr(pring, name)(*leaves, causal=causal)
        (o * w).sum().backward()
        out["attn"][(name, causal)] = (o.detach().numpy(),
                                       [t.grad.numpy() for t in leaves])
    pfeed = spec["feed"]
    for attn in ("ring", "ulysses"):
        model = BstSeqCtr(ModelSpec(NUM_SLOTS, 3 + D), seq_len=SEQ_LEN,
                          n_shards=world, attn=attn, **BST)
        model.load_state_dict(params_from_jax(spec["params"][attn]))
        t = SeqCtrTrainer(model, ptable(), pfeed,
                          TrainerConfig(dense_lr=LR), seq_slot=SEQ_SLOT,
                          seed=0, device="cpu")
        t.metrics.init_metric("auc", "label", "pred", table_size=1 << 14)
        t.seed_fn = iter(spec["seeds"]).__next__
        passes = []
        for _ in range(2):
            ds = BoxDataset(pfeed)
            ds.set_filelist(spec["files"])
            r = t.train_pass(ds)
            passes.append((r["loss"], t.metrics.get_metric_msg("auc")["auc"],
                           r["batches"]))
        keys, rows = sorted_store(t.table.store)
        ds = BoxDataset(pfeed)
        ds.set_filelist(spec["files"])
        preds = t.predict_batches(ds)
        out["trainer"][attn] = {"passes": passes, "params": t.params,
                                "keys": keys, "rows": rows, "preds": preds,
                                "P": t.P, "sp_rank": t.sp_rank}
    return out


def sorted_store(store):
    k, v = store.state_items()
    order = np.argsort(k)
    return k[order], v[order]


def replay_seeds(n, seed=0):
    """The reference seq trainer's push seeds: PRNGKey(seed + 29), one
    split a step carried across passes, randint of the split-off key."""
    import jax
    import jax.numpy as jnp
    key, out = jax.random.PRNGKey(seed + 29), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(int(jax.random.randint(sub, (), 0, jnp.int32(2**31 - 1))))
    return out


def jax_attention(P):
    """{(name, causal): (out, [dq, dk, dv])} of the reference's forms over
    the full sequence, shard_mapped on a P-device sp mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as PS
    from paddlebox_tpu.parallel import ring_attention as jring
    q, k, v, w = (jnp.asarray(a) for a in qkv_w())
    mesh = Mesh(np.array(jax.devices()[:P]), ("sp",))
    spec = PS(None, "sp")
    out = {}
    for name, causal in ATTN:
        fn = jax.shard_map(
            functools.partial(getattr(jring, name), axis_name="sp",
                              causal=causal),
            mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)

        def fwd_bwd(q, k, v, w, fn=fn):
            o, vjp = jax.vjp(fn, q, k, v)
            return o, vjp(w)

        o, grads = jax.jit(fwd_bwd)(q, k, v, w)
        out[(name, causal)] = (np.asarray(o), [np.asarray(g) for g in grads])
    return out


def jax_model(P, attn):
    from paddlebox_tpu.models.base import ModelSpec as JSpec
    from paddlebox_tpu.models.bst import BstSeqCtr as JBst
    return JBst(JSpec(NUM_SLOTS, 3 + D), seq_len=SEQ_LEN, n_shards=P,
                attn=attn, **BST)


def jax_params0(P, attn, seed=0):
    """The reference trainer's initial parameters (host_init(seed))."""
    return {k: np.asarray(v)
            for k, v in jax_model(P, attn).host_init(seed)[0].items()}


def jax_trainers(files, jfeed, P):
    """The reference's SeqCtrTrainer on a P-device sp mesh for each
    attention: its initial parameters, two passes and predict_batches."""
    import jax
    from jax.sharding import Mesh
    from paddlebox_tpu.config import flags as jflags
    from paddlebox_tpu.config.configs import SparseOptimizerConfig as JOpt
    from paddlebox_tpu.config.configs import TableConfig as JTable
    from paddlebox_tpu.config.configs import TrainerConfig as JTC
    from paddlebox_tpu.data.dataset import BoxDataset as JDataset
    from paddlebox_tpu.parallel.seq_trainer import SeqCtrTrainer as JSeq
    import paddlebox_tpu.embedding.pallas_push as pp
    old = jflags.get_flag("use_pallas_push")
    jflags.set_flag("use_pallas_push", True)
    patch = pytest.MonkeyPatch()
    patch.setattr(pp, "pallas_apply_push",
                  functools.partial(pp.pallas_apply_push, interpret=True))
    out = {}
    try:
        for attn in ("ring", "ulysses"):
            jt = JSeq(jax_model(P, attn), JTable(embedx_dim=D, pass_capacity=CAP,
                                 optimizer=JOpt(**OPT)), jfeed,
                      JTC(dense_lr=LR), seq_slot=SEQ_SLOT, seed=0,
                      mesh=Mesh(np.array(jax.devices()[:P]), ("sp",)))
            params0 = {k: np.asarray(v) for k, v in jt.params.items()}
            jt.metrics.init_metric("auc", "label", "pred",
                                   table_size=1 << 14)
            passes = []
            for _ in range(2):
                ds = JDataset(jfeed, read_threads=1, columnar=False)
                ds.set_filelist(files)
                r = jt.train_pass(ds)
                passes.append((r["loss"],
                               jt.metrics.get_metric_msg("auc")["auc"],
                               r["batches"]))
            keys, rows = sorted_store(jt.table.store)
            ds = JDataset(jfeed, read_threads=1, columnar=False)
            ds.set_filelist(files)
            out[attn] = {"params0": params0, "passes": passes,
                         "params": {k: np.asarray(v)
                                    for k, v in jt.params.items()},
                         "keys": keys, "rows": rows,
                         "preds": jt.predict_batches(ds)}
    finally:
        jflags.set_flag("use_pallas_push", old)
        patch.undo()
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from paddlebox_tpu_torch.data.generator import write_synthetic_ctr_files
    out = tmp_path_factory.mktemp("torch_seq_cluster_data")
    files, feed = write_synthetic_ctr_files(
        str(out), num_files=2, lines_per_file=32, num_slots=NUM_SLOTS,
        vocab_per_slot=60, max_len=MAX_LEN, seed=13)
    pfeed = DataFeedConfig(slots=feed.slots, batch_size=BATCH)
    from paddlebox_tpu.config.configs import DataFeedConfig as JFeed
    from paddlebox_tpu.config.configs import SlotConfig as JSlot
    jfeed = JFeed(slots=tuple(JSlot(name=s.name, type=s.type, dim=s.dim,
                                    is_used=s.is_used, max_len=s.max_len)
                              for s in feed.slots), batch_size=BATCH)
    return files, jfeed, pfeed


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def clusters(request, data, tmp_path_factory):
    P = request.param
    files, jfeed, pfeed = data
    spec = {"fn": _seq_rank, "feed": pfeed, "files": files,
            "params": {a: jax_params0(P, a) for a in ("ring", "ulysses")},
            "seeds": replay_seeds(MAX_STEPS)}
    # the oracle runs while the ranks do
    ranks, (want, attn) = run_cluster(
        P, spec, tmp_path_factory.mktemp("torch_seq_cluster_P%d" % P),
        meanwhile=lambda: (jax_trainers(files, jfeed, P), jax_attention(P)))
    for a in want:
        assert_bits(want[a]["params0"]["pos_emb"],
                    spec["params"][a]["pos_emb"])
        assert sum(b for _, _, b in want[a]["passes"]) <= MAX_STEPS
    return P, ranks, want, attn


def _close(got, want, rtol, atol, msg):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.mark.parametrize("name,causal", ATTN)
def test_attention_forward_and_grads_match_shard_map(clusters, name,
                                                     causal):
    P, ranks, _, want = clusters
    wo, wg = want[(name, causal)]
    tl = QKV["T"] // P
    for r, res in enumerate(ranks):
        o, grads = res["attn"][(name, causal)]
        chunk = slice(r * tl, (r + 1) * tl)
        assert not np.isnan(o).any()
        _close(o, wo[:, chunk], 1e-5, 1e-6, "%s out, rank %d" % (name, r))
        for g, w, which in zip(grads, wg, "qkv"):
            _close(g, w[:, chunk], 1e-5, 1e-6,
                   "%s d%s, rank %d" % (name, which, r))


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_seq_trainer_matches_jax(clusters, attn):
    P, ranks, want, _ = clusters
    w = want[attn]
    for r, res in enumerate(ranks):
        got = res["trainer"][attn]
        assert (got["P"], got["sp_rank"]) == (P, r)
        for (gl, ga, gb), (wl, wa, wb) in zip(got["passes"], w["passes"]):
            assert gb == wb
            np.testing.assert_allclose(gl, wl, rtol=1e-4)
            assert abs(ga - wa) <= 1e-4, (ga, wa)
        for k, v in w["params"].items():
            _close(got["params"][k], v, 1e-4, 1e-6, "%s rank %d" % (k, r))
        np.testing.assert_array_equal(got["keys"], w["keys"])
        np.testing.assert_array_equal(got["rows"][:, INT_COLS],
                                      w["rows"][:, INT_COLS])
        _close(got["rows"], w["rows"], 1e-4, 1e-7, "store, rank %d" % r)
        np.testing.assert_array_equal(got["preds"][1], w["preds"][1])
        _close(got["preds"][0], w["preds"][0], 1e-4, 1e-6,
               "preds, rank %d" % r)


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_ranks_hold_identical_stores(clusters, attn):
    _, ranks, _, _ = clusters
    first = ranks[0]["trainer"][attn]
    for res in ranks[1:]:
        got = res["trainer"][attn]
        assert got["passes"] == first["passes"]
        np.testing.assert_array_equal(got["keys"], first["keys"])
        assert_bits(got["rows"], first["rows"])
        assert_bits(got["preds"][0], first["preds"][0])
        for k, v in first["params"].items():
            assert_bits(got["params"][k], v)
