"""paddlebox_tpu_torch/examples/train_ctr.py on the CPU against the
reference demo's composition (examples/train_ctr.py) built here from the
JAX modules.

The reference composition is the demo's own calls (its files, DeepFM
(256, 128) over 16 slots at batch 256, a 2^18-row table,
RecoverableRunner with a checkpoint a pass) with two changes:
``read_threads=1`` (the reference's ``read_threads=2`` merges its files
in arrival order, so its runs do not repeat; the port's merge in file
order at any ``read_threads``) and ``use_pallas_push`` with its kernel
interpreted, whose creation hash the port follows (tests/
test_torch_train.py). The port's demo takes the reference's initial
weights and replays its push seeds through ``main(on_trainer=)``.
``--expand-dim 4`` runs the expand block, which the reference pushes in
XLA (apply_push): its creation draws are the port's hash there
(tests/test_torch_expand.py hash_fresh).

Held: the synthetic files byte-identical; each pass's loss rtol 1e-4 and
the final AUC within 1e-4 (float32 sums and matmuls in another order,
fed back through the embeddings over 64 steps: the tolerances of
tests/test_torch_train.py); the demo's printed lines; a rerun on the same
--workdir resumes after the completed passes.
"""

import functools
import os

import jax
import numpy as np
import pytest

from examples_parity import hash_fresh, pass_seeds
from paddlebox_tpu_torch.convert import params_from_jax
from paddlebox_tpu_torch.examples import train_ctr

PASSES = 2
STEPS = (4 * 2000 + 255) // 256     # a pass over the demo's 8,000 lines


def reference_run(work, expand_dim, monkeypatch):
    """The reference demo's composition at read_threads=1: (its initial
    params, its passes' stats, its AUC message)."""
    from paddlebox_tpu.config import flags as jflags
    from paddlebox_tpu.config.configs import (CheckpointConfig,
                                              SparseOptimizerConfig,
                                              TableConfig, TrainerConfig)
    from paddlebox_tpu.data import BoxDataset, write_synthetic_ctr_files
    from paddlebox_tpu.models import CtrDnnExpand, DeepFM
    from paddlebox_tpu.models.base import ModelSpec
    from paddlebox_tpu.train.checkpoint import CheckpointManager
    from paddlebox_tpu.train.recovery import RecoverableRunner
    from paddlebox_tpu.train.trainer import BoxTrainer
    import paddlebox_tpu.embedding.optimizers as jopt
    import paddlebox_tpu.embedding.pallas_push as pp

    D = 8
    if expand_dim:
        monkeypatch.setattr(jopt, "_fresh_uniform", hash_fresh(D))
    else:
        monkeypatch.setattr(pp, "pallas_apply_push", functools.partial(
            pp.pallas_apply_push, interpret=True))
        jflags.set_flag("use_pallas_push", True)
    try:
        files, feed = write_synthetic_ctr_files(
            os.path.join(work, "data"), num_files=4, lines_per_file=2000,
            num_slots=16, vocab_per_slot=1000, max_len=4, seed=7)
        feed = type(feed)(slots=feed.slots, batch_size=256)
        table = TableConfig(
            embedx_dim=D, pass_capacity=1 << 18, expand_embed_dim=expand_dim,
            optimizer=SparseOptimizerConfig(mf_create_thresholds=0.0,
                                            mf_initial_range=1e-3))
        spec = ModelSpec(num_slots=16, slot_dim=3 + D)
        model = (CtrDnnExpand(spec, expand_dim=expand_dim, hidden=(256, 128))
                 if expand_dim else DeepFM(spec, hidden=(256, 128)))
        trainer = BoxTrainer(model, table, feed, TrainerConfig(dense_lr=1e-3),
                             seed=0)
        params = jax.tree.map(np.asarray, trainer.params)
        trainer.metrics.init_metric("auc", "label", "pred", mask_var="mask")
        ckpt = CheckpointManager(CheckpointConfig(
            batch_model_dir=os.path.join(work, "batch_model"),
            xbox_model_dir=os.path.join(work, "xbox_model"),
            async_save=False), trainer.table)
        runner = RecoverableRunner(trainer, ckpt, day="demo")
        dss = []
        for _ in range(PASSES):
            ds = BoxDataset(feed, read_threads=1)
            ds.set_filelist(files)
            dss.append(ds)
        stats = runner.run(dss)
        msg = trainer.metrics.get_metric_msg("auc")
        trainer.close()
    finally:
        jflags.set_flag("use_pallas_push", False)
    return files, params, stats, msg


@pytest.mark.parametrize("expand_dim", [0, 4], ids=["defaults", "expand4"])
def test_train_ctr_matches_the_reference_demo(expand_dim, tmp_path,
                                              monkeypatch, capsys):
    ref_files, params, want, want_msg = reference_run(
        str(tmp_path / "ref"), expand_dim, monkeypatch)
    seeds = iter(pass_seeds(PASSES, STEPS))

    def on_trainer(trainer):
        trainer.model.load_state_dict(params_from_jax(params))
        trainer.seed_fn = seeds.__next__

    work = str(tmp_path / "port")
    argv = ["--passes", str(PASSES), "--device", "cpu", "--workdir", work]
    if expand_dim:
        argv += ["--expand-dim", str(expand_dim)]
    got = train_ctr.main(argv, on_trainer=on_trainer)
    out = capsys.readouterr().out
    for line in ("push write: auto -> scatter on cpu", "pass 0: loss=",
                 "pass 1: loss=", "streaming AUC:", "checkpoints under"):
        assert line in out, out
    port_files = sorted(os.listdir(os.path.join(work, "data")))
    assert port_files == [os.path.basename(f) for f in ref_files]
    for name, ref in zip(port_files, ref_files):
        with open(os.path.join(work, "data", name), "rb") as a, \
                open(ref, "rb") as b:
            assert a.read() == b.read(), name
    assert len(got["passes"]) == len(want) == PASSES
    for g, w in zip(got["passes"], want):
        assert g["instances"] == w["instances"] == 8000
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
    assert abs(got["auc"]["auc"] - want_msg["auc"]) <= 1e-4, (
        got["auc"]["auc"], want_msg["auc"])
    assert got["auc"]["size"] == want_msg["size"]
    assert got["push_write"] == "scatter" and got["resumed_after"] == 0
    if not expand_dim:
        # rerun on the same --workdir: the checkpoints cover both passes,
        # so the demo resumes after them and trains none, as the
        # reference's RecoverableRunner skips completed passes
        again = train_ctr.main(argv)
        assert "resuming after 2 completed passes" in capsys.readouterr().out
        assert again["resumed_after"] == PASSES and again["passes"] == []
