"""paddlebox_tpu_torch/examples/train_aux_input.py on the CPU against the
reference demo's composition (examples/train_aux_input.py) built here from
the JAX modules.

The reference composition is the demo's own calls (its ins_id files, an
InputTable of 16 items, CtrDnnAux (64, 32) at batch 64, read_threads=1)
with ``use_pallas_push`` and its kernel interpreted, whose creation hash
the port follows (tests/test_torch_train.py). The port's demo takes the
reference's initial weights and replays its push seeds through
``main(on_trainer=)``.

Held: the demo's file byte-identical to the reference demo's
``write_files``; each pass's batches equal and loss rtol 1e-4 (float32
sums and matmuls in another order, fed back through the embeddings: the
tolerance of tests/test_torch_train.py); the aux table's misses and rows
equal; the demo's printed lines.
"""

import functools
import importlib.util
import os

import jax
import numpy as np

from examples_parity import pass_seeds
from paddlebox_tpu_torch.convert import params_from_jax
from paddlebox_tpu_torch.examples import train_aux_input

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PASSES = 2
STEPS = 2048 // 64


def reference_demo():
    """The reference's examples/train_aux_input.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "ref_train_aux_input", os.path.join(REPO, "examples",
                                            "train_aux_input.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_run(out_dir, monkeypatch):
    """(files, initial params, passes' stats, aux misses and rows) of the
    reference demo's composition."""
    from paddlebox_tpu.config import flags as jflags
    from paddlebox_tpu.config.configs import (DataFeedConfig, SlotConfig,
                                              SparseOptimizerConfig,
                                              TableConfig, TrainerConfig)
    from paddlebox_tpu.data import BoxDataset
    from paddlebox_tpu.embedding.side_tables import InputTable
    from paddlebox_tpu.models.aux_input import CtrDnnAux
    from paddlebox_tpu.models.base import ModelSpec
    from paddlebox_tpu.train.trainer import BoxTrainer
    import paddlebox_tpu.embedding.pallas_push as pp

    ref = reference_demo()
    monkeypatch.setattr(pp, "pallas_apply_push", functools.partial(
        pp.pallas_apply_push, interpret=True))
    jflags.set_flag("use_pallas_push", True)
    try:
        slots = [SlotConfig("click", type="float", dim=1, is_used=False)]
        slots += [SlotConfig(f"slot_{i}", type="uint64", max_len=3)
                  for i in range(4)]
        feed = DataFeedConfig(slots=tuple(slots), batch_size=64,
                              parse_ins_id=True)
        files, groups = ref.write_files(out_dir, 2048, 16, 4, 200, seed=3)
        aux = InputTable(8)
        rng = np.random.RandomState(0)
        for i in range(16):
            row = rng.randn(8).astype(np.float32) * 0.1
            row[0] = 2.0 * groups[i] - 1.0
            aux.add_index_data(f"item{i}", row)
        table = TableConfig(
            embedx_dim=8, pass_capacity=1 << 14,
            optimizer=SparseOptimizerConfig(mf_create_thresholds=0.0,
                                            mf_initial_range=1e-3))
        model = CtrDnnAux(ModelSpec(num_slots=4, slot_dim=3 + 8), aux_dim=8,
                          aux_capacity=64, hidden=(64, 32))
        trainer = BoxTrainer(model, table, feed,
                             TrainerConfig(dense_lr=5e-3), seed=0,
                             aux_source=aux)
        params = jax.tree.map(np.asarray, trainer.params)
        stats = []
        for _ in range(PASSES):
            ds = BoxDataset(feed, read_threads=1, input_table=aux)
            ds.set_filelist(files)
            stats.append(trainer.train_pass(ds))
            ds.release_memory()
        trainer.close()
    finally:
        jflags.set_flag("use_pallas_push", False)
    return files, params, stats, (aux.miss, aux.size())


def test_train_aux_input_matches_the_reference_demo(tmp_path, monkeypatch,
                                                    capsys):
    ref_files, params, want, (miss, rows) = reference_run(str(tmp_path),
                                                          monkeypatch)
    seeds = iter(pass_seeds(PASSES, STEPS))

    def on_trainer(trainer):
        trainer.model.load_state_dict(params_from_jax(params))
        trainer.seed_fn = seeds.__next__

    got = train_aux_input.main(["--passes", str(PASSES), "--device", "cpu"],
                               on_trainer=on_trainer)
    out = capsys.readouterr().out
    assert "aux rows served: 17 items, dim 8" in out, out
    assert "pass 1: loss=" in out
    with open(got["files"][0], "rb") as a, open(ref_files[0], "rb") as b:
        assert a.read() == b.read()
    assert (got["aux_miss"], got["aux_rows"]) == (miss, rows)
    for g, w in zip(got["passes"], want, strict=True):
        assert g["batches"] == w["batches"] == STEPS
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
