"""Aux side-table demo: InputTable rows consumed through the feed path.

The port of examples/train_aux_input.py: the InputTableDataFeed /
lookup_input composition (data_feed.h:2221-2252; pull_box_sparse_op.cc:
173-208). Training lines lead with an instance id (``parse_ins_id``), the
feed translates each id to an aux-row offset at pack time, and the model
gathers the frozen rows on the device. The click signal depends on a
per-item attribute that lives ONLY in the aux table, so the lift over the
no-table run is the capability demonstrated.

    python -m paddlebox_tpu_torch.examples.train_aux_input [--passes 4]
"""

import argparse
import os
import sys
import tempfile

import numpy as np

if __package__ in (None, ""):   # run by path: the repository on sys.path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

NUM_SLOTS, VOCAB, AUX_DIM, N_ITEMS = 4, 200, 8, 16


def write_files(out_dir: str, n_lines: int, n_items: int, num_slots: int,
                vocab: int, seed: int):
    """ins_id-prefixed MultiSlot lines; click driven by the item group."""
    rng = np.random.RandomState(seed)
    groups = (np.arange(n_items) % 2).astype(np.float32)
    path = os.path.join(out_dir, "part-00000.txt")
    with open(path, "w") as f:
        for _ in range(n_lines):
            item = rng.randint(n_items)
            click = int(rng.rand() < (0.85 if groups[item] else 0.15))
            toks = [f"item{item}", f"1 {click}"]
            for si in range(num_slots):
                n = rng.randint(1, 4)
                feas = rng.randint(0, vocab, n) + si * vocab
                toks.append(str(n) + " " + " ".join(map(str, feas)))
            f.write(" ".join(toks) + "\n")
    return [path], groups


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="train_aux_input")
    ap.add_argument("--passes", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the steps run (no CPU fallback)")
    return ap.parse_args(argv)


def main(argv=None, on_trainer=None) -> dict:
    """Run the demo; ``on_trainer(trainer)`` is called before the first
    pass. Returns the passes' stats and the aux table's misses and
    rows."""
    args = parse_args(argv)
    import torch

    from paddlebox_tpu_torch.config.configs import (DataFeedConfig,
                                                    SlotConfig,
                                                    SparseOptimizerConfig,
                                                    TableConfig,
                                                    TrainerConfig)
    from paddlebox_tpu_torch.data import BoxDataset
    from paddlebox_tpu_torch.device import resolve_device
    from paddlebox_tpu_torch.embedding.side_tables import InputTable
    from paddlebox_tpu_torch.models.aux_input import CtrDnnAux
    from paddlebox_tpu_torch.models.base import ModelSpec
    from paddlebox_tpu_torch.train.trainer import BoxTrainer

    device = resolve_device(args.device)
    slots = [SlotConfig("click", type="float", dim=1, is_used=False)]
    slots += [SlotConfig(f"slot_{i}", type="uint64", max_len=3)
              for i in range(NUM_SLOTS)]
    feed = DataFeedConfig(slots=tuple(slots), batch_size=64,
                          parse_ins_id=True)
    data_dir = tempfile.mkdtemp(prefix="pbx_aux_")
    files, groups = write_files(data_dir, 2048, N_ITEMS, NUM_SLOTS, VOCAB,
                                seed=3)

    # the serving-side item attribute store (filled by some upstream job)
    aux = InputTable(AUX_DIM)
    rng = np.random.RandomState(0)
    for i in range(N_ITEMS):
        row = rng.randn(AUX_DIM).astype(np.float32) * 0.1
        row[0] = 2.0 * groups[i] - 1.0          # the learnable attribute
        aux.add_index_data(f"item{i}", row)

    table = TableConfig(
        embedx_dim=8, pass_capacity=1 << 14,
        optimizer=SparseOptimizerConfig(mf_create_thresholds=0.0,
                                        mf_initial_range=1e-3))
    model = CtrDnnAux(ModelSpec(num_slots=NUM_SLOTS, slot_dim=3 + 8),
                      aux_dim=AUX_DIM, aux_capacity=64, hidden=(64, 32),
                      generator=torch.Generator().manual_seed(0))
    trainer = BoxTrainer(model, table, feed, TrainerConfig(dense_lr=5e-3),
                         seed=0, aux_source=aux, device=device)
    if on_trainer is not None:
        on_trainer(trainer)

    out = []
    for i in range(args.passes):
        ds = BoxDataset(feed, read_threads=1, input_table=aux)
        ds.set_filelist(files)
        stats = trainer.train_pass(ds)
        out.append(stats)
        print(f"pass {i}: loss={stats['loss']:.4f} "
              f"batches={stats['batches']} (aux misses so far {aux.miss})")
        ds.release_memory()
    print(f"aux rows served: {aux.size()} items, dim {AUX_DIM}")
    trainer.close()
    return {"passes": out, "aux_miss": aux.miss, "aux_rows": aux.size(),
            "files": files}


if __name__ == "__main__":
    main()
