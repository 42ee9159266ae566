"""Model-parallel tower demo: TP wide DeepFM or expert-parallel MMoE.

The port of examples/train_mesh_tower.py. When a tower does not fit
replicated, its wide layer column/row-splits (Megatron) or its expert
blocks shard over an ``mp`` process group, and MeshTowerTrainer runs the
full sparse hot loop (the pull on the gather_rows kernel, the fused
push) with the TP autodiff contracts enforced in code (tp_loss_scale and
tp_fix_grads: no partial or P-scaled gradients).

It is a rank program: the mp group is the world, one process a GPU
(fleet/launch.py --nproc P); run alone the model has one shard and no
collective runs (tensor_parallel.LOCAL).

    python -m paddlebox_tpu_torch.fleet.launch --nproc 2 \\
        paddlebox_tpu_torch/examples/train_mesh_tower.py --kind tp

Every rank writes the same seeded files into a directory of its own and
trains on all of them (the ranks hold the slab and the batch
replicated).
"""

import argparse
import os
import sys
import tempfile

if __package__ in (None, ""):   # run by path: the repository on sys.path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="train_mesh_tower")
    ap.add_argument("--kind", choices=("tp", "ep"), default="tp")
    ap.add_argument("--passes", type=int, default=4)
    ap.add_argument("--wide", type=int, default=1024,
                    help="TP tower hidden width (splits over the ranks)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the rank's device (no CPU fallback)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="the process groups' timeout, seconds (a rank "
                         "that never arrives fails the others' collective "
                         "after it)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run this rank's shard of the tower; returns its passes' stats and
    the features trained."""
    args = parse_args(argv)
    from paddlebox_tpu_torch.config.configs import (SparseOptimizerConfig,
                                                    TableConfig,
                                                    TrainerConfig)
    from paddlebox_tpu_torch.data import BoxDataset, write_synthetic_ctr_files
    from paddlebox_tpu_torch.fleet.fleet import Fleet
    from paddlebox_tpu_torch.models.base import ModelSpec
    from paddlebox_tpu_torch.models.wide_tower import EpMMoE, TpDeepFM
    from paddlebox_tpu_torch.obs import log
    from paddlebox_tpu_torch.parallel.tensor_parallel import LOCAL
    from paddlebox_tpu_torch.train.factory import create_trainer

    fl = Fleet().init()
    mesh = fl.init_distributed(args.timeout, device=args.device)
    P, rank = mesh.world, mesh.rank
    log.set_rank(rank)
    say = print if rank == 0 else (lambda *a, **k: None)
    data_dir = tempfile.mkdtemp(prefix="pbx_mt_")
    files, feed = write_synthetic_ctr_files(
        data_dir, num_files=4, lines_per_file=800, num_slots=8,
        vocab_per_slot=500, max_len=4, seed=11)
    feed = type(feed)(slots=feed.slots, batch_size=128)
    D = 8
    table = TableConfig(
        embedx_dim=D, pass_capacity=1 << 15,
        optimizer=SparseOptimizerConfig(mf_create_thresholds=0.0,
                                        mf_initial_range=1e-3))
    spec = ModelSpec(num_slots=8, slot_dim=3 + D)
    if args.kind == "tp":
        model = TpDeepFM(spec, n_shards=P, d_wide=args.wide, d_mid=64)
        say(f"TP DeepFM: {args.wide}-wide layer split over {P} ranks "
            f"({args.wide // P} columns each)")
    else:
        model = EpMMoE(spec, n_shards=P, n_experts=2 * P, d_hidden=64,
                       d_out=32)
        say(f"EP MMoE: {2 * P} experts over {P} ranks (2 each)")
    trainer = create_trainer("MeshTowerTrainer", model, table, feed,
                             TrainerConfig(dense_lr=5e-3), seed=0,
                             group=LOCAL if P == 1 else None,
                             device=mesh.device)

    stats = []
    for i in range(args.passes):
        ds = BoxDataset(feed, read_threads=2)
        ds.set_filelist(files)
        stats.append(trainer.train_pass(ds))
        say(f"pass {i}: loss={stats[-1]['loss']:.4f} "
            f"batches={stats[-1]['batches']}")
        ds.release_memory()
    keys, _ = trainer.table.store.state_items()
    say("features trained:", keys.size)
    fl.stop()
    return {"passes": stats, "features": int(keys.size), "world": P,
            "rank": rank}


if __name__ == "__main__":
    main()
