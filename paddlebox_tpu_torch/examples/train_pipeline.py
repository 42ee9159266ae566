"""Pipeline-parallel CTR training demo: the program split across stages.

The port of examples/train_pipeline.py: the reference's
HeterPipelineTrainer/SectionWorker capability (optimizer.py:7496-7575
cut_list -> section_worker.cc). Stage 0 owns the sparse section (the pull
on the gather_rows kernel, fused seqpool+CVM, the input projection),
every stage owns a block of the deep tower, the last stage owns the head
and the loss; micro-batches cross the stages point to point, and the
gradients flow back into the fused push kernel.

It is a rank program: a stage is a rank of the stage process group, one
process a GPU, so S is the world size (fleet/launch.py --nproc S); run
alone it is one stage.

    python -m paddlebox_tpu_torch.fleet.launch --nproc 2 \\
        paddlebox_tpu_torch/examples/train_pipeline.py --passes 4

Every rank writes the same seeded files into a directory of its own and
loads all of them (the stage group is one data-parallel row).
--sharded-slab key-mod-shards the pass table over the stage ranks; its
"features trained" line sums the shards' key counts over the group (the
port's store_view is the one shard at world 1 only).
"""

import argparse
import os
import sys
import tempfile

if __package__ in (None, ""):   # run by path: the repository on sys.path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="train_pipeline")
    ap.add_argument("--passes", type=int, default=4)
    ap.add_argument("--stages", type=int, default=0,
                    help="pipeline stages (default and only value: the "
                         "world size, one rank a stage)")
    ap.add_argument("--micro", type=int, default=0,
                    help="micro-batches per step (default: 2 x stages)")
    ap.add_argument("--sharded-slab", action="store_true",
                    help="key-mod-shard the pass table over the stage "
                         "ranks (O(pass/P) table memory a rank) instead of "
                         "replicating it")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the rank's device (no CPU fallback)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="the process groups' timeout, seconds (a rank "
                         "that never arrives fails the others' collective "
                         "after it)")
    return ap, ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run this rank's stage; returns its passes' stats and the features
    trained (across the shards with --sharded-slab)."""
    ap, args = parse_args(argv)
    import numpy as np

    from paddlebox_tpu_torch.config.configs import (SparseOptimizerConfig,
                                                    TableConfig)
    from paddlebox_tpu_torch.data import BoxDataset, write_synthetic_ctr_files
    from paddlebox_tpu_torch.fleet.fleet import Fleet
    from paddlebox_tpu_torch.obs import log
    from paddlebox_tpu_torch.train.factory import create_trainer

    fl = Fleet().init()
    mesh = fl.init_distributed(args.timeout, device=args.device)
    rank = mesh.rank
    log.set_rank(rank)
    S = args.stages or mesh.world
    if S != mesh.world:
        fl.stop()
        ap.error(f"--stages {S}: a stage is a rank, so S is the world size "
                 f"({mesh.world}; fleet/launch.py --nproc S)")
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"pipeline: {S} stages × {mesh.device.type}")
    data_dir = tempfile.mkdtemp(prefix="pbx_pipe_")
    files, feed = write_synthetic_ctr_files(
        data_dir, num_files=4, lines_per_file=800, num_slots=8,
        vocab_per_slot=500, max_len=4, seed=7)
    feed = type(feed)(slots=feed.slots, batch_size=64)

    D = 8
    table = TableConfig(
        embedx_dim=D, pass_capacity=1 << 15,
        optimizer=SparseOptimizerConfig(mf_create_thresholds=0.0,
                                        mf_initial_range=1e-3))
    # the factory resolves the reference trainer name to the CTR program
    # split; --sharded-slab picks the composition over the key-mod-sharded
    # table
    name = ("ShardedCtrPipelineTrainer" if args.sharded_slab
            else "HeterPipelineTrainer")
    extra = dict(fleet=fl) if args.sharded_slab else {}
    runner = create_trainer(name, table, feed, n_stages=S, d_model=64,
                            layers_per_stage=1, lr=5e-3,
                            n_micro=args.micro or 2 * S, seed=0,
                            device=mesh.device, **extra)

    stats = []
    for i in range(args.passes):
        ds = BoxDataset(feed, read_threads=2)
        ds.set_filelist(files)
        stats.append(runner.train_pass(ds))
        say(f"pass {i}: loss={stats[-1]['loss']:.4f} "
            f"steps={stats[-1]['steps']} "
            f"(dropped {stats[-1]['dropped_batches']} tail batches)")
        ds.release_memory()
    if args.sharded_slab:
        keys, _ = runner.table.shard.store.state_items()
        n = int(fl.all_reduce(np.asarray([keys.size], np.int64), "sum")[0])
        say(f"features trained: {n} across {runner.table.num_shards} "
            f"shards (shard slab {runner.table.shard_cap} rows)")
    else:
        keys, _ = runner.table.store.state_items()
        n = int(keys.size)
        say("features trained:", n)
    runner.close()
    fl.stop()
    return {"passes": stats, "features": n, "stages": S, "rank": rank}


if __name__ == "__main__":
    main()
