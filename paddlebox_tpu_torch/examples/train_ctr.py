"""End-to-end CTR training demo: the BoxPS day workflow on one GPU.

The port of examples/train_ctr.py. Generates synthetic MultiSlot data,
then runs the pass cadence a PaddleBox user knows (streaming AUC,
two-tier checkpointing: a batch model and an xbox serving view a pass,
pass-boundary recovery) on the single-GPU BoxTrainer. Every pull runs the
gather_rows kernel and every push the fused push_adagrad kernel
(push_adagrad_expand with --expand-dim); --push-write rebuild places the
pushed rows with the rebuild gather.

    python -m paddlebox_tpu_torch.examples.train_ctr [--passes 4] [--bf16]
    python paddlebox_tpu_torch/examples/train_ctr.py --device cpu

Rerun with the same --workdir to resume after the completed passes.
"""

import argparse
import os
import sys
import tempfile

if __package__ in (None, ""):   # run by path: the repository on sys.path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="train_ctr")
    ap.add_argument("--passes", type=int, default=4)
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 dense compute")
    ap.add_argument("--expand-dim", type=int, default=0,
                    help="NN-cross: train a second (expand) embedding "
                         "block per feature through the extended pull "
                         "(pull_box_extended_sparse path)")
    ap.add_argument("--push-write", default="auto",
                    choices=("auto", "scatter", "rebuild"),
                    help="slab write strategy (auto: PushFlags."
                         "resolve_push_write's choice, printed)")
    ap.add_argument("--sparse-chunk-sync", action="store_true",
                    help="one merged table update per scan chunk "
                         "(effective sparse batch = chunk x batch; dense "
                         "adam stays exact per batch)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the steps run (no CPU fallback: 'cuda' "
                         "without a GPU is an error)")
    return ap.parse_args(argv)


def main(argv=None, on_trainer=None) -> dict:
    """Run the demo. ``on_trainer(trainer)``, when given, is called once
    the trainer is built, before any pass (a test loads reference weights
    there). Returns the passes' stats, the AUC message, the resolved push
    write and the workdir."""
    args = parse_args(argv)
    import torch

    from paddlebox_tpu_torch.config.configs import (CheckpointConfig,
                                                    SparseOptimizerConfig,
                                                    TableConfig,
                                                    TrainerConfig)
    from paddlebox_tpu_torch.config.flags import PushFlags
    from paddlebox_tpu_torch.data import BoxDataset, write_synthetic_ctr_files
    from paddlebox_tpu_torch.device import resolve_device
    from paddlebox_tpu_torch.models import CtrDnnExpand, DeepFM
    from paddlebox_tpu_torch.models.base import ModelSpec
    from paddlebox_tpu_torch.train.checkpoint import CheckpointManager
    from paddlebox_tpu_torch.train.recovery import RecoverableRunner
    from paddlebox_tpu_torch.train.trainer import BoxTrainer

    device = resolve_device(args.device)
    work = args.workdir or tempfile.mkdtemp(prefix="pbx_demo_")
    data_dir = os.path.join(work, "data")
    print(f"workdir: {work}")

    # --- data: 4 files of learnable synthetic CTR text (MultiSlot format)
    files, feed = write_synthetic_ctr_files(
        data_dir, num_files=4, lines_per_file=2000, num_slots=16,
        vocab_per_slot=1000, max_len=4, seed=7)
    feed = type(feed)(slots=feed.slots, batch_size=256)

    # --- model + table (DeepFM over a per-pass slab on the card)
    D = 8
    table = TableConfig(
        embedx_dim=D, pass_capacity=1 << 18,
        expand_embed_dim=args.expand_dim,
        optimizer=SparseOptimizerConfig(mf_create_thresholds=0.0,
                                        mf_initial_range=1e-3))
    spec = ModelSpec(num_slots=16, slot_dim=3 + D)
    gen = torch.Generator().manual_seed(0)
    model = (CtrDnnExpand(spec, expand_dim=args.expand_dim,
                          hidden=(256, 128), generator=gen)
             if args.expand_dim
             else DeepFM(spec, hidden=(256, 128), generator=gen))
    trainer = BoxTrainer(
        model, table, feed,
        TrainerConfig(dense_lr=1e-3,
                      compute_dtype="bfloat16" if args.bf16 else "float32",
                      sparse_chunk_sync=args.sparse_chunk_sync),
        seed=0, flags=PushFlags(push_write=args.push_write), device=device)
    trainer.metrics.init_metric("auc", "label", "pred", mask_var="mask")
    print(f"push write: {args.push_write} -> {trainer.push_write} "
          f"on {device.type}")
    if on_trainer is not None:
        on_trainer(trainer)

    # --- pass cadence with per-pass checkpoints (resume-able: rerun this
    #     script with --workdir to continue after a crash)
    ckpt = CheckpointManager(CheckpointConfig(
        batch_model_dir=os.path.join(work, "batch_model"),
        xbox_model_dir=os.path.join(work, "xbox_model"),
        async_save=False), trainer.table)
    runner = RecoverableRunner(trainer, ckpt, day="demo")

    def datasets():
        out = []
        for _ in range(args.passes):
            ds = BoxDataset(feed, read_threads=2)
            ds.set_filelist(files)
            out.append(ds)
        return out

    done = runner.completed_passes()
    if done:
        print(f"resuming after {done} completed passes")
    stats = runner.run(datasets())  # skips completed passes itself

    for i, s in enumerate(stats):
        print(f"pass {i}: loss={s['loss']:.4f} instances={s['instances']}")
    msg = trainer.metrics.get_metric_msg("auc")
    print("streaming AUC:", {k: round(v, 4) for k, v in msg.items()
                             if k in ("auc", "size", "actual_ctr")})
    print(f"checkpoints under {work}/batch_model/demo/ "
          f"(xbox serving views under xbox_model/)")
    trainer.close()
    return {"passes": stats, "auc": msg, "push_write": trainer.push_write,
            "resumed_after": done, "workdir": work}


if __name__ == "__main__":
    main()
