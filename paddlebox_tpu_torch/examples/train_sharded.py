"""Multi-GPU CTR training demo: the key-sharded table over the ranks.

The port of examples/train_sharded.py. The sharded trainer (the table
sharded key % P, one shard a rank, the pull and push as all-to-alls, the
dense gradients all-reduced) with load(N+1) || train(N) preload overlap.
It is a rank program: P is the world size, one process a GPU, started by
the port's launcher (NCCL on the card, gloo with --device cpu); run
alone it is a world of one.

    python -m paddlebox_tpu_torch.fleet.launch --nproc 2 \\
        paddlebox_tpu_torch/examples/train_sharded.py --passes 3 \\
        [--sync k_step|sharding]

Every rank writes the same seeded files into a directory of its own (the
generator is deterministic, so no shared directory is needed) and loads
its share, the files at i % P == rank. With --gpups rank 0 hosts a TCP
CPU PS and publishes its endpoint over the fleet's KV store; the shard
stores front it (PSGPUTrainer). The AUC and the PS's row count print once,
from rank 0.
"""

import argparse
import os
import sys
import tempfile

if __package__ in (None, ""):   # run by path: the repository on sys.path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

PS_ENDPOINT_KEY = "train_sharded/ps_endpoint"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="train_sharded")
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--sync", default="step",
                    choices=["step", "k_step", "sharding"])
    ap.add_argument("--mesh-2d", type=int, default=0, metavar="NODES",
                    help="hierarchical (node, chip) mesh with this many "
                         "node rows: the dense sync reduce-scatters in a "
                         "node and all-reduces 1/chips of the bytes "
                         "across nodes")
    ap.add_argument("--a2a-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="wire format of the pull/push value all_to_alls "
                         "(bfloat16 halves the bytes)")
    ap.add_argument("--device-auc", action="store_true",
                    help="accumulate the AUC bucket table on the device "
                         "(one copy to the host a pass)")
    ap.add_argument("--gpups", action="store_true",
                    help="back the shard stores with a TCP CPU PS")
    ap.add_argument("--ssd-budget-mb", type=float, default=0,
                    help="feed-ranking posture: host-DRAM row budget; rows "
                         "beyond it spill to an SSD tier each end_pass")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the rank's device (no CPU fallback)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="the process groups' timeout, seconds (a rank "
                         "that never arrives fails the others' collective "
                         "after it)")
    args = ap.parse_args(argv)
    if args.gpups and args.ssd_budget_mb:
        ap.error("--ssd-budget-mb spills the LOCAL host stores; with "
                 "--gpups the stores live on the CPU PS (its tables manage "
                 "their own tiering) - pick one")
    return ap, args


def main(argv=None) -> dict:
    """Run this rank; returns its passes' stats, the cluster's AUC
    message and (with --gpups) the PS's row count."""
    ap, args = parse_args(argv)
    import torch

    from paddlebox_tpu_torch.config.configs import (SparseOptimizerConfig,
                                                    TableConfig,
                                                    TrainerConfig)
    from paddlebox_tpu_torch.data import BoxDataset, write_synthetic_ctr_files
    from paddlebox_tpu_torch.fleet.fleet import Fleet
    from paddlebox_tpu_torch.models import DeepFM
    from paddlebox_tpu_torch.models.base import ModelSpec
    from paddlebox_tpu_torch.obs import log
    from paddlebox_tpu_torch.parallel.mesh import device_mesh_2d
    from paddlebox_tpu_torch.train.factory import create_trainer
    from paddlebox_tpu_torch.train.preload import run_preloaded_passes

    fl = Fleet().init()
    mesh = fl.init_distributed(args.timeout, device=args.device)
    P, rank = mesh.world, mesh.rank
    log.set_rank(rank)
    if args.mesh_2d:
        if P % args.mesh_2d:
            fl.stop()
            ap.error(f"--mesh-2d {args.mesh_2d} does not divide "
                     f"{P} ranks")
        mesh = device_mesh_2d(mesh, n_nodes=args.mesh_2d)
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"devices: {P} × {mesh.device.type} ({mesh.backend})")
    data_dir = tempfile.mkdtemp(prefix="pbx_sharded_")
    files, feed = write_synthetic_ctr_files(
        data_dir, num_files=max(4, P), lines_per_file=1000, num_slots=16,
        vocab_per_slot=800, max_len=4, seed=11)
    feed = type(feed)(slots=feed.slots, batch_size=128)

    D = 8
    table = TableConfig(
        embedx_dim=D, pass_capacity=P * (1 << 15),
        optimizer=SparseOptimizerConfig(mf_create_thresholds=0.0,
                                        mf_initial_range=1e-3),
        ssd_dir=(os.path.join(data_dir, "ssd") if args.ssd_budget_mb
                 else None),
        ssd_threshold_mb=args.ssd_budget_mb)
    tcfg = TrainerConfig(dense_lr=1e-3, sync_mode=args.sync,
                         sync_weight_step=4 if args.sync == "k_step" else 1,
                         sharding=args.sync == "sharding",
                         a2a_dtype=args.a2a_dtype)

    server = ps_client = None
    name, ps = "ShardedBoxTrainer", {}
    if args.gpups:
        from paddlebox_tpu_torch.ps import PSServer, TcpPSClient
        kv = fl.store_client()
        if rank == 0:
            server = PSServer()
            endpoint = "127.0.0.1:%d" % server.port
            if kv is not None:
                kv.set(PS_ENDPOINT_KEY, endpoint.encode())
        else:
            endpoint = kv.wait(PS_ENDPOINT_KEY).decode()
        host, port = endpoint.rsplit(":", 1)
        ps_client = TcpPSClient(host, int(port))
        if rank == 0:
            ps_client.create_sparse_table(0, table, shard_num=P, seed=0)
            say(f"GPUPS mode: CPU PS on {endpoint}")
        fl.barrier_worker()
        name, ps = "PSGPUTrainer", dict(ps_client=ps_client, ps_table_id=0)

    # every rank draws the same initial dense weights
    model = DeepFM(ModelSpec(num_slots=16, slot_dim=3 + D), hidden=(256, 128),
                   generator=torch.Generator().manual_seed(0))
    trainer = create_trainer(name, model, table, feed, tcfg, mesh=mesh,
                             seed=0, fleet=fl, device=mesh.device, **ps)
    trainer.metrics.init_metric("auc", "label", "pred", mask_var="mask",
                                mode_collect_in_device=args.device_auc)

    dss = []
    for _ in range(args.passes):
        ds = BoxDataset(feed, read_threads=2)
        ds.set_filelist(files)
        ds.set_filelist(ds.my_shard_files(rank, P))
        dss.append(ds)
    stats = run_preloaded_passes(trainer, dss)  # load N+1 || train N

    for i, s in enumerate(stats):
        say(f"pass {i}: loss={s['loss']:.4f} batches={s['batches']}")
    msg = trainer.metrics.get_metric_msg("auc",
                                         allreduce=fl.metric_allreduce())
    say("streaming AUC:", round(msg["auc"], 4), "size:", int(msg["size"]))
    out = {"passes": stats, "auc": msg, "world": P, "rank": rank}
    trainer.close()
    if ps_client is not None:
        fl.barrier_worker()
        if rank == 0:
            out["ps_rows"] = ps_client.sparse_size(0)
            say("rows on the PS:", out["ps_rows"])
            ps_client.stop_server()
        ps_client.close()
    fl.stop()
    return out


if __name__ == "__main__":
    main()
