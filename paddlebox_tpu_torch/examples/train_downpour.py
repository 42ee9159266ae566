"""Downpour CPU-PS training demo: the DistMultiTrainer/DownpourWorker path.

The port of examples/train_downpour.py. Workers pull sparse rows a batch
from a CPU parameter server into a per-batch slab on the card (read by the
gather_rows kernel), push merged gradients through a Communicator, and
refresh the dense parameters from the PS's dense table: the
downpour_worker.cc TrainFiles loop over the-one-ps tables.

    python -m paddlebox_tpu_torch.examples.train_downpour [--passes 4] \\
        [--tcp] [--async-comm]

--tcp brings up a PSServer on 127.0.0.1 and trains over the wire; the
default uses the in-process PsLocalClient.
"""

import argparse
import dataclasses
import os
import sys
import tempfile

if __package__ in (None, ""):   # run by path: the repository on sys.path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="train_downpour")
    ap.add_argument("--passes", type=int, default=4)
    ap.add_argument("--tcp", action="store_true",
                    help="train against a TCP PS server")
    ap.add_argument("--async-comm", action="store_true",
                    help="asynchronous Communicator sends (default sync)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the steps run (no CPU fallback)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the demo; returns the passes' stats, the eval AUC and the PS's
    row count."""
    args = parse_args(argv)
    import torch

    from paddlebox_tpu_torch.config.configs import (SparseOptimizerConfig,
                                                    TableConfig,
                                                    TrainerConfig)
    from paddlebox_tpu_torch.data import BoxDataset, write_synthetic_ctr_files
    from paddlebox_tpu_torch.device import resolve_device
    from paddlebox_tpu_torch.metrics.auc import BasicAucCalculator
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.models.base import ModelSpec
    from paddlebox_tpu_torch.ps import PSServer, PsLocalClient, TcpPSClient
    from paddlebox_tpu_torch.ps.worker import DownpourTrainer

    device = resolve_device(args.device)
    data_dir = tempfile.mkdtemp(prefix="pbx_downpour_")
    files, feed = write_synthetic_ctr_files(
        data_dir, num_files=2, lines_per_file=500, num_slots=8,
        vocab_per_slot=300, max_len=3, seed=13)
    feed = dataclasses.replace(feed, batch_size=64)

    D = 4
    table = TableConfig(embedx_dim=D, optimizer=SparseOptimizerConfig(
        mf_create_thresholds=0.0, mf_initial_range=1e-3,
        feature_learning_rate=0.2, mf_learning_rate=0.2))

    server = None
    if args.tcp:
        server = PSServer()
        client = TcpPSClient("127.0.0.1", server.port)
        print(f"TCP PS on 127.0.0.1:{server.port}")
    else:
        client = PsLocalClient()

    tr = DownpourTrainer(
        CtrDnn(ModelSpec(num_slots=8, slot_dim=3 + D), hidden=(32, 16),
               generator=torch.Generator().manual_seed(0)),
        table, feed, client, TrainerConfig(dense_lr=0.01),
        sync_comm=not args.async_comm, device=device)
    tr.metrics.init_metric("auc", "label", "pred", mask_var="mask")

    stats = []
    for i in range(args.passes):
        ds = BoxDataset(feed, read_threads=1)
        ds.set_filelist(files)
        stats.append(tr.train_pass(ds))
        print(f"pass {i}: loss={stats[-1]['loss']:.4f}")

    ds = BoxDataset(feed, read_threads=1)
    ds.set_filelist(files)
    preds, labels = tr.predict_pass(ds)
    calc = BasicAucCalculator(1 << 14)
    calc.add_data(preds, labels)
    calc.compute()
    rows = client.sparse_size(DownpourTrainer.SPARSE_TABLE)
    print(f"eval AUC: {calc.auc():.4f}  rows on PS: {rows}")
    tr.close()
    if server is not None:
        client.stop_server()
        client.close()
    return {"passes": stats, "eval_auc": calc.auc(), "ps_rows": rows}


if __name__ == "__main__":
    main()
