"""Serving handoff demo on the serving plane.

The port of examples/serve_xbox.py. Default (demo) role, end to end on one
box: train day0 on the card (run_day: cadenced delta saves and the base
save), bring up a ServingServer over the day's xbox output (the mmap view
stack, the hot-key cache, the delta-refresh watcher), pull embeddings
through the plain-container RPC client, check bit-parity against the
XboxModelReader oracle, then land a MID-DAY day1 SaveDelta and watch the
served vectors refresh within one poll interval.

    python -m paddlebox_tpu_torch.examples.serve_xbox [--device cpu]

Deployment roles (the same modules, split across boxes; neither loads
torch, and neither needs the card):

    # loader/serving box (N replica processes):
    python -m paddlebox_tpu_torch.examples.serve_xbox --role server \\
        --root /path/xbox --days day0,day1 --processes 2
    # any client box:
    python -m paddlebox_tpu_torch.examples.serve_xbox --role client \\
        --endpoints host:port,host:port --keys 123,456
"""

import argparse
import os
import sys
import time

if __package__ in (None, ""):   # run by path: the repository on sys.path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))


def role_server(args) -> None:
    """The serving fleet on the store root (torch never imports here)."""
    from paddlebox_tpu_torch.serving import ServingFleet
    days = args.days.split(",") if args.days else None
    with ServingFleet(args.root, days=days,
                      processes=args.processes) as fleet:
        print("serving fleet up:", fleet.endpoints, flush=True)
        try:
            while True:
                time.sleep(60)
        except KeyboardInterrupt:
            print("draining fleet")


def role_client(args) -> dict:
    import numpy as np

    from paddlebox_tpu_torch.serving import ServingClient
    eps = [(h, int(p)) for h, p in
           (e.split(":") for e in args.endpoints.split(","))]
    client = ServingClient(eps)
    keys = np.array([int(k) for k in args.keys.split(",")], np.uint64)
    emb = client.pull(keys)
    print(f"serving gen {client.last_gen}")
    for k, row in zip(keys.tolist(), emb):
        print(f"  feasign {k}: embed_w={row[0]:+.4f} "
              f"embedx={np.round(row[1:4], 4)}...")
    client.close()
    return {"keys": keys, "rows": emb}


def role_demo(args) -> dict:
    import tempfile

    import numpy as np
    import torch

    from paddlebox_tpu_torch.config.configs import (CheckpointConfig,
                                                    SparseOptimizerConfig,
                                                    TableConfig,
                                                    TrainerConfig)
    from paddlebox_tpu_torch.config.flags import ServingFlags
    from paddlebox_tpu_torch.data import BoxDataset, write_synthetic_ctr_files
    from paddlebox_tpu_torch.device import resolve_device
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.models.base import ModelSpec
    from paddlebox_tpu_torch.serving import ServingClient, ServingServer
    from paddlebox_tpu_torch.serving.store import read_xbox_view
    from paddlebox_tpu_torch.train import BoxTrainer, CheckpointManager
    from paddlebox_tpu_torch.train.checkpoint import XboxModelReader, run_day

    device = resolve_device(args.device)
    work = tempfile.mkdtemp(prefix="pbx_serve_")
    files, feed = write_synthetic_ctr_files(
        os.path.join(work, "data"), num_files=2, lines_per_file=800,
        num_slots=8, vocab_per_slot=400, max_len=4, seed=9)
    feed = type(feed)(slots=feed.slots, batch_size=128)

    D = 8
    table = TableConfig(
        embedx_dim=D, pass_capacity=1 << 15,
        optimizer=SparseOptimizerConfig(mf_create_thresholds=0.0,
                                        mf_initial_range=1e-3))
    trainer = BoxTrainer(
        CtrDnn(ModelSpec(num_slots=8, slot_dim=3 + D), hidden=(64, 32),
               generator=torch.Generator().manual_seed(0)),
        table, feed, TrainerConfig(dense_lr=1e-3), seed=0, device=device)
    cm = CheckpointManager(
        CheckpointConfig(batch_model_dir=os.path.join(work, "batch"),
                         xbox_model_dir=os.path.join(work, "xbox"),
                         async_save=False, save_delta_every_passes=1),
        trainer.table)
    dss = []
    for _ in range(args.passes):
        ds = BoxDataset(feed, read_threads=2)
        ds.set_filelist(files)
        dss.append(ds)
    stats, (batch_dir, xbox_dir) = run_day(trainer, dss, cm, day="day0")
    print(f"trained day0: {len(stats)} passes, final loss "
          f"{stats[-1]['loss']:.4f}")

    xbox_root = os.path.dirname(xbox_dir)
    reader = XboxModelReader(xbox_root, "day0")
    print(f"serving view: {len(reader)} features x {reader.dim} cols "
          f"({reader.deltas_applied} deltas composed)")

    # ---- serving tier: mmap view stack + cache + RPC behind one server;
    # days auto-discover each poll, so day1's deltas join the composition
    # the moment their DONE markers land
    server = ServingServer(xbox_root, flags=ServingFlags(
        serving_refresh_secs=0.2,
        serving_report_requests=2))   # demo-size obs cadence
    client = ServingClient([("127.0.0.1", server.port)])
    keys = np.asarray(read_xbox_view(xbox_dir)[0][:64], np.uint64)
    t0 = time.perf_counter()
    emb = client.pull(keys)
    dt = time.perf_counter() - t0
    if not np.array_equal(emb, reader.lookup(keys)):
        raise AssertionError("served vectors must be bit-identical to the "
                             "XboxModelReader oracle")
    print(f"pull RPC: {keys.size} keys in {dt * 1e3:.2f} ms "
          f"(gen {client.last_gen}), oracle parity OK")
    for k, row in zip(keys[:3].tolist(), emb):
        print(f"  feasign {k}: embed_w={row[0]:+.4f} "
              f"embedx={np.round(row[1:4], 4)}...")

    # ---- mid-day refresh: land a day1 SaveDelta while serving
    ds = BoxDataset(feed, read_threads=2)
    ds.set_filelist(files[:1])
    trainer.train_pass(ds)
    ds.release_memory()
    cm.save_delta("day1", 1)
    cm.wait()
    oracle2 = XboxModelReader(xbox_root, "day0", "day1")
    deadline = time.time() + 10.0
    while time.time() < deadline:
        emb2 = client.pull(keys)
        if np.array_equal(emb2, oracle2.lookup(keys)):
            break
        time.sleep(0.05)
    else:
        raise AssertionError("day1 delta not served within 10s")
    changed = int((emb2 != emb).any(axis=1).sum())
    print(f"delta refresh: day1 SaveDelta visible in served vectors "
          f"(gen {client.last_gen}, {changed}/{keys.size} keys changed), "
          f"oracle parity OK")
    st = client.stats()
    rep = st["last_report"] or {}
    hists = rep.get("hists", {}).get("serving_lookup_us", {})
    print(f"obs: {st['requests']} pulls, cache {st['cache_hit']} hit / "
          f"{st['cache_miss']} miss, lookup p50={hists.get('p50')}us "
          f"p99={hists.get('p99')}us")
    client.close()
    server.drain()
    trainer.close()
    return {"passes": stats, "features": len(reader), "changed": changed,
            "keys": int(keys.size), "gen": client.last_gen}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="serve_xbox")
    ap.add_argument("--role", choices=("demo", "server", "client"),
                    default="demo")
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--root", help="xbox model root (server role)")
    ap.add_argument("--days", default="",
                    help="comma-separated day dirs in cadence order "
                         "(default: auto-discover)")
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--endpoints", default="",
                    help="host:port,host:port (client role)")
    ap.add_argument("--keys", default="1,2,3")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the demo role trains (no CPU fallback)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.role == "server":
        return role_server(args)
    if args.role == "client":
        return role_client(args)
    return role_demo(args)


if __name__ == "__main__":
    main()
