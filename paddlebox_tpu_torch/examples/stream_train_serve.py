"""Streaming continuous training on the micro-pass plane.

The port of examples/stream_train_serve.py. Default (demo) role, end to
end on one box: a feeder thread drops MultiSlot files into a watched
directory; a StreamingRunner tails them in bounded micro-passes on the
card (window N+1's ingest overlapped with window N's training),
publishing journal segments at every boundary; a serving view
(ViewManager + DeltaRefreshWatcher with a JournalDeltaSource) flips the
served vectors from those segments without waiting on SaveDelta. The
demo measures the ingest-to-serve freshness of a live drop.

    python -m paddlebox_tpu_torch.examples.stream_train_serve [--device cpu]

Deployment roles (the same modules, split across boxes):

    # upstream feed box: land synthetic drops on the shared source dir
    python -m paddlebox_tpu_torch.examples.stream_train_serve --role feed \\
        --source /path/stream/source --files 24 --interval 0.5
    # trainer box: tail the source, micro-checkpoint + journal under root
    python -m paddlebox_tpu_torch.examples.stream_train_serve --role train \\
        --source /path/stream/source --root /path/stream
    # serving box (N replica processes, journal-fed freshness):
    python -m paddlebox_tpu_torch.examples.stream_train_serve --role serve \\
        --root /path/stream --processes 2
    # any client box:
    python -m paddlebox_tpu_torch.examples.stream_train_serve --role client \\
        --endpoints host:port,host:port --keys 123,456
"""

import argparse
import os
import shutil
import sys
import threading
import time

if __package__ in (None, ""):   # run by path: the repository on sys.path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

NUM_SLOTS = 4
EMBEDX = 4
VOCAB = 400
BATCH = 64
LINES_PER_FILE = 300


def _make_data(staging, num_files, seed=7):
    from paddlebox_tpu_torch.data import write_synthetic_ctr_files
    files, feed = write_synthetic_ctr_files(
        staging, num_files=num_files, lines_per_file=LINES_PER_FILE,
        num_slots=NUM_SLOTS, vocab_per_slot=VOCAB, max_len=4, seed=seed)
    return files, type(feed)(slots=feed.slots, batch_size=BATCH)


def _make_trainer(feed, device):
    import torch

    from paddlebox_tpu_torch.config.configs import (SparseOptimizerConfig,
                                                    TableConfig,
                                                    TrainerConfig)
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.models.base import ModelSpec
    from paddlebox_tpu_torch.train import BoxTrainer
    table = TableConfig(
        embedx_dim=EMBEDX, pass_capacity=1 << 14,
        optimizer=SparseOptimizerConfig(mf_create_thresholds=0.0,
                                        mf_initial_range=1e-3))
    return BoxTrainer(
        CtrDnn(ModelSpec(num_slots=NUM_SLOTS, slot_dim=3 + EMBEDX),
               hidden=(32, 16), generator=torch.Generator().manual_seed(0)),
        table, feed, TrainerConfig(dense_lr=1e-3), seed=0, device=device)


def _make_cm(root, table):
    from paddlebox_tpu_torch.config.configs import CheckpointConfig
    from paddlebox_tpu_torch.train import CheckpointManager
    return CheckpointManager(
        CheckpointConfig(batch_model_dir=os.path.join(root, "batch"),
                         xbox_model_dir=os.path.join(root, "xbox"),
                         async_save=False),
        table)


def _drop(src, source_dir, index):
    """Land one file the way a well-behaved upstream does: write under a
    temp name, then rename into place (the convention the watcher trusts:
    a half-copied file is never ingested)."""
    dst = os.path.join(source_dir, "drop-%04d.txt" % index)
    shutil.copyfile(src, dst + ".tmp")
    os.replace(dst + ".tmp", dst)
    return dst


def role_feed(args) -> None:
    """Upstream stand-in: land synthetic drops on the source dir."""
    import tempfile
    staging = tempfile.mkdtemp(prefix="pbx_feed_")
    files, _ = _make_data(staging, args.files, seed=args.seed)
    os.makedirs(args.source, exist_ok=True)
    for i, f in enumerate(files):
        path = _drop(f, args.source, i + args.start_index)
        print(f"fed {os.path.basename(path)}", flush=True)
        time.sleep(args.interval)
    shutil.rmtree(staging, ignore_errors=True)
    print(f"feed done: {len(files)} files", flush=True)


def role_train(args) -> None:
    """Trainer box: tail the source dir in micro-passes forever (or
    until the stream is idle for --idle seconds)."""
    from paddlebox_tpu_torch.config.flags import StreamFlags
    from paddlebox_tpu_torch.data import StreamingDataset
    from paddlebox_tpu_torch.device import resolve_device
    from paddlebox_tpu_torch.train import StreamingRunner

    _, feed = _make_data(os.path.join(args.root, "_feedspec"), 1)
    trainer = _make_trainer(feed, resolve_device(args.device))
    cm = _make_cm(args.root, trainer.table)
    flags = StreamFlags(streaming_poll_secs=args.poll_secs)
    stream = StreamingDataset(
        feed, args.source, ledger_dir=os.path.join(args.root, "batch"),
        micro_pass_instances=args.window, flags=flags)
    runner = StreamingRunner(trainer, stream, cm=cm, flags=flags)
    print(f"tailing {args.source}; journal at {cm.journal.dir}", flush=True)
    # bootstrap a servable day the moment the first window lands, so the
    # serve role has a base composition to stack journal freshness onto
    runner.run(max_micro_passes=1, idle_timeout=args.idle)
    cm.save_delta("day0", 0)
    cm.wait()
    print(f"day0 published under {os.path.join(args.root, 'xbox')}",
          flush=True)
    try:
        res = runner.run(idle_timeout=args.idle)
        print(f"stream idle: {res['micro_passes']} micro-passes, "
              f"{res['examples_per_sec']:.0f} ex/s", flush=True)
    except KeyboardInterrupt:
        runner.stop()
        print("trainer draining", flush=True)
    trainer.close()


def role_serve(args) -> None:
    """Serving box: replicas over root/xbox, journal-fed freshness from
    the trainer's touched-row journal (torch never imports here)."""
    from paddlebox_tpu_torch.serving import ServingFleet
    jdir = os.path.join(args.root, "batch", "_journal", "rank0")
    with ServingFleet(os.path.join(args.root, "xbox"),
                      processes=args.processes,
                      flag_overrides={"serving_journal_dir": jdir}) as fleet:
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

    from paddlebox_tpu_torch.config.flags import HostFlags, StreamFlags
    from paddlebox_tpu_torch.data import StreamingDataset
    from paddlebox_tpu_torch.device import resolve_device
    from paddlebox_tpu_torch.serving.refresh import (DeltaRefreshWatcher,
                                                     JournalDeltaSource,
                                                     make_manager)
    from paddlebox_tpu_torch.serving.store import read_xbox_view
    from paddlebox_tpu_torch.train import StreamingRunner

    device = resolve_device(args.device)
    work = tempfile.mkdtemp(prefix="pbx_stream_")
    files, feed = _make_data(os.path.join(work, "staging"), 6)
    flags = StreamFlags(streaming_poll_secs=0.05)

    source = os.path.join(work, "source")
    trainer = _make_trainer(feed, device)
    cm = _make_cm(work, trainer.table)
    stream = StreamingDataset(
        feed, source, ledger_dir=os.path.join(work, "batch"),
        micro_pass_instances=2 * LINES_PER_FILE,
        dataset_kwargs={"flags": HostFlags(dataset_disable_shuffle=True)},
        flags=flags)
    runner = StreamingRunner(trainer, stream, cm=cm, base_every=4,
                             flags=flags)

    # ---- seed: first drop trains one micro-pass and lands the anchor
    for i in (0, 1):
        _drop(files[i], source, i)
    res = runner.run(max_micro_passes=1, idle_timeout=10.0)
    seed_res = res
    print(f"seed micro-pass: {res['instances']} instances, loss "
          f"{res['passes'][0]['loss']:.4f}", flush=True)
    xdir = cm.save_delta("day0", 0)
    cm.wait()

    # ---- serving tier over the day0 composition + journal overlay
    xroot = os.path.join(work, "xbox")
    manager, sources = make_manager(xroot)
    jsrc = JournalDeltaSource([cm.journal.dir])
    watcher = DeltaRefreshWatcher(manager, xroot, known_sources=sources,
                                  journal=jsrc, poll_secs=0.1).start()
    time.sleep(0.3)  # let the first poll stack the seed journal overlay
    keys = np.asarray(read_xbox_view(xdir)[0][:32], np.uint64)
    baseline, gen0 = manager.lookup(keys)
    print(f"serving view up: {keys.size} probe keys at gen {gen0}",
          flush=True)

    # ---- live leg: feeder drops while the runner micro-passes; a
    # detector thread timestamps the first served-vector change
    detected = {}
    seen = threading.Event()

    def _detect():
        while not seen.is_set():
            emb, gen = manager.lookup(keys)
            if not np.array_equal(emb, baseline):
                detected["ts"] = time.time()
                detected["gen"] = gen
                seen.set()
                return
            time.sleep(0.03)

    drop_ts = {}

    def _feed():
        time.sleep(0.2)
        for i in (2, 3, 4, 5):
            _drop(files[i], source, i)
            drop_ts[i] = time.time()
            time.sleep(0.25)

    det = threading.Thread(target=_detect, daemon=True)
    fed = threading.Thread(target=_feed, daemon=True)
    det.start()
    fed.start()
    res = runner.run(max_micro_passes=2, idle_timeout=8.0)
    fed.join()
    det.join(timeout=10.0)
    seen.set()
    if "ts" not in detected:
        raise AssertionError("served vectors did not flip from the journal "
                             "overlay within 10s")
    freshness = detected["ts"] - drop_ts[2]
    print(f"live leg: {res['micro_passes']} micro-passes, "
          f"{res['instances']} instances, "
          f"{res['examples_per_sec']:.0f} ex/s, max ingest wait "
          f"{res['max_ingest_wait_secs']:.2f}s", flush=True)
    print(f"ingest-to-serve freshness: {freshness:.2f}s "
          f"(drop -> served gen {detected['gen']}, no SaveDelta in "
          f"between)", flush=True)

    watcher.stop()
    jsrc.close()
    manager.close()
    trainer.close()
    shutil.rmtree(work, ignore_errors=True)
    return {"seed": seed_res, "live": res, "freshness_s": freshness,
            "served_gen": detected["gen"]}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="stream_train_serve")
    ap.add_argument("--role",
                    choices=("demo", "feed", "train", "serve", "client"),
                    default="demo")
    ap.add_argument("--source", help="watched source dir (feed/train)")
    ap.add_argument("--root", help="model root: batch/ xbox/ land here "
                                   "(train/serve)")
    ap.add_argument("--files", type=int, default=24,
                    help="files to feed (feed role)")
    ap.add_argument("--interval", type=float, default=0.5,
                    help="seconds between fed files")
    ap.add_argument("--start-index", type=int, default=0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--window", type=int, default=2 * LINES_PER_FILE,
                    help="micro-pass instance bound (train role)")
    ap.add_argument("--poll-secs", type=float, default=0.2)
    ap.add_argument("--idle", type=float, default=30.0,
                    help="stop after this many idle seconds (train role)")
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--endpoints", default="",
                    help="host:port,host:port (client role)")
    ap.add_argument("--keys", default="1,2,3")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the demo and train roles train (no CPU "
                         "fallback)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    roles = {"feed": role_feed, "train": role_train, "serve": role_serve,
             "client": role_client}
    return roles.get(args.role, role_demo)(args)


if __name__ == "__main__":
    main()
