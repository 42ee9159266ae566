"""Multi-process launcher: one process a GPU.

Counterpart of paddlebox_tpu/fleet/launch.py:24-67 (`python -m
paddle.distributed.launch`): spawns ``nproc`` worker processes with the
role's environment set (PBTPU_TRAINER_ID, PBTPU_TRAINERS_NUM,
PBTPU_STORE_ENDPOINT, PBTPU_RUN_ID), hosts the rendezvous store (a
torch.distributed TCPStore on an ephemeral port of 127.0.0.1) in the
launcher, and returns the first nonzero exit code. When a worker fails,
the others are stopped (they would wait in a collective until its
timeout), so no process it started outlives the call.

    python -m paddlebox_tpu_torch.fleet.launch --nproc 2 train.py --epochs 3
"""

from __future__ import annotations

import argparse
import datetime
import os
import subprocess
import sys
import time
import uuid
from typing import Dict, List, Optional

import torch.distributed as dist

# seconds between polls of the workers, and a stopped worker's grace
POLL_S = 0.1
KILL_GRACE_S = 10.0


def launch(nproc: int, cmd: List[str],
           env_extra: Optional[Dict[str, str]] = None) -> int:
    """Run ``[python] + cmd`` as ranks 0..nproc-1; returns 0, or the exit
    code of the first worker that failed (the others stopped)."""
    store = dist.TCPStore("127.0.0.1", 0, None, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=60))
    run_id = uuid.uuid4().hex[:12]
    procs: List[subprocess.Popen] = []
    try:
        for rank in range(nproc):
            env = dict(os.environ)
            env.update({
                "PBTPU_TRAINER_ID": str(rank),
                "PBTPU_TRAINERS_NUM": str(nproc),
                "PBTPU_STORE_ENDPOINT": "127.0.0.1:%d" % store.port,
                "PBTPU_RUN_ID": run_id,
            })
            if env_extra:
                env.update(env_extra)
            procs.append(subprocess.Popen([sys.executable] + cmd, env=env))
        while True:
            rcs = [p.poll() for p in procs]
            failed = [rc for rc in rcs if rc]
            if failed:
                return failed[0]
            if all(rc == 0 for rc in rcs):
                return 0
            time.sleep(POLL_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + KILL_GRACE_S
        for p in procs:
            try:
                p.wait(max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        del store


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="paddlebox_tpu_torch.fleet.launch")
    ap.add_argument("--nproc", type=int, default=1,
                    help="worker processes to spawn (one a GPU)")
    ap.add_argument("script", help="training script")
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    return launch(args.nproc, [args.script] + args.script_args)


if __name__ == "__main__":
    sys.exit(main())
