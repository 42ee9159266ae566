"""Running the port's rank demos (paddlebox_tpu_torch/examples/
train_sharded.py, train_pipeline.py, train_mesh_tower.py) as their users
do: through the port's launcher (python -m paddlebox_tpu_torch.fleet.launch
--nproc P, which hosts the rendezvous TCPStore on an ephemeral port), on
the CPU over gloo. Every run has a wall limit, and the demos' process
groups a timeout, so a rank that hangs fails the test instead of the
suite."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "paddlebox_tpu_torch", "examples")
# the demos' process-group timeout and the launcher's wall limit, seconds
GROUP_TIMEOUT_S = 60
WALL_S = 240


def run_demo(script, *args, nproc=None, wall=WALL_S):
    """stdout of ``script`` with ``args`` and --device cpu: by path under
    the launcher with ``nproc`` ranks, or alone (nproc None, a world of
    one). Fails on a nonzero exit or past ``wall`` seconds."""
    cmd = [os.path.join(EXAMPLES, script), *args, "--device", "cpu"]
    if script in ("train_sharded.py", "train_pipeline.py",
                  "train_mesh_tower.py"):
        cmd += ["--timeout", str(GROUP_TIMEOUT_S)]
    if nproc is not None:
        cmd = ["-m", "paddlebox_tpu_torch.fleet.launch", "--nproc",
               str(nproc)] + cmd
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("PBTPU_STORE_ENDPOINT", None)
    r = subprocess.run([sys.executable] + cmd, capture_output=True,
                       text=True, timeout=wall, env=env, cwd=REPO)
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    return r.stdout
