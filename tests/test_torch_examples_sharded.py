"""paddlebox_tpu_torch/examples/train_sharded.py at world 2 over gloo,
through the port's launcher (tests/examples_cluster.py): two ranks, each
loading its half of the files, print the reference demo's lines once,
from rank 0 (tests/test_examples.py asserts "streaming AUC" of the
reference's); the --gpups variant over rank 0's TCP PS, on a 2-D (node,
chip) mesh with the bf16 all-to-all and the device-side AUC."""

import re

from examples_cluster import run_demo


def test_train_sharded_runs_at_world_2():
    out = run_demo("train_sharded.py", "--passes", "2", nproc=2)
    assert "devices: 2 × cpu (gloo)" in out
    assert out.count("streaming AUC") == 1
    assert re.search(r"pass 1: loss=\d\.\d{4} batches=\d+", out), out
    # the world's AUC covers both ranks' 4,000 instances a pass
    assert "size: 8000" in out


def test_train_sharded_gpups_2d_mesh_at_world_2():
    out = run_demo("train_sharded.py", "--passes", "1", "--gpups",
                   "--mesh-2d", "2", "--a2a-dtype", "bfloat16",
                   "--device-auc", nproc=2)
    assert "GPUPS mode: CPU PS on 127.0.0.1:" in out
    assert "streaming AUC" in out
    rows = int(re.search(r"rows on the PS: (\d+)", out).group(1))
    assert rows > 0
