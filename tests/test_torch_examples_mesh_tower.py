"""paddlebox_tpu_torch/examples/train_mesh_tower.py over an mp group of 2
gloo ranks, through the port's launcher (tests/examples_cluster.py): the
TP DeepFM's wide layer split in two, and the EP MMoE's experts; the
reference demo's lines (tests/test_examples.py asserts "features
trained")."""

import re

import pytest

from examples_cluster import run_demo


@pytest.mark.parametrize("kind", ["tp", "ep"])
def test_train_mesh_tower_runs_at_mp_2(kind):
    out = run_demo("train_mesh_tower.py", "--kind", kind, "--passes", "2",
                   "--wide", "256", nproc=2)
    head = ("TP DeepFM: 256-wide layer split over 2 ranks (128 columns "
            "each)" if kind == "tp" else "EP MMoE: 4 experts over 2 ranks")
    assert head in out
    assert re.search(r"pass 1: loss=\d\.\d{4} batches=25", out), out
    assert "features trained: 4000" in out
