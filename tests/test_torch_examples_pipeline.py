"""paddlebox_tpu_torch/examples/train_pipeline.py at 2 stages over gloo,
through the port's launcher (tests/examples_cluster.py): the replicated
table (HeterPipelineTrainer) and --sharded-slab
(ShardedCtrPipelineTrainer), whose "features trained" line sums the two
shards' keys over the group; the reference demo's lines
(tests/test_examples.py asserts "features trained" and "shards")."""

import re

import pytest

from examples_cluster import run_demo


@pytest.mark.parametrize("sharded", [False, True],
                         ids=["replicated", "sharded_slab"])
def test_train_pipeline_runs_at_2_stages(sharded):
    args = ["--passes", "2"] + (["--sharded-slab"] if sharded else [])
    out = run_demo("train_pipeline.py", *args, nproc=2)
    assert "pipeline: 2 stages × cpu" in out
    assert re.search(r"pass 1: loss=\d\.\d{4} steps=\d+ \(dropped \d+ tail "
                     r"batches\)", out), out
    n = int(re.search(r"features trained:? (\d+)", out).group(1))
    # the demo's 4 files hold 8 slots x 500 ids; each appears
    assert n == 4000
    if sharded:
        assert "across 2 shards (shard slab 16384 rows)" in out


def test_train_pipeline_refuses_stages_other_than_the_world():
    with pytest.raises(AssertionError, match="a stage is a rank"):
        run_demo("train_pipeline.py", "--passes", "1", "--stages", "2")
