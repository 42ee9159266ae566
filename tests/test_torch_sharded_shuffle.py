"""The sharded trainer over a cross-host shuffled load, in a gloo cluster
of 2 (tests/sharded_cluster.py's harness: spawned ranks of one thread, a
group timeout, a wall limit, no fixed port).

Each rank builds its shuffle with Fleet.make_shuffler (a TcpShuffler,
its endpoints exchanged by all_gather) and loads its files through
BoxDataset(shuffler=...) inside train_pass: each rank trains the hash
partition of every rank's files (block_shuffle_dests), and the port's
merge order (this rank's records, then the received frames by source
rank and send order) makes the pass the same from run to run, so two
runs of two passes are bit-identical: losses, AUC, the shard's store,
the dense parameters. The frame bytes each rank sent are the bytes its
peer received.
"""

import numpy as np
import pytest

from paddlebox_tpu_torch.data import block_shuffle as bs
from paddlebox_tpu_torch.data.dataset import BoxDataset
from sharded_cluster import assert_same_run, run_cluster, write_data

P = 2


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_data(tmp_path_factory.mktemp("torch_sharded_shuffle"))


def test_shuffled_passes_repeat_bit_for_bit(data, tmp_path):
    files, pfeed = data
    seeds = [int(x) for x in np.random.RandomState(4).randint(
        0, 2**31 - 1, 256)]
    runs = [{"shuffle": True}, {"shuffle": True}, {}]
    spec = {"feed": pfeed, "files": files, "params0": {"deepfm": None},
            "runs": runs, "seeds": {"deepfm": [seeds] * P}}
    got = run_cluster(P, spec, tmp_path)
    # every rank's partition: the hash partition of all the files
    whole = BoxDataset(pfeed)
    whole.set_filelist(files)
    whole.load_into_memory()
    dests = bs.block_shuffle_dests(whole.block, P)
    for r, ranks in enumerate(got):
        a, b, plain = ranks
        assert a["shuffler"] == b["shuffler"] == "TcpShuffler"
        assert_same_run(a, b)
        assert a["instances"] == [int((dests == r).sum())] * 2
        # the unshuffled run trains this rank's own files
        assert plain["instances"] == [len(files) // P * 128] * 2
        assert a["passes"] != plain["passes"]
    for run in (0, 1):
        sent = [got[r][run]["shuffle_bytes"][0] for r in range(P)]
        recv = [got[r][run]["shuffle_bytes"][1] for r in range(P)]
        assert sent == recv[::-1] and min(sent) > 0
    # the ranks' losses agree (the dense step is replicated)
    assert [p[0] for p in got[0][0]["passes"]] == [
        p[0] for p in got[1][0]["passes"]]
