"""Fleet's collectives under the reference's ``timeout`` argument
(paddlebox_tpu/fleet/fleet.py:98-157, 263-264): barrier_worker,
all_gather, all_reduce and make_mesh_comm take it at the reference's
position and give the same results with it; a barrier that the other
rank reaches only after the timeout raises on the rank that waited, near
the timeout and long before the group's own.

A two-rank gloo cluster spawned by the test, each rank one thread, with
a group timeout and a wall limit here.
"""

import os
import pickle
import time
import traceback

import numpy as np
import torch

from paddlebox_tpu_torch.fleet.fleet import Fleet
from paddlebox_tpu_torch.fleet.role_maker import RoleMaker

GROUP_TIMEOUT_S = 60.0
CALL_TIMEOUT_S = 20.0
SHORT_TIMEOUT_S = 1.0
LATE_S = 6.0
CLUSTER_WALL_S = 90.0


def _rank_main(rank, world, port, out_dir):
    torch.set_num_threads(1)
    path = os.path.join(out_dir, "rank%d" % rank)
    try:
        fl = Fleet().init(RoleMaker(rank, world, "127.0.0.1:%d" % port))
        fl.init_distributed(GROUP_TIMEOUT_S, device="cpu")
        out = {}
        fl.barrier_worker(CALL_TIMEOUT_S)
        out["gather"] = fl.all_gather(np.arange(rank + 2, dtype=np.int64),
                                      CALL_TIMEOUT_S)
        out["reduce"] = fl.all_reduce(np.array([rank, 5 - rank]), "max",
                                      CALL_TIMEOUT_S)
        comm = fl.make_mesh_comm([rank], CALL_TIMEOUT_S, "key-mod/2")
        out["positions"] = comm.rank_of_position()
        fl.barrier_worker(timeout=CALL_TIMEOUT_S)
        t0 = time.monotonic()
        if rank == 0:
            try:
                fl.barrier_worker(timeout=SHORT_TIMEOUT_S)
                out["late"] = None
            except RuntimeError as e:
                out["late"] = str(e)
        else:
            time.sleep(LATE_S)
            out["late"] = "arrived late"
        out["late_s"] = time.monotonic() - t0
        with open(path + ".pkl", "wb") as fh:
            pickle.dump(out, fh)
    except BaseException:
        with open(path + ".err", "w") as fh:
            fh.write(traceback.format_exc())
    # the late barrier leaves the group mid-collective: no teardown
    os._exit(0)


def test_collectives_take_the_references_timeout(tmp_path):
    import torch.distributed as dist
    import torch.multiprocessing as tmp
    store = dist.TCPStore("127.0.0.1", 0, None, is_master=True,
                          wait_for_workers=False)
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, 2, store.port, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.time() + CLUSTER_WALL_S
    for p in procs:
        p.join(max(1.0, deadline - time.time()))
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = {r: open(tmp_path / ("rank%d.err" % r)).read()
              for r in range(2) if (tmp_path / ("rank%d.err" % r)).exists()}
    assert not hung and not errors, (hung, errors)
    outs = [pickle.load(open(tmp_path / ("rank%d.pkl" % r), "rb"))
            for r in range(2)]
    for out in outs:
        assert [g.tolist() for g in out["gather"]] == [[0, 1], [0, 1, 2]]
        assert out["reduce"].tolist() == [1, 5]
        assert out["positions"] == {0: 0, 1: 1}
    assert outs[0]["late"] is not None and "arrived" not in outs[0]["late"]
    assert SHORT_TIMEOUT_S * 0.9 <= outs[0]["late_s"] < LATE_S
