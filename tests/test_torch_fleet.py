"""The port's host plane (paddlebox_tpu_torch/fleet/, parallel/mesh.py)
against the reference's contracts (paddlebox_tpu/fleet/fleet.py:42-186,
mesh_comm.py:408-488, role_maker.py, launch.py).

A two-rank gloo cluster, spawned by the test (each rank one thread, a
process group timeout and a wall limit here): all_gather of arrays of
unequal length, dtype and shape in rank order; all_reduce sum, max and
min; the barrier; equalize_batches; metric_allreduce; MeshComm.exchange
with uneven, empty and 2-D parts, held to numpy; make_mesh_comm's and
validate_policy_agreement's policy checks. The role maker reads the reference's environment names, and the
launcher runs a fleet cluster and returns a failing rank's exit code with
the other rank stopped.
"""

import os
import pickle
import time
import traceback

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch.fleet import launch as launch_mod
from paddlebox_tpu_torch.fleet.fleet import Fleet
from paddlebox_tpu_torch.fleet.mesh_comm import MeshPolicyMismatch
from paddlebox_tpu_torch.fleet.role_maker import RoleMaker
from paddlebox_tpu_torch.parallel.mesh import connect_store, init_distributed
from paddlebox_tpu_torch.parallel.sharding import (KeyModPolicy,
                                                   validate_policy_agreement)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 30.0
CLUSTER_WALL_S = 90.0


def gather_part(rank):
    """Rank r's all_gather input: r * 3 + 1 int32s (unequal lengths)."""
    return np.arange(rank * 3 + 1, dtype=np.int32) * (rank + 1)


def exchange_part(src, dst):
    """What rank src sends rank dst: uneven lengths, one empty pair, one
    2-D float part."""
    if (src, dst) == (1, 0):
        return np.empty(0, np.int32)
    if (src, dst) == (0, 1):
        return np.arange(6, dtype=np.float64).reshape(2, 3) + 0.5
    return np.arange(src * 10 + dst * 3 + 2, dtype=np.int32) + 100 * src


def _rank_main(rank, world, port, out_dir):
    torch.set_num_threads(1)
    path = os.path.join(out_dir, "rank%d" % rank)
    try:
        fl = Fleet().init(RoleMaker(rank, world, "127.0.0.1:%d" % port))
        mesh = fl.init_distributed(GROUP_TIMEOUT_S, device="cpu")
        out = {"world": mesh.world, "rank": mesh.rank,
               "backend": mesh.backend}
        out["gather"] = fl.all_gather(gather_part(rank))
        out["gather2d"] = fl.all_gather(np.full((rank + 1, 2), rank,
                                                np.float32))
        vec = np.array([rank + 1, 10 - 3 * rank, rank * 2], np.int64)
        out["reduce"] = {op: fl.all_reduce(vec, op)
                         for op in ("sum", "max", "min")}
        fl.barrier_worker()
        out["equalize"] = fl.equalize_batches()(5 + 2 * rank)
        out["metric"] = fl.metric_allreduce()(np.array([0.25, rank]))
        comm = fl.make_mesh_comm([rank], policy_id="key-mod/2")
        assert fl.make_mesh_comm([rank], policy_id="key-mod/2") is comm
        got = comm.exchange({d: exchange_part(rank, d)
                             for d in range(world)})
        out["exchange"] = got
        out["exchange2"] = comm.exchange({d: exchange_part(d, rank)
                                          for d in range(world)})
        out["stats"] = comm.stats()
        out["positions"] = comm.rank_of_position()
        other = Fleet().init(RoleMaker(rank, world))
        other.mesh = mesh
        try:
            other.make_mesh_comm([rank], policy_id="key-mod/%d" % rank)
            out["mismatch"] = None
        except MeshPolicyMismatch as e:
            out["mismatch"] = str(e)
        # the store plane's check: one all_gather of describe()
        validate_policy_agreement(fl, KeyModPolicy(2))
        try:
            validate_policy_agreement(fl, KeyModPolicy(2 + rank))
            out["policy_mismatch"] = None
        except MeshPolicyMismatch as e:
            out["policy_mismatch"] = str(e)
        fl.stop()
        out["stopped"] = not torch.distributed.is_initialized()
        with open(path + ".pkl", "wb") as fh:
            pickle.dump(out, fh)
    except BaseException:
        with open(path + ".err", "w") as fh:
            fh.write(traceback.format_exc())
        raise


def run_two_ranks(tmp_path):
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
    deadline = time.monotonic() + CLUSTER_WALL_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = {r: open(tmp_path / ("rank%d.err" % r)).read()
            for r in range(2) if (tmp_path / ("rank%d.err" % r)).exists()}
    assert not hung and not errs and all(p.exitcode == 0 for p in procs), (
        hung, errs, [p.exitcode for p in procs])
    return [pickle.load(open(tmp_path / ("rank%d.pkl" % r), "rb"))
            for r in range(2)]


def test_host_collectives_and_exchange_two_ranks(tmp_path):
    got = run_two_ranks(tmp_path)
    for r, out in enumerate(got):
        assert (out["world"], out["rank"], out["backend"]) == (2, r, "gloo")
        assert len(out["gather"]) == 2
        for src, part in enumerate(out["gather"]):
            np.testing.assert_array_equal(part, gather_part(src))
            assert part.dtype == np.int32
        for src, part in enumerate(out["gather2d"]):
            np.testing.assert_array_equal(
                part, np.full((src + 1, 2), src, np.float32))
        vecs = np.array([[1, 10, 0], [2, 7, 2]], np.int64)
        np.testing.assert_array_equal(out["reduce"]["sum"], vecs.sum(0))
        np.testing.assert_array_equal(out["reduce"]["max"], vecs.max(0))
        np.testing.assert_array_equal(out["reduce"]["min"], vecs.min(0))
        assert out["equalize"] == 7
        np.testing.assert_array_equal(out["metric"], [0.5, 1.0])
        for src in range(2):
            want = exchange_part(src, r)
            part = out["exchange"][src]
            assert part.dtype == want.dtype and part.shape == want.shape
            np.testing.assert_array_equal(part, want)
            np.testing.assert_array_equal(out["exchange2"][src],
                                          exchange_part(r, src))
        peer = 1 - r
        assert out["stats"]["exchanges"] == 2
        assert out["stats"]["bytes_sent"] == (
            exchange_part(r, peer).nbytes + exchange_part(peer, r).nbytes)
        assert out["positions"] == {0: 0, 1: 1}
        assert out["mismatch"] is not None and "key-mod/0" in out[
            "mismatch"] and "key-mod/1" in out["mismatch"]
        assert "key-mod/2" in out["policy_mismatch"] and "key-mod/3" in out[
            "policy_mismatch"]
        assert out["stopped"]


def test_role_maker_reads_the_reference_env_names(monkeypatch):
    for k in list(os.environ):
        if k.startswith(("PBTPU_TRAINER", "PADDLE_TRAINER", "PBTPU_STORE",
                         "PADDLE_GLOO")):
            monkeypatch.delenv(k)
    r = RoleMaker()
    assert (r.rank, r.world, r.store_endpoint) == (0, 1, None)
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "3")
    monkeypatch.setenv("PADDLE_GLOO_HTTP_ENDPOINT", "10.0.0.1:4000")
    r = RoleMaker()
    assert (r.rank, r.world, r.store_addr()) == (1, 3, ("10.0.0.1", 4000))
    assert not r.is_first_worker()
    monkeypatch.setenv("PBTPU_TRAINER_ID", "2")
    monkeypatch.setenv("PBTPU_TRAINERS_NUM", "4")
    monkeypatch.setenv("PBTPU_STORE_ENDPOINT", "127.0.0.1:5000")
    r = RoleMaker()
    assert (r.rank, r.world, r.store_addr()) == (2, 4, ("127.0.0.1", 5000))
    assert RoleMaker(rank=0, world=2).is_first_worker()
    with pytest.raises(ValueError, match="outside world"):
        RoleMaker(rank=4, world=4)
    # a world of two needs its rendezvous; a world of one runs in process
    monkeypatch.delenv("PBTPU_STORE_ENDPOINT")
    monkeypatch.delenv("PADDLE_GLOO_HTTP_ENDPOINT")
    with pytest.raises(ValueError, match="store endpoint"):
        RoleMaker(rank=0, world=2).store_addr()
    with pytest.raises(ValueError, match="rendezvous store"):
        connect_store(RoleMaker(rank=0, world=2))


def test_world_one_in_process_and_no_cpu_fallback(monkeypatch):
    fl = Fleet().init(RoleMaker(0, 1))
    with pytest.raises(RuntimeError, match="init_distributed"):
        fl.all_gather(np.zeros(1))
    mesh = fl.init_distributed(GROUP_TIMEOUT_S, device="cpu")
    try:
        assert (mesh.world, mesh.rank, mesh.backend) == (1, 0, "gloo")
        parts = fl.all_gather(np.array([3, 4], np.int16))
        assert len(parts) == 1 and parts[0].dtype == np.int16
        np.testing.assert_array_equal(fl.all_reduce([2.5], "max"), [2.5])
        assert fl.equalize_batches()(9) == 9
        with pytest.raises(ValueError, match="allreduce op"):
            fl.all_reduce([1], "mean")
        with pytest.raises(RuntimeError, match="already initialized"):
            init_distributed("cpu", 0, 1)
        comm = fl.make_mesh_comm([0])
        got = comm.exchange({0: np.arange(5, dtype=np.uint64)})
        np.testing.assert_array_equal(got[0], np.arange(5, dtype=np.uint64))
        with pytest.raises(ValueError, match="one part per rank"):
            comm.exchange({1: np.zeros(1)})
    finally:
        fl.stop()
    assert not torch.distributed.is_initialized()
    # the card unless the caller asks for the CPU: no GPU, no fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed(None, 0, 1)
    assert not torch.distributed.is_initialized()


SCRIPT_OK = """
import os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
from paddlebox_tpu_torch.fleet.fleet import fleet
fleet.init()
fleet.init_distributed(30, device="cpu")
total = fleet.all_reduce(np.array([fleet.worker_index() + 1]), "sum")
with open(os.path.join({out!r}, "r%d" % fleet.worker_index()), "w") as fh:
    fh.write("%d %d %s" % (fleet.worker_num(), int(total[0]),
                           os.environ["PBTPU_RUN_ID"]))
fleet.stop()
"""

SCRIPT_FAIL = """
import os, sys, time
rank = int(os.environ["PBTPU_TRAINER_ID"])
path = os.path.join({out!r}, "pid%d" % rank)
with open(path + ".tmp", "w") as fh:
    fh.write(str(os.getpid()))
os.replace(path + ".tmp", path)
if rank == 1:
    # fail once rank 0 has written its pid (the test reads it)
    t0 = time.monotonic()
    while not os.path.exists(os.path.join({out!r}, "pid0")) \
            and time.monotonic() - t0 < 30:
        time.sleep(0.01)
    sys.exit(3)
time.sleep(120)
"""


def test_launch_runs_a_fleet_cluster(tmp_path):
    script = tmp_path / "ok.py"
    script.write_text(SCRIPT_OK.format(repo=REPO, out=str(tmp_path)))
    assert launch_mod.launch(2, [str(script)]) == 0
    got = [(tmp_path / ("r%d" % r)).read_text().split() for r in range(2)]
    assert [g[:2] for g in got] == [["2", "3"], ["2", "3"]]
    assert got[0][2] == got[1][2]     # one run id for the cluster


def test_launch_returns_a_failing_ranks_code(tmp_path):
    script = tmp_path / "fail.py"
    script.write_text(SCRIPT_FAIL.format(out=str(tmp_path)))
    t0 = time.monotonic()
    assert launch_mod.main(["--nproc", "2", str(script)]) == 3
    assert time.monotonic() - t0 < 60
    pid0 = int((tmp_path / "pid0").read_text())
    # the launcher stopped and reaped the rank still running
    with pytest.raises(ProcessLookupError):
        os.kill(pid0, 0)
