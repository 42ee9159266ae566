"""The port's single-process demos (paddlebox_tpu_torch/examples/) run in
process with --device cpu and print their reference demos' lines
(tests/test_examples.py: "loss", "eval AUC", "serving view:" and
"feasign", "micro-pass" and "ingest-to-serve freshness"); every demo
runs as ``python -m`` and by path, and without a GPU the
default --device cuda is an error, not a quiet CPU run. The train_ctr (with its
--workdir resume) and train_aux_input parity tests against the reference
compositions are tests/test_torch_examples_ctr.py and _aux.py; the rank demos run under
the launcher in tests/test_torch_examples_{sharded,pipeline,
mesh_tower}.py."""

import os
import re
import subprocess
import sys

import pytest
import torch

from paddlebox_tpu_torch.examples import (serve_xbox, stream_train_serve,
                                          train_aux_input, train_ctr,
                                          train_downpour, train_mesh_tower,
                                          train_pipeline, train_sharded)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMOS = (train_ctr, train_aux_input, train_downpour, train_sharded,
         train_pipeline, train_mesh_tower, serve_xbox, stream_train_serve)


@pytest.mark.parametrize("tcp", [False, True], ids=["local", "tcp"])
def test_train_downpour(tcp, capsys):
    argv = ["--passes", "2", "--device", "cpu"]
    if tcp:
        argv += ["--tcp", "--async-comm"]
    res = train_downpour.main(argv)
    out = capsys.readouterr().out
    assert ("TCP PS on 127.0.0.1:" in out) == tcp
    assert "pass 1: loss=" in out
    m = re.search(r"eval AUC: (\d\.\d{4})  rows on PS: (\d+)", out)
    assert m and int(m.group(2)) == res["ps_rows"] > 0
    # the demo's files are learnable: the eval pass separates the labels
    assert res["eval_auc"] > 0.6


def test_serve_xbox_demo(capsys):
    res = serve_xbox.main(["--passes", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "serving view:" in out and "feasign" in out
    assert "oracle parity OK" in out
    assert re.search(r"delta refresh: day1 SaveDelta visible in served "
                     r"vectors \(gen \d+, \d+/64 keys changed\)", out), out
    assert res["changed"] > 0 and res["gen"] >= 1


def test_stream_train_serve_demo(capsys):
    res = stream_train_serve.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "micro-pass" in out
    assert "ingest-to-serve freshness" in out
    assert res["seed"]["instances"] == 600
    assert res["live"]["micro_passes"] == 2 and res["freshness_s"] > 0


@pytest.mark.parametrize("demo", DEMOS, ids=lambda m: m.__name__.rsplit(
    ".", 1)[1])
def test_default_device_without_a_gpu_is_an_error(demo, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main([])


def _run(*cmd, timeout=120):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, *cmd], capture_output=True,
                       text=True, timeout=timeout, env=env, cwd=REPO)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    return r.stdout


def test_demos_run_as_modules_and_by_path(tmp_path):
    out = _run("-m", "paddlebox_tpu_torch.examples.train_downpour",
               "--passes", "1", "--device", "cpu")
    assert "eval AUC" in out
    # by path from another directory: the script finds its package
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "paddlebox_tpu_torch",
                                      "examples", "train_aux_input.py"),
         "--passes", "1", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "aux rows served" in out.stdout
