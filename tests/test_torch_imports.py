"""The port stands alone: importing it loads neither JAX nor any module of
the JAX package, no source of the port (nor chip_smoke.py) names them,
reading a JAX-written checkpoint does not load them either, and the C++ it
runs is compiled from the port's own copies in
paddlebox_tpu_torch/native/."""

import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "paddlebox_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "optax", "flax", "chex", "paddlebox_tpu",
             "tools")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_import_loads_no_jax_and_no_reference_module():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import paddlebox_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    for m in ("train.trainer", "native.host_lib", "data.columnar",
              "data.native_parser", "embedding.native_store",
              "embedding.ckpt_store", "serving.store", "train.checkpoint",
              "train.eval_driver", "train.staging", "train.journal",
              "train.recovery", "utils.journal_format",
              "embedding.accessor", "embedding.push_kernels",
              "ops.row_kernels", "models.layers", "convert", "edge_cases",
              "rate_probe", "copy_probe", "train.flagship",
              "utils.stats", "utils.timer", "utils.channel", "obs",
              "obs.log", "obs.tracer", "obs.report", "metrics.quality",
              "metrics.drift", "models.nn_cross", "models.deepfm",
              "ops.sparse", "ops.seqpool", "embedding.optimizers",
              "embedding.pass_table", "ops.data_norm", "models",
              "models.ctr_dnn", "models.wide_deep", "models.dlrm",
              "models.mmoe", "models.esmm", "data.generator",
              "data.parser", "data.packer", "parallel",
              "parallel.ring_attention", "parallel.seq_trainer",
              "models.bst", "train.dense_optim", "data.streaming",
              "train.streaming_runner", "obs.device", "obs.flight",
              "obs.watchdog", "obs.exporter", "obs.watermark",
              "profile_pass", "ps", "ps.sgd_rule", "ps.table",
              "ps.service", "ps.worker", "embedding.ps_store",
              "parallel.tensor_parallel", "parallel.sharded_table",
              "models.wide_tower", "parallel.mesh_tower", "fleet.heter",
              "fleet.executor", "parallel.mesh", "parallel.pipeline",
              "serving", "serving.cache", "serving.codec",
              "serving.refresh", "serving.server", "serving.client",
              "serving.fleet"):
        assert "paddlebox_tpu_torch." + m in loaded, m
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad


def test_serving_import_loads_no_torch():
    """A serving replica's import: no torch, no JAX, no module of the JAX
    package and not the port's trainer (serving/fleet.py spawns replicas
    that must come up in about a second and hold no CUDA context)."""
    code = ("import json, sys, time\n"
            "t0 = time.perf_counter()\n"
            "import paddlebox_tpu_torch.serving\n"
            "print(json.dumps([time.perf_counter() - t0, "
            "sorted(sys.modules)]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    _secs, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded
           if m in ("torch", "jax", "paddlebox_tpu", "paddlebox_tpu_torch.train")
           or m.startswith(("torch.", "jax.", "paddlebox_tpu.",
                            "paddlebox_tpu_torch.train."))]
    assert not bad, bad
    assert "paddlebox_tpu_torch.serving.fleet" in loaded


def test_reading_a_jax_checkpoint_loads_no_jax(tmp_path):
    """A JAX-written day directory (its dense.pkl pickles jax arrays): the
    port's load_base raises, its sparse tier loads, and neither jax nor any
    module of the JAX package is imported."""
    import jax.numpy as jnp
    import numpy as np

    from paddlebox_tpu.config import flags
    from paddlebox_tpu.config.configs import (CheckpointConfig,
                                              SparseOptimizerConfig,
                                              TableConfig)
    from paddlebox_tpu.embedding.pass_table import PassTable
    from paddlebox_tpu.train.checkpoint import CheckpointManager

    flags.set_flag("ckpt_journal", False)
    table = PassTable(TableConfig(embedx_dim=4, pass_capacity=1024,
                                  optimizer=SparseOptimizerConfig()))
    table.store.lookup_or_create(np.arange(1, 100, dtype=np.uint64))
    cfg = CheckpointConfig(batch_model_dir=str(tmp_path / "batch"),
                           xbox_model_dir=str(tmp_path / "xbox"),
                           async_save=False)
    CheckpointManager(cfg, table).save_base({"w": jnp.ones(3)}, {}, "d0")
    code = (
        "import json, os, pickle, sys\n"
        "from paddlebox_tpu_torch.config.configs import (CheckpointConfig,\n"
        "    TableConfig)\n"
        "from paddlebox_tpu_torch.embedding.pass_table import PassTable\n"
        "from paddlebox_tpu_torch.train.checkpoint import "
        "CheckpointManager\n"
        "t = PassTable(TableConfig(embedx_dim=4, pass_capacity=1024),\n"
        "              device='cpu')\n"
        "cm = CheckpointManager(CheckpointConfig(%r, %r), t)\n"
        "try:\n"
        "    cm.load_base('d0')\n"
        "except pickle.UnpicklingError as e:\n"
        "    raised = str(e)\n"
        "t.load(os.path.join(%r, 'd0', 'sparse.xman'))\n"
        "print(json.dumps([raised, len(t.store), sorted(sys.modules)]))\n"
        % (cfg.batch_model_dir, cfg.xbox_model_dir, cfg.batch_model_dir))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    raised, rows, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "jax" in raised and rows == 99
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad


def _sources():
    for dirpath, _, names in os.walk(PKG):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_nothing_of_jax(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant) and _forbidden(
                str(node.args[0].value)):
            bad.append(node.args[0].value)
    assert not bad, bad


def test_host_library_builds_from_the_ports_own_sources(tmp_path,
                                                       monkeypatch):
    """The host library's compile command names exactly the port's copies
    of the three sources, each of which says what it copies; its file name
    follows the sources."""
    from paddlebox_tpu_torch.native import host_lib

    native = os.path.join(PKG, "native")
    assert host_lib.SRC_DIR == native
    for name in host_lib.SOURCES:
        with open(os.path.join(native, name), encoding="utf-8") as fh:
            assert fh.readline().startswith(
                "// Copy of paddlebox_tpu/native/%s" % name)
    assert sorted(n for n in os.listdir(native) if n.endswith(".cc")) == \
        sorted(host_lib.SOURCES)
    cmds = []

    def run(cmd, **kw):
        cmds.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return subprocess.CompletedProcess(cmd, 0, "")

    monkeypatch.setattr(host_lib.subprocess, "run", run)
    path = host_lib.build_host_lib(build_dir=str(tmp_path))
    assert os.path.exists(path) and len(cmds) == 1
    sources = [a for a in cmds[0] if a.endswith(".cc")]
    assert sources == [os.path.join(native, n) for n in host_lib.SOURCES]
    assert cmds[0][0] == "g++" and all(
        f in cmds[0] for f in ("-O3", "-shared", "-fPIC", "-std=c++17"))
    # built once: the next call finds the library
    assert host_lib.build_host_lib(build_dir=str(tmp_path)) == path
    assert len(cmds) == 1
    monkeypatch.setattr(host_lib, "CXX", "clang++")
    assert host_lib.lib_path(str(tmp_path)) != path
