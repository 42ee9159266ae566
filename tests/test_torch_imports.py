"""The port stands alone: importing it loads neither JAX nor any module of
the JAX package, and no source of the port (nor chip_smoke.py) names them."""

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
    assert "paddlebox_tpu_torch.train.trainer" in loaded
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
