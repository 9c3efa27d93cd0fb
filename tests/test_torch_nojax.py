"""blockmaze_tpu_torch and chip_smoke.py stand apart from the JAX package:
importing every module of the port leaves neither jax nor any module of
blockmaze_tpu loaded, and no import statement anywhere in the port or in
chip_smoke.py (at top level or inside a function) names either."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest

import blockmaze_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "blockmaze_tpu_torch")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "blockmaze_tpu")


def test_package_imports_without_jax():
    mods = [m.name for m in pkgutil.walk_packages(
        blockmaze_tpu_torch.__path__, "blockmaze_tpu_torch.")]
    assert "blockmaze_tpu_torch.groth16.prover" in mods
    assert "blockmaze_tpu_torch.groth16.verifier" in mods
    assert "blockmaze_tpu_torch.serialization.native_io" in mods
    assert "blockmaze_tpu_torch.curves.decompress" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods + ['chip_smoke']!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'blockmaze_tpu'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_names_jax_or_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = [(line, name) for line, name in _imported_names(tree)
           if _forbidden(name)]
    assert not bad, bad


def test_static_check_catches_function_level_imports():
    tree = ast.parse("def f():\n    from blockmaze_tpu.fields import host\n"
                     "    import jax.numpy as jnp\n"
                     "    from blockmaze_tpu_torch.fields import tfield\n")
    assert [n for _, n in _imported_names(tree) if _forbidden(n)] == \
        ["blockmaze_tpu.fields", "jax.numpy"]
