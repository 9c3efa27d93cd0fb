"""Importing every module of blockmaze_tpu_torch leaves JAX unloaded."""

import os
import pkgutil
import subprocess
import sys

import blockmaze_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_package_imports_without_jax():
    mods = [m.name for m in pkgutil.walk_packages(
        blockmaze_tpu_torch.__path__, "blockmaze_tpu_torch.")]
    assert "blockmaze_tpu_torch.groth16.prover" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' "
            "or k.startswith('jax.') or k.startswith('jaxlib'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
