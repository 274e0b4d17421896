"""The PyTorch port stands alone: no module of src/repro_torch, and no
line of chip_smoke.py, imports jax or the JAX package `repro`.

Checked twice: dynamically (a fresh interpreter imports every port
module and chip_smoke.py, then inspects sys.modules) and statically (no
import statement anywhere in the sources names jax or repro, which also
covers imports inside functions).
"""
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")

_DRIVER = r"""
import importlib, os, pkgutil, sys
sys.path.insert(0, {repo!r})
import repro_torch
names = []
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
import chip_smoke
chip_smoke.emit, chip_smoke.device_ms, chip_smoke.check_equal
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len(names))
print(",".join(bad))
"""


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _DRIVER.format(repo=REPO)],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    count, bad = proc.stdout.splitlines()[-2:]
    assert int(count) >= 80, proc.stdout  # every module of slices 1-5
    assert bad == "", f"port pulled in: {bad}"


_IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|repro)(?:\.|\s|$)",
                     re.MULTILINE)


def test_port_sources_never_import_jax_or_repro():
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            for m in _IMPORT.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, REPO)}: "
                                 f"{m.group(0).strip()}")
    assert not offenders, offenders
