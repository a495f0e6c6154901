"""The port imports neither jax nor the JAX package (keyhuntm1cpu_tpu), and
compiles nothing at import time: a fresh interpreter with both made
unimportable imports every port module and chip_smoke.py, and the build
directory it would use stays absent. Exact checks (no tolerance)."""

import ast
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "keyhuntm1cpu_tpu_torch",
    "keyhuntm1cpu_tpu_torch._build",
    "keyhuntm1cpu_tpu_torch.core.log",
    "keyhuntm1cpu_tpu_torch.core.security",
    "keyhuntm1cpu_tpu_torch.core.errors",
    "keyhuntm1cpu_tpu_torch.core.checkpoint",
    "keyhuntm1cpu_tpu_torch.core.config",
    "keyhuntm1cpu_tpu_torch.core.metrics",
    "keyhuntm1cpu_tpu_torch.ref.ecref",
    "keyhuntm1cpu_tpu_torch.ref.hashref",
    "keyhuntm1cpu_tpu_torch.field.fe",
    "keyhuntm1cpu_tpu_torch.field.pinv",
    "keyhuntm1cpu_tpu_torch.hash.consts",
    "keyhuntm1cpu_tpu_torch.hash.phash",
    "keyhuntm1cpu_tpu_torch.hash.pminikey",
    "keyhuntm1cpu_tpu_torch.curve.tables",
    "keyhuntm1cpu_tpu_torch.curve.pwalk",
    "keyhuntm1cpu_tpu_torch.curve.pbrute",
    "keyhuntm1cpu_tpu_torch.curve.pladder",
    "keyhuntm1cpu_tpu_torch.curve.points",
    "keyhuntm1cpu_tpu_torch.curve.walk",
    "keyhuntm1cpu_tpu_torch.filter.bitmap",
    "keyhuntm1cpu_tpu_torch.filter.sorted_table",
    "keyhuntm1cpu_tpu_torch.filter.host_table",
    "keyhuntm1cpu_tpu_torch.engine.common",
    "keyhuntm1cpu_tpu_torch.engine.bsgs",
    "keyhuntm1cpu_tpu_torch.engine.brute",
    "keyhuntm1cpu_tpu_torch.engine.minikeys",
    "keyhuntm1cpu_tpu_torch.engine.vanity",
    "keyhuntm1cpu_tpu_torch.utils.targets",
    "keyhuntm1cpu_tpu_torch.utils.xxhash",
    "keyhuntm1cpu_tpu_torch.utils.legacy",
    "keyhuntm1cpu_tpu_torch.filter.bloom",
    "keyhuntm1cpu_tpu_torch.native",
    "keyhuntm1cpu_tpu_torch.dist",
    "keyhuntm1cpu_tpu_torch.dist.coordinator",
    "keyhuntm1cpu_tpu_torch.dist.worker",
    "keyhuntm1cpu_tpu_torch.dist.multihost",
    "keyhuntm1cpu_tpu_torch.parallel",
    "keyhuntm1cpu_tpu_torch.parallel.partition",
    "keyhuntm1cpu_tpu_torch.parallel.mesh",
    "keyhuntm1cpu_tpu_torch.parallel.brute_mesh",
    "keyhuntm1cpu_tpu_torch.dryrun",
    "keyhuntm1cpu_tpu_torch.convert",
    "keyhuntm1cpu_tpu_torch.cli",
    "keyhuntm1cpu_tpu_torch.server",
    "keyhuntm1cpu_tpu_torch.bench_modes",
    "keyhuntm1cpu_tpu_torch.bench",
    "chip_smoke",
]
BLOCKED = ("jax", "keyhuntm1cpu_tpu")


def test_port_imports_without_jax_and_builds_nothing(tmp_path):
    build = tmp_path / "build"
    code = (
        "import sys, importlib\n"
        f"for b in {BLOCKED!r}:\n"
        "    sys.modules[b] = None\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k.split('.')[0] in " + repr(BLOCKED) + " for k, v in "
        "sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, KEYHUNT_TORCH_BUILD=str(build), PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
    assert not build.exists()


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_have_no_jax_import():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    # the port's measurement scripts, which chip_smoke.py imports
    paths += [os.path.join(REPO, "scripts", n) for n in os.listdir(os.path.join(REPO, "scripts"))
              if n.startswith("torch_") and n.endswith(".py")]
    for root, _, files in os.walk(os.path.join(REPO, "keyhuntm1cpu_tpu_torch")):
        paths += [os.path.join(root, n) for n in files if n.endswith(".py")]
    for path in paths:
        bad = set(_imported_roots(path)) & set(BLOCKED)
        assert not bad, (path, bad)
