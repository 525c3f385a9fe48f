"""The port stands alone: no module of src/repro_torch imports jax or the
reference package, every module imports with jax blocked, and importing
builds no kernel (no nvcc, no CUDA needed)."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py"))


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(SRC)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax", "optax")]
    assert not bad, f"{path} imports {bad}"


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from repro_torch.kernels import _build\n"
        "assert not _build._loaded  # nothing was built or loaded\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_HOME="/nonexistent")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_imports_nothing_of_jax():
    path = SRC.parent / "chip_smoke.py"
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad


def test_sp_modules_are_covered():
    """The SP path's modules are among those scanned and imported above."""
    for name in ("launch.mesh", "comm.trace", "comm.channel", "comm.stream",
                 "comm.kernel_backend", "core.collectives", "core.ulysses",
                 "core.ring", "core.torus", "core.strategy",
                 "kernels.ring_flash"):
        assert f"repro_torch.{name}" in MODULES


@pytest.mark.parametrize("name", [
    "configs.rwkv6_1_6b", "kernels.rwkv6_wkv", "models.ssm", "models.lm",
    "models.registry", "serving.engine"])
def test_rwkv_modules_are_covered(name):
    """The rwkv6 LM path's modules are among those scanned and imported
    above."""
    assert f"repro_torch.{name}" in MODULES
