"""The port stands alone: no module of src/repro_torch imports jax or the
reference package, every module imports with jax blocked, and importing
builds no kernel (no nvcc, no CUDA needed).  Its pointers into ROADMAP.md
name open items."""
import ast
import os
import pathlib
import re
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
                 "comm.kernel_backend", "comm.compress", "comm.profiler",
                 "core.collectives", "core.ulysses", "core.ring",
                 "core.torus", "core.strategy", "kernels.ring_flash",
                 "launch.commcheck", "launch.trace_report"):
        assert f"repro_torch.{name}" in MODULES


@pytest.mark.parametrize("name", [
    "configs.rwkv6_1_6b", "kernels.rwkv6_wkv", "models.ssm", "models.lm",
    "models.registry", "serving.engine"])
def test_rwkv_modules_are_covered(name):
    """The rwkv6 LM path's modules are among those scanned and imported
    above."""
    assert f"repro_torch.{name}" in MODULES


@pytest.mark.parametrize("name", [
    *(f"configs.{n}" for n in ("qwen2_1_5b", "stablelm_3b", "starcoder2_7b",
                               "chatglm3_6b", "qwen2_vl_2b")),
    "core.decode"])
def test_dense_lm_modules_are_covered(name):
    """The attention LMs' configs and the decode attention are among the
    modules scanned and imported with jax blocked above."""
    assert f"repro_torch.{name}" in MODULES


@pytest.mark.parametrize("name", [
    "configs.hymba_1_5b", "configs.qwen2_moe_a2_7b", "configs.arctic_480b",
    "models.moe", "models.sharding"])
def test_hybrid_and_moe_modules_are_covered(name):
    """The hybrid and MoE LMs' configs, the MoE layer and the sharding
    rules are among the modules scanned and imported with jax blocked
    above."""
    assert f"repro_torch.{name}" in MODULES


@pytest.mark.parametrize("name", ["serving.graphs", "launch.serve"])
def test_capture_and_launcher_modules_are_covered(name):
    """The captured steps and the serving launcher are among the modules
    scanned and imported above."""
    assert f"repro_torch.{name}" in MODULES


def _roadmap_items() -> dict[int, dict[int, str]]:
    """{queue: {item number: item text}} of ROADMAP.md's numbered queues."""
    text = (SRC.parent / "ROADMAP.md").read_text()
    queues = {}
    for m in re.finditer(r"^### Queue (\d+):(.*?)(?=^##|\Z)", text,
                         re.M | re.S):
        queues[int(m.group(1))] = {
            int(n): item for n, item in
            re.findall(r"^(\d+)\. (.*)$", m.group(2), re.M)}
    return queues


def test_roadmap_pointers_name_open_items():
    """Every "ROADMAP Queue N item M" under src/repro_torch (in code,
    comments, docstrings and messages, also where a string or a comment
    wraps) names item M of ROADMAP.md's Queue N, and that item is not
    done: a re-anchor that renumbers the queue cannot leave them stale
    unseen."""
    queues = _roadmap_items()
    assert 1 in queues and len(queues[1]) >= 5
    refs = []
    for path in sorted(PORT.rglob("*")):
        if path.suffix not in (".py", ".cu", ".cuh"):
            continue
        text = re.sub(r'"\s*\n\s*[rf]?"', "", path.read_text())
        text = re.sub(r"\s*\n\s*(#|//)?\s*", " ", text)
        for m in re.finditer(r"ROADMAP Queue (\d+),? items? (\w+)", text):
            refs.append((path.relative_to(SRC), m.group(1), m.group(2)))
    assert len(refs) >= 10
    for where, queue, item in refs:
        assert item.isdigit(), (where, queue, item)
        got = queues.get(int(queue), {}).get(int(item))
        assert got is not None, f"{where}: no Queue {queue} item {item}"
        assert not got.startswith("*Done"), (
            f"{where}: Queue {queue} item {item} is done: {got}")


@pytest.mark.parametrize("name", [
    "configs.whisper_tiny", "models.whisper", "models.registry",
    "train", "train.optimizer", "train.data", "train.checkpoint",
    "train.trainer", "launch.train", "kernels.flash_mqkv"])
def test_training_modules_are_covered(name):
    """The training path's and whisper's modules are among those scanned
    and imported (with jax blocked) above."""
    assert f"repro_torch.{name}" in MODULES


@pytest.mark.parametrize("name", [
    "serving.fleet", "serving.sampler", "launch.fleet", "launch.calibrate",
    "launch.dryrun", "launch.roofline", "launch.report", "examples",
    "examples.quickstart", "examples.serve_dit", "examples.generate_text",
    "examples.train_lm"])
def test_fleet_tools_and_examples_are_covered(name):
    """The fleet tier, the offline tools and the examples are among the
    modules scanned and imported (with jax blocked) above."""
    assert f"repro_torch.{name}" in MODULES
