"""The no-JAX guard and the command's refusals."""

import json
import shutil
import subprocess
import sys

import pytest

import harness
from conftest import BENCH, ROOT


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax", True), ("optax.tree", True), ("pyslice_tpu", True),
    ("pyslice_tpu.engine.calculator", True),
    ("pyslice_tpu_torch", False), ("pyslice_tpu_torch.ops.fused_step", False),
    ("jaxtyping", False), ("pyslice_tpu_extra", False), ("numpy", False)])
def test_forbidden_compares_whole_top_level_names(name, bad):
    assert harness.forbidden_modules({name: None}) == ([name] if bad else [])


def test_harness_loads_no_jax():
    code = (f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]\n"
            "import harness, attribution, roofline, inputs, common\n"
            "from reference import plain\n"
            "for d in ('tacaw_job', 'stream'):\n"
            "    harness.load_module(harness.BENCH / 'drivers' / (d + '.py'),"
            " d)\n"
            "import pyslice_tpu_torch\n"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout
    assert out.strip() == "[]"


def _command(cwd, *extra):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "hbn_1023.stem16_tacaw", "--seed", str(2 ** 31 + 3), "--seconds",
         "1", "--trace", "0", *extra], cwd=cwd, capture_output=True,
        text=True, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
                        "HOME": str(cwd)})


def test_command_fails_without_a_card():
    p = _command(ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "needs 1 CUDA card" in p.stderr


def test_command_fails_beside_nothing_but_itself(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _command(tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_manifest_is_json():
    json.loads((ROOT / "BENCHMARK.json").read_text())
