"""The port covers the JAX package: a completeness check over both trees.

For every module of ``pyslice_tpu`` (one case each), every public top-level
function and class, and every public method, must have a counterpart of
the same name in the port's module of the same path, or an entry in
``NOT_PORTED``: a one-line reason (repeated in ROADMAP.md's "Not to port"
list), or ``moved:<module>:<name>`` where the port keeps it under another
module or name (that counterpart must exist). ``(module, "*")`` covers a
module left out whole. Every demo of ``examples/`` and
``scripts/verify_e2e.py`` has its counterpart in
``pyslice_tpu_torch/examples/``. Parsed with ``ast``: nothing is imported.
"""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX, PORT = ROOT / "pyslice_tpu", ROOT / "pyslice_tpu_torch"

NOT_PORTED = {
    ("ops/__init__.py", "config.ops_key"):
        "a jit cache key of the TPU kernels' trace-time switches; eager "
        "PyTorch has no trace to key",
    ("ops/fused_step.py", "digit_perm"):
        "the digit-permuted k order of the Pallas kernels; the CUDA "
        "kernels store natural order",
    ("ops/fused_step.py", "unpermute_shift_indices"):
        "undoes the Pallas kernels' digit-permuted order; the CUDA kernels "
        "store natural order",
    ("ops/fused_step.py", "fresnel_permuted_t"):
        "the Pallas kernels' permuted, transposed propagator planes; the "
        "CUDA kernels take the natural plane (fresnel_plane)",
    ("ops/fused_step.py", "transmission_planes"):
        "(cos, sin) float32 planes for the TPU's vector unit; the CUDA "
        "kernels take the complex t or the phase (transmission_stack)",
    ("ops/fused_step_odd_resident.py", "unscramble_shift_indices"):
        "undoes the TPU mixed-radix kernels' scrambled order; the CUDA "
        "kernels store natural order",
    ("ops/fused_step_odd_resident.py", "resident_odd_preferred"):
        "a TPU dispatch predicate measured against VMEM budgets; the "
        "port routes in physics/propagate.fused_family",
    ("ops/fused_step_odd_resident.py", "resident_odd_kspace_supported"):
        "a TPU VMEM-budget predicate of the k-space resident form; the "
        "port routes in physics/propagate.fused_family",
    ("physics/potential.py", "rasterize_traced_buckets"):
        "keys XLA's compile cache with traced bucket lists; the port's "
        "rasterize computes the same potential eagerly",
    ("utils/host.py", "*"):
        "complex host-device transfer workarounds of a TPU runtime; torch "
        "moves complex tensors with .to and .cpu",
    ("ops/matfft.py", "*"):
        "matrix-product FFTs for the TPU's matrix unit; the port runs "
        "torch.fft or its CUDA kernels",
    ("ops/matfft.py", "scrambled_factors"):
        "moved:ops/fused_step_odd.py:scrambled_factors",
    ("ops/transmit.py", "transmit_pallas"):
        "moved:ops/fused_step.py:row_pass",
    ("utils/profiling.py", "phase"):
        "a host-clock span store beside the trace; the port's span is a "
        "torch.profiler range on the trace's own clock",
    ("utils/profiling.py", "report"):
        "reads phase's store, which the port does not keep; the "
        "profiler's key_averages() sums the spans",
    ("utils/profiling.py", "reset"):
        "clears phase's store, which the port does not keep",
    ("utils/profiling.py", "device_timer"):
        "a kernel timer that nothing in the package calls; the benchmark "
        "and the scripts time the card from the profiler's trace or CUDA "
        "events",
    ("utils/profiling.py", "slice_step_rate"):
        "a rate that nothing in the package calls; the benchmark derives "
        "its rates from the trace",
}

# each demo of the JAX package and its counterpart in the port
DEMOS = sorted(p.relative_to(ROOT).as_posix()
               for p in (ROOT / "examples").glob("*.py")) + [
    "examples/walkthrough.ipynb", "scripts/verify_e2e.py"]


def public_names(path: Path) -> set:
    """Public top-level functions and classes, and ``Class.method`` for
    every public method."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and not node.name.startswith("_"):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(f"{node.name}.{m.name}" for m in node.body
                           if isinstance(m, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))
                           and not m.name.startswith("_"))
    return out


MODULES = sorted(p.relative_to(JAX).as_posix() for p in JAX.rglob("*.py"))


def moved_target(reason: str):
    """(module, name) of a ``moved:`` entry, else None."""
    if not reason.startswith("moved:"):
        return None
    _, mod, name = reason.split(":")
    return mod, name


@pytest.mark.parametrize("module", MODULES)
def test_torch_module_has_every_public_name(module):
    names = public_names(JAX / module)
    port = PORT / module
    have = public_names(port) if port.exists() else set()
    missing = []
    for name in sorted(names - have):
        reason = NOT_PORTED.get((module, name))
        if reason is None and (module, "*") in NOT_PORTED \
                and not port.exists():
            continue
        if reason is None:
            missing.append(name)
            continue
        target = moved_target(reason)
        if target is not None:
            assert target[1] in public_names(PORT / target[0]), \
                f"{module}:{name} is said to be at {target}, which lacks it"
    assert not missing, (f"{module}: {missing} have no counterpart in "
                         f"pyslice_tpu_torch/{module} and no NOT_PORTED "
                         "entry")


def test_torch_not_ported_table_is_current():
    """Every entry names a public name (or a module) of the JAX package
    that the port does not have at that path: no stale entries."""
    for (module, name), reason in NOT_PORTED.items():
        assert (JAX / module).exists(), module
        if name == "*":
            assert not (PORT / module).exists(), \
                f"{module} is ported now: drop its entry"
            continue
        assert name in public_names(JAX / module), (module, name)
        port = PORT / module
        assert not (port.exists() and name in public_names(port)), \
            f"{module}:{name} is ported now: drop its entry"
        assert "\n" not in reason and reason.strip(), (module, name)


def test_torch_roadmap_repeats_every_reason():
    """ROADMAP.md's "Not to port" list names each entry with its reason."""
    text = " ".join((ROOT / "ROADMAP.md").read_text().split())
    for (module, name), reason in NOT_PORTED.items():
        if moved_target(reason):
            continue
        shown = module if name == "*" else f"{module}` `{name}"
        assert shown in text and reason in text, \
            f"ROADMAP.md lacks `{shown}`: {reason}"


@pytest.mark.parametrize("demo", DEMOS)
def test_torch_demo_has_counterpart(demo):
    port = PORT / "examples" / Path(demo).name
    assert port.exists(), f"{demo} has no counterpart at {port}"
    if port.suffix == ".py":
        assert re.search(r"^def main\(|^# %%", port.read_text(), re.M), port
