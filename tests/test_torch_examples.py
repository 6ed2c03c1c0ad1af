"""The port's examples (``pyslice_tpu_torch/examples``) run end to end on
the CPU, in process, at the toy arguments of ``tests/test_examples.py``
with ``--device cpu``: exit without an exception, the same expected output
fragments, the physics checks each example asserts (``si_dumbbells``'s
dumbbell split, ``verify_e2e``'s ``ALL OK``). Outputs go to a temporary
working directory. The port's notebook is held to its percent-format
source as ``tests/test_examples.py`` holds the JAX package's. Phase 23 of
``chip_smoke.py`` (each example that reaches the kernels held against its
run with the dispatch off) is rehearsed here at toy sizes.
"""

import json
import runpy
import sys
from pathlib import Path

import pytest
import torch

EXAMPLES = Path(__file__).resolve().parent.parent / "pyslice_tpu_torch" / \
    "examples"

# (module, argv, expected stdout fragments): tests/test_examples.py's cases;
# every example that computes gets --device cpu (make_notebook and
# make_fixture only write files)
CPU = ["--device", "cpu"]
CASES = [
    ("tacaw_demo", ["--frames", "8", "--sampling", "0.3"] + CPU,
     ["spectrum", "HAADF: ", "image (10, 10)"]),
    ("walkthrough", CPU, ["HAADF image (4, 4)", "unitarity", "done."]),
    ("make_notebook", [], ["cells"]),
    ("make_fixture", ["--frames", "4", "--cells", "2", "2"],
     ["4 frames, 16 atoms"]),
    ("diffraction_toolkit", ["--configs", "2", "--azimuths", "2"] + CPU,
     ["PED", "radial profile"]),
    ("calibration_demo", ["--steps-scale", "0.02"] + CPU,
     ["aberrations", "tilt series"]),
    ("experimental_calibration", ["--scan", "12"] + CPU,
     ["calibration report", "solved"]),
    ("inverse_potential", ["--nx", "32", "--nz", "2", "--steps", "15"] + CPU,
     ["correlation(recovered, true)"]),
    ("ptychography_demo",
     ["--scan", "8", "--iters", "2", "--msp-steps", "5"] + CPU,
     ["SSB", "iCoM", "ePIE", "MSP"]),
    ("realistic_stem", ["--scan", "2"] + CPU, ["contrast ideal"]),
    ("si_dumbbells", ["--scan", "3", "--frames", "1"] + CPU,
     ["dumbbell split 1.358", "si_dumbbells OK"]),
    ("verify_e2e", CPU, ["ALL OK"]),
]


def run_example(name, argv, monkeypatch, capsys, tmp_path):
    """``python -m pyslice_tpu_torch.examples.<name> <argv>``, in process,
    from ``tmp_path``; returns its standard output."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MPLBACKEND", "Agg")
    monkeypatch.setattr(sys, "argv", [name] + list(argv))
    runpy.run_module(f"pyslice_tpu_torch.examples.{name}",
                     run_name="__main__", alter_sys=True)
    return capsys.readouterr().out


@pytest.mark.parametrize("name,argv,expect", CASES,
                         ids=[c[0] for c in CASES])
def test_torch_example_runs(name, argv, expect, monkeypatch, capsys,
                            tmp_path):
    out = run_example(name, argv, monkeypatch, capsys, tmp_path)
    for frag in expect:
        assert frag in out, f"{name}: expected {frag!r} in\n{out[-3000:]}"
    # outputs land in the working directory, never in the package
    assert not any(EXAMPLES.glob("*.npy"))
    assert not any(EXAMPLES.glob("*.lammpstrj"))


def test_torch_examples_refuse_cuda_without_a_card(monkeypatch, capsys,
                                                   tmp_path):
    """--device cuda (the default) stops without a card: no fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_example("si_dumbbells", ["--scan", "2"], monkeypatch, capsys,
                    tmp_path)


def test_torch_notebook_in_sync():
    """walkthrough.ipynb is generated: it must match walkthrough.py."""
    from pyslice_tpu_torch.examples.make_notebook import py_to_ipynb
    want = py_to_ipynb((EXAMPLES / "walkthrough.py").read_text())
    have = json.loads((EXAMPLES / "walkthrough.ipynb").read_text())
    assert [c["source"] for c in want["cells"]] == \
        [c["source"] for c in have["cells"]], \
        ("walkthrough.ipynb is stale: run python -m pyslice_tpu_torch."
         "examples.make_notebook --out pyslice_tpu_torch/examples/"
         "walkthrough.ipynb")


# chip_smoke.py's phase 23 on the CPU, at toy sizes: the runs that must
# reach the kernels on the card, each run again with the dispatch off and
# held against the first run
PHASE23_RUNS = [
    ("tacaw_demo", ["hbn_1023.lammpstrj", "--sampling", "0.3", "--frames",
                    "4"], ["HAADF: ", "image (10, 10)"], {"k6": 4}),
    ("si_dumbbells", ["--scan", "3", "--frames", "1"], ["si_dumbbells OK"],
     "kernels"),
    ("inverse_potential", ["--nx", "32", "--nz", "2", "--steps", "3"],
     ["correlation(recovered, true)"], "kernels"),
    ("verify_e2e", [], ["ALL OK"], "kernels"),
]


def cpu_smoke(monkeypatch):
    """chip_smoke with a no-op synchronize and a ``require`` that collects
    what failed instead of exiting."""
    monkeypatch.syspath_prepend(str(EXAMPLES.parent.parent))
    import chip_smoke
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    failed = []
    monkeypatch.setattr(chip_smoke, "require",
                        lambda ok, what: ok or failed.append(what))
    return chip_smoke, failed


def test_phase23_holds_each_kernel_run_against_its_plain_run(
        monkeypatch, capsys, tmp_path):
    """On the CPU both runs of an example take the plain path: every hold
    (the arrays it saves, the ADF and gradients it is handed, its printed
    numbers) agrees, and only the launch checks fail, as no kernel runs
    here."""
    cs, failed = cpu_smoke(monkeypatch)
    monkeypatch.setenv("MPLBACKEND", "Agg")
    monkeypatch.setattr(cs, "EX_DUMP_LX", 12.75)
    monkeypatch.setattr(cs, "QUICK_FRAMES", 4)
    monkeypatch.setattr(cs, "EXAMPLE_RUNS", PHASE23_RUNS)
    cs.examples_phase(torch.device("cpu"), "cpu", str(tmp_path))
    out = capsys.readouterr().out
    assert len(failed) == len(PHASE23_RUNS), failed
    assert all("launch" in what for what in failed), failed
    for held in ("tacaw_demo spectrum.npy, kernels vs plain",
                 "tacaw_demo haadf_image.npy, kernels vs plain",
                 "si_dumbbells calculateADF call 0 [0], kernels vs plain",
                 "si_dumbbells printed, plain:",
                 "inverse_potential step call 0 [0], kernels vs plain",
                 "inverse_potential printed, plain:   correlation",
                 "verify_e2e grad call 0 [0], kernels vs plain"):
        assert held in out, held


def test_phase23_hold_fails_a_run_that_disagrees(monkeypatch, capsys,
                                                 tmp_path):
    """A kernel run 1% off its plain run fails each hold: a saved array
    (here spectrum.npy, held by its residual), a recorded gradient
    (GRAD_REL) and a printed number (rel 1e-3)."""
    import numpy as np
    cs, failed = cpu_smoke(monkeypatch)
    x = np.random.default_rng(0).random((8, 8))
    for way, f in (("kernels", 1.01), ("plain", 1.0)):
        (tmp_path / way).mkdir()
        np.save(tmp_path / way / "spectrum.npy", x * f)
    line = "  step    0  loss {:.3e}\n"
    bad = cs.hold_example("inverse_potential",
                          (line.format(0.101), [[[x * 1.01]]],
                           str(tmp_path / "kernels")),
                          (line.format(0.1), [[[x]]], str(tmp_path / "plain")))
    assert not failed, failed
    assert bad == ["inverse_potential spectrum.npy",
                   "inverse_potential step call 0 [0]",
                   "printed 'step    0  loss 1.010e-01' (rel 1e-3)"], bad
