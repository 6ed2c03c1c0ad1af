"""Each port example against its JAX counterpart, number for number.

Opt-in like the JAX package's examples tier (``-m examples`` or
PYSLICE_EXAMPLES=1). Both run in subprocesses on the CPU at the toy
arguments of ``tests/test_examples.py``, each package at its default
precision (complex64). The JAX run draws its thermal ensembles and its
shot noise with the port's torch generators, seeded with the JAX demo's
seeds (``thermal_configs`` and ``apply_shot_noise`` are replaced in that
process only), so that both see the same atoms and the same counts; every
other input is drawn from NumPy seeds in both.

The printed lines are matched in order by their text with the numbers
taken out (timings dropped); a port line without a JAX twin must be listed
in ``PORT_ONLY``. Numbers agree to relative 1e-3 (complex64 summaries),
plus half a unit of the last printed digit; a physics check an example
asserts prints the same text. ``LOOSE`` lists the numbers held to another
bar, each with its reason. verify_e2e's adjoint gradient, which the JAX
script checks on the TPU only, is held against the JAX package's. The
arrays the demos save agree to the 1e-6 magnitude residual
(``ARRAY_BARS``: another bar, with its reason). The ``-float64`` cases run
calibration_demo and ptychography_demo in float64 in both packages.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytestmark = pytest.mark.examples

ROOT = Path(__file__).resolve().parent.parent

CASES = [
    ("tacaw_demo", "examples/tacaw_demo.py",
     ["--frames", "8", "--sampling", "0.3"]),
    ("walkthrough", "examples/walkthrough.py", []),
    ("make_fixture", "examples/make_fixture.py",
     ["--frames", "4", "--cells", "2", "2", "--out", "monolayer.lammpstrj"]),
    ("diffraction_toolkit", "examples/diffraction_toolkit.py",
     ["--configs", "2", "--azimuths", "2"]),
    ("calibration_demo", "examples/calibration_demo.py",
     ["--steps-scale", "0.02"]),
    ("experimental_calibration", "examples/experimental_calibration.py",
     ["--scan", "12"]),
    ("inverse_potential", "examples/inverse_potential.py",
     ["--nx", "32", "--nz", "2", "--steps", "15"]),
    ("ptychography_demo", "examples/ptychography_demo.py",
     ["--scan", "8", "--iters", "2", "--msp-steps", "5"]),
    ("realistic_stem", "examples/realistic_stem.py", ["--scan", "2"]),
    ("si_dumbbells", "examples/si_dumbbells.py",
     ["--scan", "3", "--frames", "1"]),
    ("verify_e2e", "scripts/verify_e2e.py", []),
]
# the examples that compute take --device (the JAX ones: cpu | default)
NO_DEVICE = {"make_fixture"}
JAX_DEVICE = {"realistic_stem", "si_dumbbells", "inverse_potential"}

# (line pattern, number context, bar, reason): the numbers held to another
# bar than rel 1e-3, on the lines that match the pattern, each number whose
# preceding text ends with the context (every number on the line: None)
LOOSE = {
    "walkthrough": [
        (r"^unitarity", r"=", ("abs", 1e-6),
         "roundoff of a gradient that is 0 in exact arithmetic"),
        (r"^exit .* power ratio", r"power ratio", ("abs", 1e-5),
         "float32 roundoff about 1 (verify_e2e's norm bar is 1e-4)"),
    ],
    "diffraction_toolkit": [
        (r"total intensity conserved to", r"conserved to", ("abs", 1e-5),
         "roundoff of a ratio that is 1 in exact arithmetic"),
    ],
    "ptychography_demo": [
        (r"^(ePIE|MSP)", r"r =", ("abs", 0.05),
         "float32 iterations through a hard aperture: at dark detector "
         "pixels the modulus step divides roundoff by roundoff, so two "
         "correct FFTs part (0.019 and 0.028 measured)"),
        (r"^(ePIE|MSP)", r"loss|->", ("rel", 1e-2),
         "the same iterations' losses (4e-3 measured); the float64 case "
         "holds them to rel 1e-3"),
    ],
    "calibration_demo": [
        (r"^1\. aberrations", r"@", ("rel", 0.2),
         "phi_A1 (float32): the first steps set it where |A1| is ~0, so "
         "the angle starts from roundoff (0.50 vs 0.60 rad)"),
        (r"^1\. aberrations", r"C1|C3|A1", ("rel", 0.05),
         "C1, C3 and |A1| after the few steps that start from that angle "
         "(1.0%, 2.3%, 0.4% measured); the float64 case holds every "
         "number of the line to rel 1e-3"),
    ],
    "verify_e2e": [
        (r"max dev|rel dev|wave rel|residual",
         r"max dev|rel dev|wave rel|residual", ("abs", 1e-4),
         "roundoff-level deviations, each also under the example's own "
         "bar (its [ok])"),
    ],
}
# the same examples in float64 ("single" read as "double" in both
# packages, JAX in x64): rel 1e-3 but for these numbers, with the reason
LOOSE64 = {
    "ptychography_demo": [
        (r"^(ePIE|MSP)", r"r =", ("abs", 0.01),
         "the hard-aperture iterations part in float64 too (0.004 "
         "measured): the modulus step at dark pixels divides roundoff by "
         "roundoff"),
    ],
}
DOUBLE = """
import pyslice_tpu{port}.core.dtypes as _dt
_gp = _dt.get_precision
_dt.get_precision = lambda p=None: _gp("double" if p in (None, "single")
                                       else p)
_dt.set_default_precision("double")
"""
# lines the port prints and the JAX demo does not, with the reason
PORT_ONLY = {
    "walkthrough": [r"^device: "],
    "verify_e2e": [r"^device: ", r"adjoint gradient live"],
}
# the JAX demo's lines that the port does not print, with the reason
JAX_ONLY = {
    "verify_e2e": [r"^devices: "],
}
MAX_RESIDUAL = 1e-6
# saved arrays held to another residual bar, with the reason
ARRAY_BARS = {
    "epie_object.npy": (1e-3, "ePIE's float32 iterates, as its line"),
    "msp_potential.npy": (None, "not compared: Adam's first step moves "
                          "every pixel by +-lr, also where the gradient "
                          "is roundoff (outside the probe's band), so the "
                          "raw iterate is not determined; its line's "
                          "band-limited correlation is compared"),
    "dispersion.npy": (1e-4, "the mean-free TACAW signal sampled along "
                       "a path mostly outside the band, where it is "
                       "complex64 roundoff of the subtracted time mean"),
}
NOISE = re.compile(r"Processing frames|Warning|self\.array = defocus|"
                   r"^\s*warnings\.warn|^interactive\(|Figure\(|\x1b")
NUM = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")
TIME = re.compile(r"(?<![\w.])\d+(?:\.\d+)?\s?s(?![A-Za-z(])")

JAX_PRELUDE = """
import jax; jax.config.update('jax_platforms', 'cpu')
import numpy as np, torch
import pyslice_tpu.engine.thermal as _th
import pyslice_tpu.analysis.detectors as _det
from pyslice_tpu.data.trajectory import Trajectory as _JT
from pyslice_tpu_torch.data.trajectory import Trajectory as _PT
from pyslice_tpu_torch.engine.thermal import thermal_configs as _port_tc
from pyslice_tpu_torch.analysis.detectors import apply_shot_noise as _noise

def _tc(trajectory, n_configs, sigma, seed=0, distribution='gaussian'):
    t = _PT(np.asarray(trajectory.atom_types), np.asarray(trajectory.positions),
            np.asarray(trajectory.velocities), np.asarray(trajectory.box_matrix),
            trajectory.timestep)
    c = _port_tc(t, n_configs, sigma, torch.Generator().manual_seed(int(seed)),
                 distribution)
    return _JT(c.atom_types, c.positions, c.velocities, c.box_matrix, c.timestep)

_th.thermal_configs = _tc
_det.apply_shot_noise = lambda image, dose, pixel_area=1.0, seed=0: _noise(
    image, dose, pixel_area, generator=torch.Generator().manual_seed(seed),
    device='cpu')
"""


def run(code, cwd):
    env = dict(os.environ, MPLBACKEND="Agg", PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                       capture_output=True, text=True, timeout=900, env=env)
    assert r.returncode == 0, f"{code[-300:]}\n{r.stderr[-3000:]}"
    return r.stdout


def run_jax(script, argv, cwd, prelude=""):
    path = ROOT / script
    return run(JAX_PRELUDE + prelude + f"import sys, runpy; sys.argv = [{str(path)!r}]"
               f" + {argv!r}\nrunpy.run_path({str(path)!r}, "
               "run_name='__main__')\n", cwd)


def run_port(name, argv, cwd, prelude=""):
    return run(prelude + f"import sys, runpy; sys.argv = [{name!r}] + {argv!r}\n"
               f"runpy.run_module('pyslice_tpu_torch.examples.{name}', "
               "run_name='__main__', alter_sys=True)\n", cwd)


def lines(out):
    return [ln.rstrip() for ln in out.splitlines()
            if ln.strip() and not NOISE.search(ln)]


def skeleton(line):
    return NUM.sub("#", TIME.sub("<t>", line))


def numbers(line):
    """The numbers of a line (timings dropped), each with the text before
    it."""
    text = TIME.sub("<t>", line)
    return [(m.group(), text[:m.start()]) for m in NUM.finditer(text)]


def half_unit(text):
    """Half a unit of the last printed digit of a number's text."""
    mant = re.split(r"[eE]", text)[0]
    exp = int(text.split("e")[-1]) if re.search(r"[eE]", text) else 0
    dec = len(mant.split(".")[1]) if "." in mant else 0
    return 0.5 * 10.0 ** (exp - dec)


def numbers_agree(a_line, b_line, loose):
    """Whether each number of b_line is within its bar of a_line's: the
    bar of the first ``loose`` entry whose context ends the text before
    it, else rel 1e-3; a relative bar adds half a unit of the last printed
    digit."""
    for (sa, before), (sb, _) in zip(numbers(a_line), numbers(b_line)):
        bar = next((lb for ctx, lb in loose
                    if ctx is None or re.search(f"(?:{ctx})\\s*$", before)),
                   ("rel", 1e-3))
        a, b = float(sa), float(sb)
        if bar[0] == "abs":
            ok = abs(a - b) <= bar[1]
        else:
            ok = abs(a - b) <= (bar[1] * max(abs(a), abs(b))
                                + max(half_unit(sa), half_unit(sb)))
        if not ok:
            return False
    return True


def jax_adjoint_g():
    """|g| of the adjoint check of scripts/verify_e2e.py (the same inputs
    and loss) through the JAX package on the CPU, where that script does
    not run the check."""
    import jax
    import jax.numpy as jnp
    from pyslice_tpu.physics.adjoint import multislice_diff
    rngj = np.random.default_rng(11)
    psij = (rngj.normal(size=(2, 128, 128))
            + 1j * rngj.normal(size=(2, 128, 128))).astype(np.complex64)
    vj = (rngj.normal(size=(4, 128, 128)) * 30).astype(np.float32)
    kxj = np.fft.fftfreq(128, 0.1).astype(np.float32)
    wj = jnp.asarray(rngj.random((128, 128)).astype(np.float32))

    def loss_j(pot):
        out = multislice_diff(jnp.asarray(psij), pot, kxj, kxj, eV=100e3,
                              dz=0.8)
        return jnp.mean(wj * jnp.abs(jnp.fft.fft2(out)) ** 2)

    return float(jnp.max(jnp.abs(jax.jit(jax.grad(loss_j))(
        jnp.asarray(vj)))))


@pytest.mark.parametrize(
    "name,script,argv,precision",
    [pytest.param(*c, "single", id=c[0]) for c in CASES]
    + [pytest.param(*c, "double", id=f"{c[0]}-float64") for c in CASES
       if c[0] in ("calibration_demo", "ptychography_demo")])
def test_torch_example_matches_jax(name, script, argv, precision, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_argv = argv + (["--device", "cpu"] if name in JAX_DEVICE else [])
    port_argv = argv + ([] if name in NO_DEVICE else ["--device", "cpu"])
    double = precision == "double"
    jax_out = lines(run_jax(script, jax_argv, tmp_path / "jax", (
        "jax.config.update('jax_enable_x64', True)"
        + DOUBLE.format(port="")) if double else ""))
    port_out = lines(run_port(name, port_argv, tmp_path / "port",
                              DOUBLE.format(port="_torch") if double else ""))
    jax_out = [ln for ln in jax_out
               if not any(re.search(p, ln) for p in JAX_ONLY.get(name, []))]

    it = iter(port_out)
    matched = []
    for jl in jax_out:
        for pl in it:
            if skeleton(pl) == skeleton(jl):
                matched.append((jl, pl))
                break
            assert any(re.search(p, pl) for p in PORT_ONLY.get(name, [])), \
                f"{name}: port line without a JAX twin: {pl!r}\n" \
                f"(looking for {jl!r})"
        else:
            pytest.fail(f"{name}: no port line matches {jl!r}")
    assert matched, name
    for jl, pl in matched:
        loose = [(ctx, bar) for pattern, ctx, bar, _ in
                 (LOOSE64 if double else LOOSE).get(name, [])
                 if re.search(pattern, jl)]
        assert numbers_agree(jl, pl, loose), \
            f"{name}: numbers differ beyond {loose or 'rel 1e-3'}:\n" \
            f"  jax:  {jl}\n  port: {pl}"
    if name == "verify_e2e":
        # the port's adjoint line has no JAX twin on the CPU: its |g|
        # against the JAX package's, to rel 1e-3
        g_line, = [ln for ln in port_out if "adjoint gradient live" in ln]
        sg = re.search(r"\|g\| (\S+),", g_line).group(1)
        assert numbers_agree(f"|g| {jax_adjoint_g():.2e}", f"|g| {sg}", []), \
            f"verify_e2e: |g| {sg} against JAX's {jax_adjoint_g():.3e}"

    # the arrays both demos save: the reference's magnitude residual (its
    # complex64 bar), or the bar of ARRAY_BARS
    for f in sorted((tmp_path / "jax").rglob("*.npy")):
        g = tmp_path / "port" / f.relative_to(tmp_path / "jax")
        a, b = np.abs(np.load(f)), np.abs(np.load(g))
        assert a.shape == b.shape, f
        res = float(((a - b) ** 2).sum() / max((a ** 2).sum(), 1e-300))
        bar = ARRAY_BARS.get(f.name, (MAX_RESIDUAL,))[0]
        assert bar is None or res <= bar, \
            f"{f.name}: residual {res:.3e} > {bar}"
    for f in sorted((tmp_path / "jax").glob("*.lammpstrj")):
        assert f.read_bytes() == (tmp_path / "port" / f.name).read_bytes()
