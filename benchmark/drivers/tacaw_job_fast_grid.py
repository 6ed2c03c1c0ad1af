"""Closed loop of TACAW jobs on the fast grid, each one user's script.

``tacaw_job``'s jobs with the configuration's ``fast_grid`` passed to
``MultisliceCalculator.setup``: the in-plane counts snap up to a multiple
of 128, so the hBN box's 1023 points become 1024 at a pitch of l / 1024.
Everything else is ``tacaw_job``'s, run from a copy of that module whose
reference grid is ``reference.fast_grid.FastGrid``: the frames, the
check's job and planes, the plain reference and its comparison.

A job raises if the calculator's grid is not the reference's. The check
adds ``k_axes``: the (kx, ky) axes the job exported in ``WFData`` against
fftshift(fftfreq(n, l / n)), so a job that exports them at the requested
sampling fails. ``drain`` prints the kernel launches and the slice loops
by family a frame.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from common import host, rel_l2
from harness import load_module
from reference import fast_grid

LAUNCHES = ("a", "b", "c", "k4", "k5", "k6")


def ref_grid(cfg: dict) -> fast_grid.FastGrid:
    return fast_grid.FastGrid(cfg["box_A"], cfg["box_A"],
                              cfg["box_height_A"], cfg["sampling_A"],
                              cfg["slice_thickness_A"])


base = load_module(Path(__file__).with_name("tacaw_job.py"),
                   "bench_driver_tacaw_job_on_the_fast_grid")
base.ref_grid = ref_grid

slice_loop_shape = base.slice_loop_shape
combine_outputs = base.combine_outputs


def _families() -> dict:
    """Slice loops by family (empty on a program without the counter)."""
    from pyslice_tpu_torch.engine import pipeline
    return dict(getattr(pipeline, "families", {}))


def _launches() -> dict:
    from pyslice_tpu_torch.ops import fused_step
    return {k: fused_step.launches.get(k, 0) for k in LAUNCHES}


class Driver(base.Driver):

    def __init__(self, run):
        super().__init__(run)
        self.frames_run = 0
        self.since = None

    def warm(self):
        super().warm()
        self.frames_run = 0
        self.since = (_launches(), _families())

    def step(self, x) -> int:
        import pyslice_tpu_torch as pt
        job, frames = x
        run, cfg, tr = self.run, self.cfg, self.tr
        check = job == self.check_job
        traj = pt.Trajectory(atom_types=self.types, positions=frames,
                             velocities=np.zeros_like(frames),
                             box_matrix=np.diag([cfg["box_A"], cfg["box_A"],
                                                 cfg["box_height_A"]]),
                             timestep=cfg["timestep_ps"])
        calc = pt.MultisliceCalculator(device=run.device)
        with run.spans("calc_setup"):
            calc.setup(traj, aperture=tr["aperture_mrad"],
                       voltage_eV=cfg["voltage_eV"],
                       slice_thickness=cfg["slice_thickness_A"],
                       sampling=cfg["sampling_A"],
                       probe_positions=self.positions, device_output=True,
                       use_cache=False, fast_grid=cfg["fast_grid"])
        g = ref_grid(cfg)
        if (calc.nx, calc.ny, calc.nz) != (g.nx, g.ny, g.nz):
            raise RuntimeError(f"the calculator's grid {calc.nx} x {calc.ny}"
                               f" x {calc.nz} is not the reference's "
                               f"{g.nx} x {g.ny} x {g.nz}")
        with run.spans("calc_run"):
            wf = calc.run(progress=False)
        with run.spans("analysis"):
            tac = pt.TACAWData(wf)
            out = {"spectrum": tac.spectrum(),
                   "diffraction": tac.diffraction()}
            if tr.get("adf_mrad"):
                out["adf"] = pt.HAADFData(wf).calculateADF(tr["adf_mrad"])
        if check:
            waves = wf.wavefunction_data
            out["planes"] = {(p, t): host(waves[p, t, :, :, 0])
                             for p, t in self.planes}
            out["k_axes"] = [np.asarray(wf.kxs), np.asarray(wf.kys)]
            self.kept = out
        self.frames_run += self.n
        return self.n

    def drain(self):
        """Prints the launches of the slice kernels and the slice loops by
        family, a frame since the warm job: on the 1024^2 grid A 14, B 13,
        C 1 and one ``aligned`` loop."""
        n = max(self.frames_run, 1)
        (l0, f0), l1, f1 = self.since, _launches(), _families()
        per = lambda now, then: {k: (v - then.get(k, 0)) / n  # noqa: E731
                                 for k, v in now.items()}
        print(f"fast grid: {self.frames_run} frames after the warm job; "
              f"launches a frame {per(l1, l0)}; slice loops a frame "
              f"{per(f1, f0)}", file=sys.stderr)

    def counters(self) -> dict:
        """``tacaw_job``'s, and the slice loops by family
        (``slice_loops.<family>``)."""
        out = super().counters()
        out.update({f"slice_loops.{k}": float(v)
                    for k, v in _families().items()})
        return out

    def reference(self, prec) -> dict:
        out = super().reference(prec)
        out["k_axes"] = [host(a) for a in fast_grid.k_axes(
            ref_grid(self.cfg), prec.real)]
        return out


def combine_reference(parts: list, cell) -> dict:
    return dict(base.combine_reference(parts, cell),
                k_axes=parts[0]["k_axes"])


def compare(got: dict, want: dict) -> dict:
    values = base.compare(got, want)
    values["k_axes"] = (rel_l2(got["k_axes"], want["k_axes"])
                        if "k_axes" in got else float("inf"))
    return values
