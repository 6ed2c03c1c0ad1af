"""Closed loop of TACAW jobs, each one user's script.

A job: a trajectory of ``frames_per_job`` thermal frames it has not seen
(drawn from the seed and the job's index), ``MultisliceCalculator.setup``
(``device_output=True``; ``mesh=`` when the traffic names a mesh), ``run``,
then ``TACAWData.spectrum()`` and ``.diffraction()`` and, where the
traffic asks, ``HAADFData.calculateADF``; the results end on the host and
the job's state is dropped before the next job.

The check takes one job drawn from the seed among the window's first
``check_steps``: k-space exit waves of some (probe, frame) pairs and the
job's analysis outputs, against the plain reference computed again from
the same frames. The numbers the cell's limits name are compared; the
others are printed as readings.
"""

from __future__ import annotations

import numpy as np

import inputs
from common import host, ref_grid, rel_l2, scan
from reference import plain


def probe_positions(traffic: dict, box: float):
    """The traffic's probe grid, or one probe at the box's centre."""
    grid = traffic.get("probe_grid")
    if grid is None:
        return [(box / 2, box / 2)]
    return [tuple(p) for p in scan(grid)]


def slice_loop_shape(cell):
    """(probes a frame, nx, ny, nz) of the cell's slice loops."""
    g = ref_grid(cell.config)
    return len(probe_positions(cell.traffic, cell.config["box_A"])), \
        g.nx, g.ny, g.nz


class Driver:

    def __init__(self, run):
        import torch
        self.run, self.cfg, self.tr = run, run.config, run.traffic
        self.base, self.types = inputs.hbn_box(self.cfg["box_A"],
                                               self.cfg["layer_z_A"])
        self.positions = probe_positions(self.tr, self.cfg["box_A"])
        self.n = self.tr["frames_per_job"]
        self.job = 0
        pick = inputs.generator(run.seed, inputs.SAMPLE)
        self.check_job = 1 + int(pick.integers(self.tr["check_steps"]))
        planes = self.tr["check_planes"]
        self.planes = sorted(zip(
            pick.integers(len(self.positions), size=planes).tolist(),
            pick.choice(self.n, size=planes, replace=False).tolist()))
        self.kept = None
        self.torch = torch

    # -- the frames a rank holds on a mesh
    def _local_frames(self):
        if self.run.mesh is None:
            return 0, self.n
        from pyslice_tpu_torch.parallel.mesh import FRAME_AXIS, coord, extent
        per = self.n // extent(self.run.mesh, FRAME_AXIS)
        lo = coord(self.run.mesh, FRAME_AXIS) * per
        return lo, lo + per

    def frames(self, job: int) -> np.ndarray:
        return inputs.thermal_frames(self.base, self.n,
                                     self.cfg["thermal_sigma_A"],
                                     self.run.seed, inputs.JOB, job)

    def prepare(self):
        x = (self.job, self.frames(self.job))
        self.job += 1
        return x

    def warm(self):
        self.step(self.prepare())

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
                       use_cache=False, mesh=run.mesh)
        with run.spans("calc_run"):
            wf = calc.run(progress=False)
        with run.spans("analysis"):
            tac = pt.TACAWData(wf)
            out = {"spectrum": tac.spectrum(),
                   "diffraction": tac.diffraction()}
            if tr.get("adf_mrad"):
                out["adf"] = pt.HAADFData(wf).calculateADF(tr["adf_mrad"])
        if check:
            from pyslice_tpu_torch.parallel.sharded import local_of
            waves = local_of(wf.wavefunction_data)
            lo, hi = self._local_frames()
            out["planes"] = {(p, t): host(waves[p, t - lo, :, :, 0])
                             for p, t in self.planes if lo <= t < hi}
            self.kept = out
        return self.n

    def drain(self):
        """The checked job runs inside the window (``check_steps``)."""

    def counters(self) -> dict:
        from pyslice_tpu_torch.parallel import sharded
        return {"all_to_all_s": sharded.STATS["all_to_all_s"]}

    def outputs(self) -> dict:
        return self.kept

    def release(self):
        """The job's state went with its step."""

    # -- the plain reference: this rank's share of the checked job's probes
    def reference(self, prec) -> dict:
        torch = self.torch
        cfg, tr, run = self.cfg, self.tr, self.run
        dev = run.device
        grid = ref_grid(cfg)
        frames = self.frames(self.check_job)
        share = np.array_split(np.arange(len(self.positions)),
                               run.world)[run.rank]
        eV = cfg["voltage_eV"]
        mask = torch.as_tensor(plain.adf_mask(grid, tr.get("adf_mrad") or 0,
                                              eV), device=dev)
        out = {"spectrum_sum": 0.0, "diffraction_sum": 0.0, "collected": {},
               "planes": {}}
        block = tr["check_probe_block"]
        for b0 in range(0, len(share), block):
            ids = share[b0:b0 + block]
            psi0 = plain.probes(grid, tr["aperture_mrad"], eV,
                                [self.positions[i] for i in ids], prec, dev)
            waves = torch.empty((len(ids), self.n, grid.nx, grid.ny),
                                dtype=prec.complex, device=dev)
            for t in range(self.n):
                v = plain.potential(frames[t], self.types, grid, prec, dev)
                waves[:, t] = plain.exit_waves(psi0, v, grid, eV, prec)
            for k, p in enumerate(ids):
                inten = plain.tacaw_intensity(waves[k])
                out["spectrum_sum"] = out["spectrum_sum"] + host(
                    inten.sum(dim=(1, 2)))
                out["diffraction_sum"] = out["diffraction_sum"] + host(
                    inten.sum(dim=0))
                del inten
                out["collected"][int(p)] = float(
                    (waves[k].abs() * mask).sum(dim=(1, 2)).mean())
                for pp, t in self.planes:
                    if pp == p:
                        out["planes"][(pp, t)] = host(waves[k, t])
            del waves
        return out


def combine_outputs(parts: list) -> dict:
    out = dict(parts[0], planes={})
    for p in parts:
        out["planes"].update(p["planes"])
    return out


def combine_reference(parts: list, cell) -> dict:
    n_probes = sum(len(p["collected"]) for p in parts)
    collected = {}
    for p in parts:
        collected.update(p["collected"])
    out = {"spectrum": sum(p["spectrum_sum"] for p in parts) / n_probes,
           "diffraction": sum(p["diffraction_sum"] for p in parts)
           / n_probes,
           "planes": {}}
    for p in parts:
        out["planes"].update(p["planes"])
    if cell.traffic.get("adf_mrad"):
        out["adf"] = plain.adf_image(
            [collected[i] for i in range(n_probes)],
            probe_positions(cell.traffic, cell.config["box_A"]))
    return out


def compare(got: dict, want: dict) -> dict:
    keys = sorted(want["planes"])
    if set(got["planes"]) != set(keys):
        return {"exit_waves": float("inf")}
    values = {
        "exit_waves": rel_l2([got["planes"][k] for k in keys],
                             [want["planes"][k] for k in keys]),
        "spectrum": rel_l2([got["spectrum"]], [want["spectrum"]]),
        "diffraction": rel_l2([got["diffraction"]], [want["diffraction"]])}
    if "adf" in want:
        values["adf"] = rel_l2([got["adf"]], [want["adf"]])
    return values
