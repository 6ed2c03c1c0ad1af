"""Closed loop of Adam steps of one multislice-ptychography solve.

Set-up (``warm``): the 4D-STEM data of the configuration's scan, the
|psi_hat|^2 of one thermal frame (drawn from the seed) at every scan
position, fftshifted as ``WFData`` lays it out, made on the device by
``MultisliceCalculator`` a chunk of positions at a time into one device
tensor; ``_msp_setup`` (what ``msp_reconstruct`` calls first) ingests it
there, and one step warms every shape. A step is ``_MspRun.step`` on the
next minibatch of ``_epoch_batches`` (the loop body of
``msp_reconstruct``), back to back on the one solve: shuffled epochs over
the scan, the potential, the probe modes and the positions refined.

The check: at one step drawn from the seed among the window's first
``check_steps``, the state before it (V, the modes, the positions, the
Adam moments, the minibatch's fftshifted intensities as the data holds
them) and, after it, the parameters and Adam's first moments are kept.
The step's own gradient of each parameter comes from its first moment,
g = (mu_after - b1 mu_before) / (1 - b1), so every number read is the
timed step's. The plain reference (``reference/msp.py``) makes its own
amplitudes from the intensities and takes the same step from the kept
state. Each number is a relative error against the reference's: the
minibatch ``loss``, and for V, the probe modes and the positions the
gradient (``grad_<name>``) and the step's change (``update_<name>``).
The cell's limits name the ones compared. Under ``--control`` (no
window) the state kept is the one after the warm step.
"""

from __future__ import annotations

import sys

import numpy as np

import inputs
from common import host, ref_grid, rel_l2, scan
from reference import msp as ref_msp

REFINED = ("v", "modes", "pos")


def slice_loop_shape(cell):
    """(3 K, nx, ny, nz): the slice work of one pattern a step, K probe
    modes. The forward takes K waves through the slices and the adjoint
    2 K (each wave and its gradient); ``roofline.slice_loop_work`` counts
    2 nz - 1 = 27 transforms a wave where the slice-loop layer runs 26 (the
    forward's last k-space transform is the misfit's, in the inverse
    layer), so 81 a mode against 78: the least time is counted 3.8% high."""
    g = ref_grid(cell.config)
    return 3 * cell.config["n_modes"], g.nx, g.ny, g.nz


def _wide(t) -> np.ndarray:
    """A tensor on the host in float64 or complex128."""
    a = host(t)
    return a.astype(np.complex128 if np.iscomplexobj(a) else np.float64)


def _launches() -> dict:
    from pyslice_tpu_torch.ops import fused_step
    return dict(fused_step.launches)


class Driver:

    def __init__(self, run):
        import torch
        self.torch = torch
        self.run, self.cfg, self.tr = run, run.config, run.traffic
        self.positions = scan(self.tr["probe_grid"])
        pick = inputs.generator(run.seed, inputs.SAMPLE)
        self.check_step = 1 + int(pick.integers(self.tr["check_steps"]))
        self.steps = 0            # steps since the warm step
        self.drawn = 0            # minibatches drawn
        self.msp = self.batches = None
        self.kept = self.after = self.loss = None
        self.rows = self.raw = None
        self.launches0 = {}

    def _data(self):
        """((npos, nx, ny) float32 intensities on the device, the last
        chunk's calculator)."""
        import pyslice_tpu_torch as pt
        torch, cfg, run = self.torch, self.cfg, self.run
        base, types = inputs.hbn_box(cfg["box_A"], cfg["layer_z_A"])
        frame = inputs.thermal_frames(base, 1, cfg["thermal_sigma_A"],
                                      run.seed, inputs.JOB, 0)
        traj = pt.Trajectory(atom_types=types, positions=frame,
                             velocities=np.zeros_like(frame),
                             box_matrix=np.diag([cfg["box_A"], cfg["box_A"],
                                                 cfg["box_height_A"]]),
                             timestep=cfg["timestep_ps"])
        chunk, n = self.tr["data_chunk"], len(self.positions)
        data = None
        for i in range(0, n, chunk):
            calc = pt.MultisliceCalculator(device=run.device)
            calc.setup(traj, aperture=cfg["aperture_mrad"],
                       voltage_eV=cfg["voltage_eV"],
                       slice_thickness=cfg["slice_thickness_A"],
                       sampling=cfg["sampling_A"],
                       probe_positions=self.positions[i:i + chunk].tolist(),
                       device_output=True, use_cache=False)
            waves = calc.run(progress=False).wavefunction_data
            inten = waves[:, 0, :, :, 0].abs() ** 2
            if data is None:
                data = torch.empty((n,) + tuple(inten.shape[1:]),
                                   dtype=inten.dtype, device=run.device)
            data[i:i + chunk] = inten
            del waves, inten
        return data, calc

    def warm(self):
        from pyslice_tpu_torch.analysis import ptychography as ptycho
        cfg, tr, run = self.cfg, self.tr, self.run
        data, calc = self._data()
        with run.spans("msp_setup"):
            self.msp, self.batches = ptycho._msp_setup(
                data, self.positions, calc.base_probe, calc.nz,
                calc.spec.dz, steps=tr["schedule_steps"], batch=tr["batch"],
                lr=cfg["lr_v"], lr_probe=cfg["lr_probe"],
                lr_pos=cfg["lr_pos"], update_probe=cfg["update_probe"],
                update_positions=cfg["update_positions"],
                seed=run.seed % 2 ** 63, n_modes=cfg["n_modes"],
                loss=cfg["loss"])
        self._keep_rows(data)
        del data, calc
        self.msp.step(self.prepare())
        self.keep(self.batches[self.drawn % len(self.batches)])
        self.launches0 = _launches()

    def prepare(self):
        idx = self.batches[self.drawn % len(self.batches)]
        self.drawn += 1
        return idx

    def _keep_rows(self, data):
        """The data's rows of the minibatches a check can take (the
        control's, the first after the warm step, and the window's
        ``check_step``), copied to the host as the data holds them."""
        picks = [self.batches[i % len(self.batches)]
                 for i in (1, self.check_step)]
        self.rows = np.unique(np.concatenate(picks))
        at = self.torch.as_tensor(self.rows, device=data.device)
        self.raw = host(data[at])

    def keep(self, idx):
        """The state before a step on minibatch ``idx``, on the device;
        the minibatch's intensities are gathered on the host after the
        window (``_gather``), so that the step keeps no host work."""
        m = self.msp
        self.kept = {
            "idx": np.asarray(idx), "inten": None,
            **{k: getattr(m, k).detach().clone() for k in REFINED},
            "b1": {k: a.b1 for k, a in m.adam.items()},
            "moments": {k: (None if a.mu is None else a.mu.clone(),
                            None if a.nu is None else a.nu.clone(),
                            a.count) for k, a in m.adam.items()}}

    def step(self, idx) -> int:
        self.steps += 1
        check = self.steps == self.check_step
        if check:
            self.keep(idx)
        loss = self.msp.step(idx)
        if check:
            self.loss = loss
            self.after = {k: (getattr(self.msp, k).detach().clone(),
                              None if a.mu is None else a.mu.clone())
                          for k, a in self.msp.adam.items()}
        return len(idx)

    def drain(self):
        """Prints the kernel launches a step since the warm step: the
        forward on K4/K5 and the adjoint on K8 + K5 take fixed counts a
        step, and a plain fallback launches none."""
        now = _launches()
        per = {k: (now[k] - self.launches0.get(k, 0)) / max(self.steps, 1)
               for k in ("k4", "k5", "k8", "a", "b", "k7")
               if k in now}
        print(f"msp: {self.steps} steps after the warm step; launches a "
              f"step {per}", file=sys.stderr)

    def counters(self) -> dict:
        """``ptychography.STATS`` (empty on a program without it)."""
        from pyslice_tpu_torch.analysis import ptychography as ptycho
        return {k: float(v) for k, v in getattr(ptycho, "STATS", {}).items()}

    def outputs(self) -> dict:
        """The kept step's loss, and each refined parameter's gradient
        (from Adam's first moment before and after the step) and
        change."""
        k = self.kept
        out = {"loss": float(self.loss)}
        for name, (param, mu) in self.after.items():
            mu0, b1 = k["moments"][name][0], k["b1"][name]
            before = 0.0 if mu0 is None else _wide(mu0)
            if mu is not None:      # else no moment: the number is missing
                out["grad_" + name] = (_wide(mu) - b1 * before) / (1.0 - b1)
            out["update_" + name] = _wide(param) - _wide(k[name])
        return out

    def _gather(self):
        """The kept minibatch's rows of the data, from the host copy."""
        k = self.kept
        if k["inten"] is None:
            at = np.searchsorted(self.rows, k["idx"])
            assert np.array_equal(self.rows[at], k["idx"]), "rows not kept"
            k["inten"] = self.raw[at]

    def release(self):
        """The data and the solve's state go; the kept state stays for the
        reference."""
        self._gather()
        self.msp = self.batches = self.after = self.raw = None

    def reference(self, prec) -> dict:
        self._gather()
        cfg = self.cfg
        lrs = {"v": cfg["lr_v"], "modes": cfg["lr_probe"],
               "pos": cfg["lr_pos"]}
        return ref_msp.step(self.kept, ref_grid(cfg), cfg["voltage_eV"], lrs,
                            prec, self.run.device, self.tr["check_block"])


def combine_outputs(parts: list) -> dict:
    return parts[0]


def combine_reference(parts: list, cell) -> dict:
    return parts[0]


def compare(got: dict, want: dict) -> dict:
    values = {"loss": abs(got["loss"] - want["loss"]) / abs(want["loss"])}
    for name in REFINED:
        for key in ("update_" + name, "grad_" + name):
            if key in want:
                values[key] = rel_l2([got[key]], [want[key]]) \
                    if key in got else float("inf")
    return values
