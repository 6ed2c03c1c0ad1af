# %% [markdown]
# # pyslice_tpu_torch walkthrough
#
# A guided tour of the PyTorch / CUDA port, mirroring the reference's
# `example.ipynb` (37-cell notebook): load a trajectory, build a potential,
# build and play with probes, propagate, batch probes, run the production
# calculator, and analyze (TACAW spectra / spectrum images / HAADF).
#
# Run as a script (`python -m pyslice_tpu_torch.examples.walkthrough
# [--device cuda|cpu]`) or open in Jupyter / VS Code (percent-format
# cells). The matching `walkthrough.ipynb` is generated by
# `python -m pyslice_tpu_torch.examples.make_notebook`. Everything runs on
# `DEVICE`: the card by default, the CPU with `--device cpu`.

# %%
import argparse

import numpy as np
import torch

import pyslice_tpu_torch as pt
from pyslice_tpu_torch.examples._fixtures import add_device_flag, device

_ap = argparse.ArgumentParser()
add_device_flag(_ap)
DEVICE = device(_ap.parse_known_args()[0].device)
print("device:", DEVICE)

# %% [markdown]
# ## 1. Load (or synthesize) a trajectory
#
# `TrajectoryLoader` reads LAMMPS dumps (native C++ fast path with a pure
# NumPy fallback), extended XYZ, and CIF. Here we synthesize an hBN
# monolayer and give it thermal motion: uniform displacements drawn with
# NumPy from seed 0, the draw of the JAX package's
# `generate_random_displacements(32, 0.05, seed=0)` (the port's own takes
# a `torch.Generator`).

# %%
from pyslice_tpu_torch.examples._fixtures import displaced, generator

a, by, lz = 2.504, 2.504 * np.sqrt(3.0), 6.784
cell = np.array([[0.0, 0.0, lz / 4], [a / 2, by / 6, lz / 4],
                 [a / 2, by / 2, lz / 4], [0.0, by / 2 + by / 6, lz / 4]])
cells = [cell + [i * a, j * by, 0.0] for i in range(3) for j in range(2)]
pos = np.concatenate(cells)[None]
types = np.tile(np.array([5, 7, 5, 7], np.int32), 6)

static = pt.Trajectory(types, pos, np.zeros_like(pos),
                       np.diag([3 * a, 2 * by, lz]), timestep=0.005)
traj = displaced(static, 32, 0.05, seed=0)
print(f"{traj.n_frames} frames, {traj.n_atoms} atoms, box "
      f"{np.diag(traj.box_matrix).round(2)}")

# %% [markdown]
# ## 2. Grids
#
# Grid semantics follow the reference exactly: `n = int(l / sampling) + 1`
# points, `endpoint=False`. The classic functional facade is available too.

# %%
xs, ys, zs, lx, ly, _ = pt.gridFromTrajectory(traj, sampling=0.15,
                                              slice_thickness=0.5)
print(f"grid {len(xs)} x {len(ys)} x {len(zs)}")

# %% [markdown]
# ## 3. The probe
#
# `mrad=0` is a plane wave; a finite aperture gives a convergent (Airy)
# probe. `defocus` moves the beam waist (negative back-propagates — the
# reference's sign bug is fixed, CHANGELOG #13).

# %%
probe = pt.Probe(xs, ys, mrad=25, eV=100e3, device=DEVICE)
print("probe", tuple(probe.array.shape), "| wavelength",
      f"{probe.wavelength:.5f} A")
probe.defocus(100.0)
probe.defocus(-100.0)     # exact inverse

# %% [markdown]
# ## 4. The potential
#
# Kirkland form factors rasterized in reciprocal space with sub-pixel atom
# placement (k-space sinusoids): per-(type, slice) structure factors as
# matrix products on the device, planned on the host.

# %%
potential = pt.Potential(xs, ys, zs, traj.positions[0], traj.atom_types,
                         device=DEVICE)
print("potential", tuple(potential.array.shape))   # (nx, ny, n_slices)

# %% [markdown]
# ## 5. Propagate
#
# The multislice loop: transmit each slice (t = exp(i sigma V)), Fresnel-
# propagate between slices. Norm is conserved exactly (|t| = |P| = 1).
# On the card the hand-written CUDA kernels take the slice loop over from
# 128 points a side (a power of two, or radices up to 31); this grid is
# smaller and runs the plain torch.fft loop.

# %%
exit_wave = pt.Propagate(probe, potential).cpu().numpy()
print("exit", exit_wave.shape,
      "| power ratio", (np.abs(exit_wave) ** 2).sum() / (np.abs(probe.to_cpu()) ** 2).sum())

# %% [markdown]
# ## 6. Batched probes
#
# `create_batched_probes` shifts the base probe to each scan position via
# k-space phase ramps (one FFT of the base, not one per probe).

# %%
scan = pt.probe_grid([0, 2 * a], [0, by], 4, 4)
batch = pt.create_batched_probes(probe, scan)
exit_batch = pt.Propagate(batch, potential)
print("batched exits", tuple(exit_batch.shape))

# %% [markdown]
# ## 7. The production calculator
#
# `MultisliceCalculator(device=...).setup()/run()` — the reference's
# signature. Each frame: rasterize -> propagate -> k-space. The frame
# cache makes re-runs resume for free.

# %%
calc = pt.MultisliceCalculator(device=DEVICE)
calc.setup(traj, aperture=0.0, voltage_eV=100e3, slice_thickness=0.5,
           sampling=0.15, use_cache=False)
wf = calc.run(progress=False)
print("WFData", wf.wavefunction_data.shape)   # (probe, time, kx, ky, layer)

# %% [markdown]
# ## 8. TACAW analysis
#
# FFT along *time* -> phonon-resolved intensity. All six reference analysis
# methods, with `probe_index=None` meaning average-over-probes.

# %%
tacaw = pt.TACAWData(wf)
print("frequencies (THz):", tacaw.frequencies[:4], "...")
spectrum = tacaw.spectrum(probe_index=0)
pattern = tacaw.diffraction()
spec_diff = tacaw.spectral_diffraction(frequency=30.0)
disp = tacaw.dispersion(np.linspace(0, 4, 50), np.zeros(50))
print("spectrum", spectrum.shape, "| diffraction", pattern.shape,
      "| dispersion", disp.shape)

# %% [markdown]
# ## 9. Spectrum image (real-space map at one frequency)

# %%
si = tacaw.spectrum_image(frequency=30.0)
print("spectrum image:", si.shape, "(one scalar per probe)")

# %% [markdown]
# ## 10. HAADF-STEM
#
# Convergent-beam scan over a probe grid, annular detector. `ADF` is the
# alias the reference demo expects.

# %%
short = traj.slice_timesteps([0, 1, 2])
hc = pt.MultisliceCalculator(device=DEVICE)
hc.setup(short, aperture=30.0, voltage_eV=100e3, slice_thickness=0.5,
         sampling=0.15, probe_positions=scan, use_cache=False)
haadf = pt.HAADFData(hc.run(progress=False))
image = haadf.ADF(collection_angle=45)
print("HAADF image", image.shape)

# %% [markdown]
# ## 11. Interactive probe explorer (ipywidgets)
#
# The reference's `example.ipynb` exposes aperture/defocus sliders; same
# here. In a live notebook the sliders re-render the probe as you drag;
# headless runs (pytest / CI) fall back to one static render, and skip it
# where matplotlib is not installed.

# %%
def render_probe(mrad=15.0, defocus_A=0.0, log_scale=True):
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    p = pt.Probe(xs, ys, mrad, 100e3, device=DEVICE)
    if defocus_A:
        p.defocus(defocus_A)
    amp = np.abs(p.to_cpu())
    img = amp ** 0.25 if log_scale else amp
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.imshow(img.T, cmap="inferno",
              extent=(xs.min(), xs.max(), ys.min(), ys.max()))
    ax.set_title(f"probe: {mrad:.0f} mrad, defocus {defocus_A:.0f} A")
    return fig


try:
    import ipywidgets as widgets
    from IPython.display import display
    ui = widgets.interactive(
        lambda mrad, defocus_A, log_scale: display(
            render_probe(mrad, defocus_A, log_scale)),
        mrad=widgets.FloatSlider(value=15.0, min=0.0, max=40.0, step=1.0),
        defocus_A=widgets.FloatSlider(value=0.0, min=-500.0, max=500.0,
                                      step=25.0),
        log_scale=widgets.Checkbox(value=True))
    display(ui)
except Exception:   # headless / no widget frontend
    try:
        fig = render_probe(15.0, 100.0)
        print("ipywidgets unavailable - rendered one static probe:",
              fig.get_axes()[0].get_title())
    except ImportError:
        print("ipywidgets and matplotlib unavailable - no probe render")

# %% [markdown]
# ## 12. Interactive spectral diffraction browser

# %%
try:
    import ipywidgets as widgets
    from IPython.display import display

    def show_freq(f_thz):
        import matplotlib.pyplot as plt
        img = tacaw.spectral_diffraction(frequency=f_thz)
        fig, ax = plt.subplots(figsize=(4, 4))
        ax.imshow(np.log10(img.T + 1e-12), cmap="inferno",
                  extent=(tacaw.kxs.min(), tacaw.kxs.max(),
                          tacaw.kys.min(), tacaw.kys.max()))
        ax.set_title(f"|Psi(omega={f_thz:.1f} THz, q)|^2")
        display(fig)

    fmax = float(np.abs(tacaw.frequencies).max())
    display(widgets.interactive(
        show_freq,
        f_thz=widgets.FloatSlider(value=min(30.0, fmax), min=0.0,
                                  max=fmax, step=fmax / 50)))
except Exception:
    print("ipywidgets unavailable - spectral_diffraction(30 THz):",
          tacaw.spectral_diffraction(frequency=30.0).shape)

# %% [markdown]
# ## 13. Scaling out
#
# On several cards, frames x probes shard over a ('frame', 'probe')
# `DeviceMesh` on `torch.distributed`; the TACAW time-FFT reshards
# frame->kx with an all_to_all. See `pyslice_tpu_torch.parallel` and its
# `dryrun`. For runs too large to materialize,
# `pyslice_tpu_torch.engine.streaming` accumulates TACAW/HAADF products
# frame by frame with O(selected outputs) memory.

# %% [markdown]
# ## 14. Beyond the reference surface
#
# Features the original package does not have, each with tests:
#
# * **Probe aberrations to 5th order** — `probe.aberrate(C3=1e7, A1=25)`
#   or `calc.setup(aberrations={"C3": 1e7})`; `aberrate(C1=dz)` is exactly
#   `defocus(dz)` (`pyslice_tpu_torch.physics.aberrations`).
# * **PRISM / S-matrix STEM** — propagate the aperture beam basis once,
#   synthesize thousands of probes as matrix products
#   (`pyslice_tpu_torch.engine.smatrix`; exact at f=1).
# * **Partial coherence** — chromatic defocus series + effective source
#   blur (`pyslice_tpu_torch.engine.coherence`).
# * **Finite dose** — Poisson electron counting
#   (`pyslice_tpu_torch.analysis.detectors.apply_shot_noise`).
# * **Ptychography** — SSB, iCoM/iDPC, and ePIE phase reconstruction from
#   the pipeline's 4D-STEM output
#   (`pyslice_tpu_torch.analysis.ptychography`).
# * **HRTEM/CTEM imaging** — plane-wave illumination + a partially
#   coherent objective lens (`pyslice_tpu_torch.engine.ctem.hrtem_image`).
# * **Exit-wave reconstruction** — IWFR focal-series inversion
#   (`pyslice_tpu_torch.analysis.ewr.iwfr_reconstruct`).
# * **Differentiable multislice** — `pt.multislice_diff`: a
#   `torch.autograd.Function` with an O(1)-memory backward (it
#   reconstructs the wavefield through the unitary chain; on the card,
#   from 128 points a side, hand-written CUDA kernels both directions). On top of it: multislice ptychography
#   (`pt.msp_reconstruct` — joint potential/probe/position descent,
#   mixed-state probes, Poisson + TV), atomic-coordinate refinement
#   (`pt.refine_structure`), and the self-contained demo
#   `pyslice_tpu_torch.examples.inverse_potential`.
# * **Full instrument chain demo** —
#   `pyslice_tpu_torch.examples.realistic_stem`.

# %%
from pyslice_tpu_torch.physics.aberrations import Aberrations
ab = Aberrations(C3=1.0e7)
print("Scherzer defocus at 1 mm Cs:",
      round(ab.scherzer_defocus(probe.wavelength), 1), "A")

# %% [markdown]
# ## 15. Imaging side: HRTEM picture + exit-wave recovery
#
# Form a thermally averaged HRTEM image of the same hBN cell, then play
# experimentalist: record only focal-series INTENSITIES and reconstruct
# the complex exit wave back with IWFR.

# %%
from pyslice_tpu_torch.analysis.ewr import iwfr_reconstruct
from pyslice_tpu_torch.core.grids import grid_from_trajectory
from pyslice_tpu_torch.engine.ctem import focal_series, hrtem_image
from pyslice_tpu_torch.engine.pipeline import SimSpec, frame_exit_waves
from pyslice_tpu_torch.physics.potential import make_plan

img, ixs, iys = hrtem_image(traj, n_configs=2, thermal_sigma=0.05,
                            generator=generator(0), sampling=0.25,
                            defocus=-300.0, Cc=1.0e7, dE=0.5, n_nodes=3,
                            device=DEVICE)
print("HRTEM image:", img.shape, "contrast",
      round(float(img.std() / img.mean()), 4))

# %%
grid_i = grid_from_trajectory(traj, sampling=0.25, slice_thickness=0.5)
plan_i = make_plan(grid_i.xs, grid_i.ys, grid_i.zs, traj.positions[:1],
                   traj.atom_types)
spec_i = SimSpec.create(grid_i, plan_i, 100e3)
# the plane wave, made on the device as a complex tensor
ones = torch.ones((1, grid_i.nx, grid_i.ny), dtype=spec_i.precision.complex,
                  device=DEVICE)
kw = frame_exit_waves(traj.positions[0], ones, spec_i)[0, ..., -1]
psi_true = np.fft.ifft2(np.fft.ifftshift(kw.cpu().numpy()))

defoci = np.array([-320.0, -160.0, 0.0, 160.0, 320.0, 480.0])
stack = focal_series(psi_true, defoci, plan_i.kxs, plan_i.kys,
                     lam=probe.wavelength, device=DEVICE).cpu().numpy()
rec, resid = iwfr_reconstruct(stack, defoci, plan_i.kxs, plan_i.kys,
                              lam=probe.wavelength, n_iters=200,
                              device=DEVICE)
rec *= np.exp(1j * np.angle(np.vdot(rec, psi_true)))   # global phase
rel = np.linalg.norm(rec - psi_true) / np.linalg.norm(psi_true)
print(f"IWFR from {len(defoci)} images: wave error {rel:.2e}, "
      f"final residual {float(resid[-1]):.2e}")

# %% [markdown]
# ## 16. Inverse problems: gradients through the slice loop
#
# `multislice_diff` is a drop-in differentiable `multislice` — the exit
# wave is identical, but `torch.autograd.grad` through it runs the
# O(1)-memory unitary adjoint instead of storing every per-slice
# wavefunction. The unitarity invariant: the total-intensity gradient is
# exactly zero for ANY potential.

# %%
pot_frame = potential.array_szy.detach().clone().requires_grad_(True)
kxs_d = np.asarray(potential.kxs, np.float32)
kys_d = np.asarray(potential.kys, np.float32)
psi0 = probe.array[None]


def total_intensity(v, p):
    out = pt.multislice_diff(p, v, kxs_d, kys_d, eV=100e3, dz=0.5)
    return (out.abs() ** 2).sum()


g, = torch.autograd.grad(total_intensity(pot_frame, psi0), pot_frame)
print("unitarity: |d(total intensity)/dV| =",
      float(g.abs().max()), "(exactly 0 in exact arithmetic)")

# %%
print("done.")
