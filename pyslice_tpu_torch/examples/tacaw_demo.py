#!/usr/bin/env python
"""End-to-end TACAW + HAADF demo on the port: the reference ``main.py``
workflow through ``pyslice_tpu_torch``.

Loads a trajectory (or generates a synthetic hBN one when no file is given),
runs the plane-wave TACAW production path with the exit waves kept on the
device, writes spectrum / diffraction / spectral-diffraction / dispersion
plots and arrays, then a convergent-beam HAADF scan. Plots degrade to .npy
dumps when matplotlib is unavailable.

Usage:
    python -m pyslice_tpu_torch.examples.tacaw_demo [trajectory-file]
        [--frames N] [--out DIR] [--sampling A] [--no-haadf]
        [--device cuda|cpu]
"""

import argparse
import time
from pathlib import Path

import numpy as np

import pyslice_tpu_torch as pt
from ._fixtures import add_device_flag, device, displaced


def synthetic_trajectory(n_frames=64):
    """4x3 orthorhombic hBN supercell with synthetic thermal motion."""
    a, by, lz = 2.504, 2.504 * np.sqrt(3.0), 6.784
    base = np.array([[0.0, 0.0, lz / 4], [a / 2, by / 6, lz / 4],
                     [a / 2, by / 2, lz / 4], [0.0, by / 2 + by / 6, lz / 4]])
    cells = [base + np.array([i * a, j * by, 0.0])
             for i in range(4) for j in range(3)]
    pos = np.concatenate(cells)[None]
    types = np.tile(np.array([5, 7, 5, 7], np.int32), 12)
    traj = pt.Trajectory(types, pos, np.zeros_like(pos),
                         np.diag([4 * a, 3 * by, lz]), 0.005)
    return displaced(traj, n_frames, 0.05, seed=0)


def save_plot(out_dir, name, fn):
    try:
        import matplotlib
        matplotlib.use("Agg")
        fn(out_dir / f"{name}.png")
        print(f"  wrote {name}.png")
    except ImportError:
        print(f"  (matplotlib unavailable; skipped {name}.png)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("trajectory", nargs="?", default=None)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--out", default="demo_results")
    ap.add_argument("--sampling", type=float, default=0.15)
    ap.add_argument("--slice-thickness", type=float, default=0.5)
    ap.add_argument("--no-haadf", action="store_true")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = device(args.device)

    out_dir = Path(args.out)
    out_dir.mkdir(exist_ok=True)

    if args.trajectory:
        print(f"Loading {args.trajectory} ...")
        traj = pt.TrajectoryLoader(args.trajectory, timestep=0.005,
                                   atom_mapping={1: "B", 2: "N"}).load()
    else:
        print("No trajectory given — generating synthetic hBN.")
        traj = synthetic_trajectory(args.frames)
    if traj.n_frames > args.frames:
        traj = traj.slice_timesteps(list(range(args.frames)))
    print(f"{traj.n_frames} frames, {traj.n_atoms} atoms")

    # --- TACAW: plane wave, center probe ------------------------------------
    t0 = time.time()
    calc = pt.MultisliceCalculator(device=dev)
    # device_output keeps the exit waves on the device; the TACAW analysis
    # below reduces them there (its methods return host arrays).
    calc.setup(traj, aperture=0.0, voltage_eV=100e3,
               slice_thickness=args.slice_thickness, sampling=args.sampling,
               use_cache=False, device_output=True)
    wf = calc.run()
    print(f"Simulation: {time.time() - t0:.1f}s "
          f"(grid {calc.nx}x{calc.ny}x{calc.nz})")

    tacaw = pt.TACAWData(wf)
    spectrum = tacaw.spectrum(probe_index=0)
    diffraction = tacaw.diffraction(probe_index=0)
    np.save(out_dir / "frequencies.npy", tacaw.frequencies)
    np.save(out_dir / "spectrum.npy", spectrum)
    np.save(out_dir / "diffraction.npy", diffraction)

    def plot_spectrum(path):
        import matplotlib.pyplot as plt
        pos = tacaw.frequencies >= 0
        fig, ax = plt.subplots(figsize=(10, 6))
        ax.plot(tacaw.frequencies[pos], spectrum[pos], "b-", lw=2)
        ax.fill_between(tacaw.frequencies[pos], spectrum[pos], alpha=0.3)
        ax.set_xlabel("Frequency (THz)")
        ax.set_ylabel("Intensity")
        ax.set_title("TACAW Frequency Spectrum")
        fig.savefig(path, dpi=200)
        plt.close(fig)
    save_plot(out_dir, "spectrum", plot_spectrum)

    kxs, kys = np.asarray(wf.kxs), np.asarray(wf.kys)

    def plot_diffraction(path):
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(8, 8))
        ax.imshow(diffraction.T ** 0.25,
                  extent=[kxs.min(), kxs.max(), kys.min(), kys.max()],
                  origin="lower", cmap="inferno")
        ax.set_xlabel("kx (1/A)")
        ax.set_ylabel("ky (1/A)")
        ax.set_title("Diffraction (summed over frequency)")
        fig.savefig(path, dpi=200)
        plt.close(fig)
    save_plot(out_dir, "diffraction", plot_diffraction)

    spec_diff = tacaw.spectral_diffraction(frequency=35, probe_index=0)
    np.save(out_dir / "spectral_diff.npy", spec_diff)

    kx_path = np.linspace(0, 6, 300)
    disp = tacaw.dispersion(kx_path, np.zeros_like(kx_path), probe_index=0)
    np.save(out_dir / "dispersion.npy", disp)

    def plot_dispersion(path):
        import matplotlib.pyplot as plt
        pos = tacaw.frequencies > 0
        fig, ax = plt.subplots(figsize=(10, 6))
        ax.imshow(disp[pos] ** 0.25, aspect="auto", origin="lower",
                  cmap="inferno",
                  extent=[0, 6, tacaw.frequencies[pos].min(),
                          tacaw.frequencies[pos].max()])
        ax.set_xlabel("kx (1/A)")
        ax.set_ylabel("Frequency (THz)")
        ax.set_title("Phonon dispersion along kx")
        fig.savefig(path, dpi=200)
        plt.close(fig)
    save_plot(out_dir, "dispersion", plot_dispersion)
    del wf, tacaw

    # --- HAADF: convergent beam scan -----------------------------------------
    if not args.no_haadf:
        print("HAADF scan ...")
        a = traj.box_matrix[0, 0] / 4
        b = traj.box_matrix[1, 1] / 3
        n_haadf_frames = min(3, traj.n_frames)
        haadf_traj = traj.slice_timesteps(list(range(n_haadf_frames)))
        pg = pt.probe_grid([0, a], [0, b], 10, 10)
        hc = pt.MultisliceCalculator(device=dev)
        hc.setup(haadf_traj, aperture=30.0, voltage_eV=100e3,
                 slice_thickness=args.slice_thickness,
                 sampling=args.sampling, probe_positions=pg, use_cache=False)
        t0 = time.time()
        haadf = pt.HAADFData(hc.run())
        image = haadf.ADF(collection_angle=45)
        print(f"HAADF: {time.time() - t0:.1f}s, image {image.shape}")
        np.save(out_dir / "haadf_image.npy", image)

        def plot_haadf(path):
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots(figsize=(8, 8))
            ax.imshow(image.T, cmap="inferno", origin="lower")
            ax.set_title("HAADF-STEM")
            fig.savefig(path, dpi=200)
            plt.close(fig)
        save_plot(out_dir, "haadf", plot_haadf)

    print(f"Results in {out_dir}/")


if __name__ == "__main__":
    main()
