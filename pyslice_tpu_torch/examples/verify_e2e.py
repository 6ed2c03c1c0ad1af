#!/usr/bin/env python
"""End-to-end verification drive for the port.

    python -m pyslice_tpu_torch.examples.verify_e2e [--device cuda|cpu]

Runs the public-API pipeline on the card (``--device cpu``: the CPU) and
checks physics invariants and error paths: a plane wave through vacuum is
the identity, defocus +d then -d is the identity, norm is conserved, the
TACAW and HAADF pipelines, the error paths, the 4D-STEM detectors and
frozen phonons, HRTEM and IWFR, the kernel path against the plain path
(on the card), the adjoint's gradient (the total intensity's gradient is
0 for any potential) and the frame-cache resume (bit-identical). Prints
``ALL OK`` on success and stops at the first failure.
"""

import argparse
import tempfile

import numpy as np
import torch

import pyslice_tpu_torch as pt
from ._fixtures import add_device_flag, device, displaced, generator


def check(name, ok, detail=""):
    status = "ok" if ok else "FAIL"
    print(f"  [{status}] {name} {detail}")
    if not ok:
        raise SystemExit(f"FAILED: {name} {detail}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = device(args.device)
    print("device:", dev, torch.cuda.get_device_name(dev)
          if dev.type == "cuda" else "")

    # --- vacuum identity --------------------------------------------------
    types = np.array([5])
    pos = np.array([[[100.0, 100.0, 100.0]]])          # atom outside the box
    traj = pt.Trajectory(types, pos, np.zeros_like(pos),
                         np.diag([4.0, 4.0, 3.0]), 0.005)
    g = pt.grid_from_trajectory(traj, sampling=0.25, slice_thickness=1.0)
    probe = pt.Probe(g.xs, g.ys, 0, 100e3, device=dev)
    potential = pt.Potential(g.xs, g.ys, g.zs, pos[0], types, device=dev)
    ew = pt.Propagate(probe, potential).cpu().numpy()
    dev_ = float(np.abs(ew - 1.0).max())
    # the single-precision accuracy bar of the JAX drive
    check("plane wave through vacuum is identity", dev_ < 1e-4,
          f"(max dev {dev_:.2e})")

    # --- defocus roundtrip --------------------------------------------------
    p2 = pt.Probe(g.xs, g.ys, 10, 100e3, device=dev)
    before = p2.to_cpu()
    p2.defocus(50.0)
    p2.defocus(-50.0)
    dev_ = float(np.abs(p2.to_cpu() - before).max())
    check("defocus(+d) o defocus(-d) == id", dev_ < 1e-6,
          f"(max dev {dev_:.2e})")

    # --- norm conservation ----------------------------------------------------
    types3 = np.array([5, 7])
    pos3 = np.array([[[1.0, 1.0, 1.0], [2.0, 2.0, 2.0]]])
    pot3 = pt.Potential(g.xs, g.ys, g.zs, pos3[0], types3, device=dev)
    ew3 = pt.Propagate(p2, pot3).cpu().numpy()
    n_in = float(np.sum(np.abs(p2.to_cpu()) ** 2))
    n_out = float(np.sum(np.abs(ew3) ** 2))
    rel = abs(n_out - n_in) / n_in
    check("norm conserved through propagation", rel < 1e-4,
          f"(rel dev {rel:.2e})")

    # --- full pipeline: TACAW ----------------------------------------------------
    t3 = pt.Trajectory(types3, pos3, np.zeros_like(pos3),
                       np.diag([4.0, 4.0, 3.0]), 0.005)
    traj5 = displaced(t3, 4, 0.02, seed=1)
    calc = pt.MultisliceCalculator(device=dev)
    calc.setup(traj5, sampling=0.25, slice_thickness=1.0, use_cache=False)
    wf = calc.run(progress=False)
    tac = pt.TACAWData(wf)
    check("TACAW pipeline shapes",
          tac.intensity.shape == (1, 4, g.nx, g.ny)
          and tac.spectrum(None).shape == (4,)
          and tac.diffraction(None).shape == (g.nx, g.ny))

    # --- error paths ------------------------------------------------------------
    for name, fn in [
        ("bad positions shape", lambda: pt.Trajectory(
            types, np.zeros((1, 1, 2)), np.zeros((1, 1, 3)), np.eye(3), 1.0)),
        ("empty frame_indices", lambda: t3.slice_timesteps([])),
        ("probe index range", lambda: tac.spectrum(5)),
        ("mask shape", lambda: tac.masked_spectrum(np.ones((3, 3)))),
    ]:
        try:
            fn()
            check(f"error path: {name}", False, "(no error raised)")
        except ValueError:
            check(f"error path: {name}", True)
    check("Tl reachable (ref bug #2 fixed)", pt.getZfromElementName("Tl") == 81)

    # --- HAADF ----------------------------------------------------------------
    pg = pt.probe_grid([1, 3], [1, 3], 3, 3)
    calc2 = pt.MultisliceCalculator(device=dev)
    calc2.setup(traj5.slice_timesteps([0, 1, 2]), aperture=30,
                voltage_eV=100e3, sampling=0.25, slice_thickness=1.0,
                probe_positions=pg, use_cache=False)
    adf = pt.HAADFData(calc2.run(progress=False)).ADF(collection_angle=45)
    check("HAADF ADF", adf.shape == (3, 3) and np.all(np.isfinite(adf)))

    # --- 4D-STEM detectors + frozen phonon -----------------------------------
    from ..analysis import detectors
    wf3 = calc2.run(progress=False)
    lam = wf3.probe.wavelength
    mask = detectors.annular_mask(wf3.kxs, wf3.kys, lam, inner_mrad=45.0)
    vi = detectors.virtual_image(wf3, mask, intensity=False)
    ref_adf = pt.HAADFData(wf3).calculateADF(collection_angle=45)
    check("virtual_image == calculateADF",
          np.allclose(vi, ref_adf, rtol=1e-6), "")
    segs = detectors.segmented_mask(wf3.kxs, wf3.kys, lam, 5.0, 60.0, 4)
    com = detectors.center_of_mass(wf3)
    check("segmented masks + DPC center-of-mass",
          segs.shape[0] == 4 and com.shape[0] == 2
          and np.all(np.isfinite(com)))
    from ..engine.thermal import frozen_phonon_diffraction
    patt = frozen_phonon_diffraction(traj5, n_configs=2, sigma=0.05,
                                     generator=generator(0),
                                     voltage_eV=100e3, sampling=0.25,
                                     slice_thickness=1.0, device=dev)
    check("frozen-phonon diffraction", np.all(np.isfinite(patt))
          and float(patt.sum()) > 0)

    # --- HRTEM/CTEM imaging ---------------------------------------------------
    from ..engine.ctem import hrtem_image, image_from_exit_wave
    img, hx, hy = hrtem_image(traj5, n_configs=2, thermal_sigma=0.05,
                              generator=generator(0), sampling=0.25,
                              slice_thickness=1.0, defocus=-300.0, Cc=1.0e7,
                              dE=0.5, n_nodes=3, device=dev)
    check("HRTEM image (thermal x chromatic)",
          img.shape == (len(hx), len(hy)) and np.all(np.isfinite(img))
          and float(img.min()) >= 0 and float(img.std()) > 0)
    rng = np.random.default_rng(0)
    psi = rng.normal(size=(32, 32)) + 1j * rng.normal(size=(32, 32))
    kx32 = np.fft.fftfreq(32, 0.2)
    ident = image_from_exit_wave(torch.as_tensor(psi, device=dev), kx32,
                                 kx32, lam=lam).cpu().numpy()
    dev_ = float(np.max(np.abs(ident - np.abs(psi) ** 2)))
    check("CTEM identity lens == |psi|^2", dev_ < 1e-3,
          f"(max dev {dev_:.2e})")

    # --- focal-series exit-wave reconstruction (IWFR) -----------------------
    from ..analysis.ewr import iwfr_reconstruct
    from ..engine.ctem import focal_series
    env = np.exp(-(kx32[:, None] ** 2 + kx32[None, :] ** 2) / (2 * 0.4 ** 2))
    ph = np.real(np.fft.ifft2(np.fft.fft2(rng.normal(size=(32, 32))) * env))
    psi_s = np.exp(1j * 0.4 * ph / ph.std())
    defoci = np.array([-300.0, -150.0, 0.0, 150.0, 300.0])
    fs = focal_series(psi_s, defoci, kx32, kx32, lam=lam, device=dev)
    rec, errs = iwfr_reconstruct(fs, defoci, kx32, kx32, lam=lam,
                                 n_iters=150)
    rec_al = rec * np.exp(1j * np.angle(np.vdot(rec, psi_s)))
    rel = float(np.linalg.norm(rec_al - psi_s) / np.linalg.norm(psi_s))
    check("IWFR exit-wave reconstruction", rel < 1e-2 and errs[-1] < 1e-6,
          f"(wave rel {rel:.2e}, residual {float(errs[-1]):.2e})")

    # --- the kernel path against the plain path (the card only) ------------
    if dev.type == "cuda":
        from ..core.grids import grid_from_box
        from ..engine.pipeline import SimSpec, frame_exit_waves
        from ..ops import config as ops_config
        from ..physics.potential import make_plan

        g2 = grid_from_box(25.55, 25.55, 6.0, 0.1, 1.5)   # 256 x 256 x 5
        assert g2.nx == 256 and g2.ny == 256, (g2.nx, g2.ny)
        rng2 = np.random.default_rng(0)
        pos2 = rng2.random((1, 40, 3)) * np.array([25.0, 25.0, 5.9])
        types2 = rng2.integers(1, 15, 40).astype(np.int32)
        plan2 = make_plan(g2.xs, g2.ys, g2.zs, pos2, types2)
        spec2 = SimSpec.create(g2, plan2, 100e3)
        probe2 = pt.Probe(g2.xs, g2.ys, 20, 100e3, device=dev)
        probes2 = pt.create_batched_probes(probe2,
                                           [(5.0, 5.0), (9.0, 3.0)]).array
        outs, saved = {}, ops_config.fused_multislice
        try:
            for mode in ("auto", "off"):
                ops_config.fused_multislice = mode
                outs[mode] = frame_exit_waves(pos2[0], probes2,
                                              spec2).cpu().numpy()
        finally:
            ops_config.fused_multislice = saved     # the caller's setting
        f = np.abs(outs["auto"])
        d = np.abs(outs["off"])
        res = float(((f - d) ** 2).sum() / (f ** 2).sum())
        check("kernel path == plain path (e2e frame)", res < 1e-6,
              f"(residual {res:.2e})")

    # --- differentiable multislice (O(1) adjoint) ---------------------------
    rngj = np.random.default_rng(11)
    nxj = nyj = 128
    nzj = 4
    psij = torch.as_tensor((rngj.normal(size=(2, nxj, nyj))
                            + 1j * rngj.normal(size=(2, nxj, nyj))
                            ).astype(np.complex64), device=dev)
    vj = torch.as_tensor((rngj.normal(size=(nzj, nxj, nyj)) * 30
                          ).astype(np.float32), device=dev)
    kxj = np.fft.fftfreq(nxj, 0.1).astype(np.float32)
    kyj = np.fft.fftfreq(nyj, 0.1).astype(np.float32)
    wj = torch.as_tensor(rngj.random((nxj, nyj)).astype(np.float32),
                         device=dev)

    def exit_of(pot):
        return pt.multislice_diff(psij, pot, kxj, kyj, eV=100e3, dz=0.8)

    v_a = vj.clone().requires_grad_(True)
    gj, = torch.autograd.grad(
        (wj * torch.fft.fft2(exit_of(v_a)).abs() ** 2).mean(), v_a)
    v_b = vj.clone().requires_grad_(True)
    gn, = torch.autograd.grad((exit_of(v_b).abs() ** 2).sum(), v_b)
    g_mag = float(gj.abs().max())
    # unitarity invariant: d/dV total intensity == 0 for ANY V
    n_mag = float(gn.abs().max())
    check("adjoint gradient live + unitarity invariant",
          g_mag > 0 and n_mag < 1e-4 * g_mag,
          f"(|g| {g_mag:.2e}, |d norm/dV| {n_mag:.2e})")

    # --- cache resume -------------------------------------------------------------
    with tempfile.TemporaryDirectory() as d:
        c2 = pt.MultisliceCalculator(device=dev)
        c2.setup(traj5, sampling=0.25, slice_thickness=1.0, cache_root=d)
        a = c2.run(progress=False)
        c3 = pt.MultisliceCalculator(device=dev)
        c3.setup(traj5, sampling=0.25, slice_thickness=1.0, cache_root=d)
        b = c3.run(progress=False)
        check("frame-cache resume identical",
              np.array_equal(a.wavefunction_data, b.wavefunction_data))

    print("ALL OK")


if __name__ == "__main__":
    main()
