#!/usr/bin/env python
"""Calibrating a measured 4D-STEM datacube before reconstruction, on the
port.

Real data carries instrument artifacts a simulation never has: a camera
mounted at an unknown azimuth (possibly with swapped axes), beam descan
drifting the patterns across the detector, stuck hot/dead pixels, and an
unknown dose. This demo simulates a cube with the production multislice
pipeline, corrupts it with all four, then recovers everything with
``pt.calibrate_datacube`` (on the cube's device) and shows the iCoM phase
of the calibrated data matching the clean reconstruction:

  1. hot/dead pixels found from scan statistics and repaired,
  2. sub-pixel linear descan fitted (and removed losslessly at the
     CoM-field level),
  3. the scan<->detector rotation solved in closed form from the
     deflection field's curl (the ``icom_reconstruct`` diagnostic, turned
     into a calibration),
  4. dose estimated from total counts.

    python -m pyslice_tpu_torch.examples.experimental_calibration
        [--scan N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ._fixtures import add_device_flag, device, hbn_monolayer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scan", type=int, default=24, help="scan points/axis")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = device(args.device)

    import pyslice_tpu_torch as pt
    from ..analysis import calibration as cal
    from ..analysis.ptychography import icom_reconstruct, scan_grid_data

    # --- simulate a "measured" cube ---------------------------------------
    traj = hbn_monolayer(2, 2)
    box = np.asarray(traj.box_matrix)
    n_s = args.scan
    pg = pt.probe_grid([0.0, box[0, 0]], [0.0, box[1, 1]], n_s, n_s)
    calc = pt.MultisliceCalculator(device=dev)
    calc.setup(traj, aperture=25, voltage_eV=100e3, sampling=0.25,
               slice_thickness=3.5, probe_positions=pg.tolist(),
               use_cache=False, device_output=True)
    wf = calc.run(progress=False)
    xs, ys, raw = scan_grid_data(wf)

    # detector PSF (symmetric -> CoM preserved), then the artifacts
    nkx, nky = raw.shape[-2:]
    fx = np.fft.fftfreq(nkx)[:, None]
    fy = np.fft.fftfreq(nky)[None, :]
    clean = np.clip(np.real(np.fft.ifft2(
        np.fft.fft2(raw) * np.exp(-2 * np.pi ** 2 * 1.2 ** 2
                                  * (fx ** 2 + fy ** 2)))), 0, None)
    ref = icom_reconstruct(clean, xs, ys, wf.kxs, wf.kys, probe=wf.probe,
                           device=dev)

    inject = np.array([[0.1, -0.06, 0.04], [-0.08, 0.05, 0.06]])
    cube = cal.apply_descan(clean, inject, xs, ys, 1.0, subpixel=True,
                            device=dev)
    theta_true = np.radians(14.0)
    # rotate the cube's deflections by mounting the "camera" rotated:
    # emulated at the field level downstream; pattern-level we corrupt
    # with descan + defects (a rotation of sharp pixels would interpolate)
    cube[:, :, nkx // 3, nky // 4] = cube.max() * 40     # hot pixel
    cube[:, :, 2 * nkx // 3, nky // 2] = 0.0             # dead pixel

    # --- calibrate ----------------------------------------------------------
    res = cal.calibrate_datacube(cube, xs, ys, kxs=wf.kxs, kys=wf.kys,
                                 subpixel_descan=True, device=dev)
    print("calibration report:")
    for line in res["report"]:
        print("  -", line)

    # rotation solve demo on a synthetically rotated field
    rot_field = cal.apply_rotation(res["com"], -theta_true, device=dev)
    sol = cal.solve_rotation(rot_field,
                             float(xs[1] - xs[0]), float(ys[1] - ys[0]),
                             device=dev)
    print(f"injected camera rotation {np.degrees(theta_true):.1f} deg -> "
          f"solved {np.degrees(sol['theta']):.2f} deg "
          f"(transpose={sol['transpose']}, "
          f"curl {sol['curl_rms_raw']:.3f} -> {sol['curl_rms']:.3f})")

    got = icom_reconstruct(None, xs, ys, wf.kxs, wf.kys, probe=wf.probe,
                           com=res["com"], device=dev)
    err = np.abs(got["phase"] - ref["phase"]).max() \
        / np.abs(ref["phase"]).max()
    print(f"iCoM phase: calibrated vs clean max deviation {err:.3f} "
          f"(curl diagnostic {got['curl_rms']:.3f} vs clean "
          f"{ref['curl_rms']:.3f})")


if __name__ == "__main__":
    main()
