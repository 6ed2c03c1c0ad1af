"""Diffraction toolkit tour on the port: tilt, precession, Debye-Waller,
band limit.

Composes the illumination and specimen models on a 3-layer hBN stack:

1. axial frozen-phonon diffraction vs a 150 mrad beam tilt
   (tilted-propagator multislice),
2. precession electron diffraction (azimuthal tilt-ring average),
3. static Debye-Waller damping instead of frozen phonons,
4. the antialiasing bandwidth limit (Kirkland's 2/3 convention),
5. PACBED + azimuthal radial profiles of the results.

The thermal ensembles are drawn from a torch.Generator seeded with 0 (the
JAX demo's seed 0 draws from NumPy: the same distribution, other draws).

    python -m pyslice_tpu_torch.examples.diffraction_toolkit
        [--configs N] [--azimuths N] [--device cuda|cpu]
"""

import argparse

import numpy as np

from .. import MultisliceCalculator, precession_diffraction
from ..analysis.detectors import pacbed, radial_profile
from ..engine.thermal import frozen_phonon_diffraction
from ._fixtures import add_device_flag, device, generator, hbn_stack


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", type=int, default=4,
                    help="frozen-phonon configurations per pattern")
    ap.add_argument("--azimuths", type=int, default=8,
                    help="PED azimuthal samples")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = device(args.device)

    def kw():
        return dict(n_configs=args.configs, sigma=0.06,
                    generator=generator(0), voltage_eV=100e3, sampling=0.3,
                    slice_thickness=1.5, device=dev)

    traj = hbn_stack(n_layers=3, nx=2, ny=2)
    print(f"3-layer hBN stack: {traj.n_atoms} atoms, box "
          f"{np.diag(traj.box_matrix).round(2)}")

    # 1. axial vs tilted illumination
    axial = frozen_phonon_diffraction(traj, **kw())
    tilted = frozen_phonon_diffraction(traj, tilt=(150.0, 0.0), **kw())
    rel = np.abs(tilted - axial).max() / axial.max()
    print(f"tilt 150 mrad: max relative pattern change {rel:.2e} "
          "(pure k-space phase - only dynamical scattering responds)")

    # 2. precession quenches the tilt asymmetry back toward the axial
    ped = precession_diffraction(traj, 150.0, n_azimuth=args.azimuths,
                                 **kw())
    print(f"PED ({args.azimuths} azimuths): total intensity conserved to "
          f"{abs(ped.sum() / axial.sum() - 1.0):.1e}")

    # 3. static Debye-Waller model (no thermal ensemble)
    calc = MultisliceCalculator(device=dev)
    calc.setup(traj, aperture=0, voltage_eV=100e3, sampling=0.3,
               slice_thickness=1.5, use_cache=False,
               debye_waller={"B": 0.7, "N": 0.7},
               bandwidth_limit=2.0 / 3.0,          # 4. antialias band
               device_output=True)
    wf = calc.run(progress=False)
    dwf_pattern = pacbed(wf)                       # 5. PACBED
    print(f"DWF + 2/3 band limit PACBED: shape {dwf_pattern.shape}, "
          f"peak {dwf_pattern.max():.3e}")

    # 5. radial profiles: thermal diffuse background vs DWF damping
    kxs, kys = np.asarray(wf.kxs), np.asarray(wf.kys)
    k, prof_fp = radial_profile(axial, kxs, kys, n_bins=24)
    _, prof_dw = radial_profile(dwf_pattern, kxs, kys, n_bins=24)
    mid = len(k) // 2
    print("radial profile at mid-k: frozen-phonon "
          f"{prof_fp[mid]:.3e} vs Debye-Waller {prof_dw[mid]:.3e} "
          "(DWF removes the thermal diffuse background, FP keeps it)")


if __name__ == "__main__":
    main()
