"""Command-line interface: ``python -m pyslice_tpu_torch <command>``.

Counterpart of ``python -m pyslice_tpu``: the same commands, flags and
output files, plus ``--device {cuda,cpu}`` on ``run``, ``info`` and
``calibrate`` (default ``cuda``; without a card the command stops with a
message unless ``--device cpu`` is given).

Commands:
    run        — run a simulation from a JSON config (or flags) and write
                 analysis products (+ the resolved config) to the output
                 dir: config.json, frequencies.npy, spectrum.npy,
                 diffraction.npy (tacaw), haadf_image.npy (haadf),
                 wf_data.npz (wf or --save-wf).
    info       — parse a trajectory file and print its shape/box summary.
    calibrate  — calibrate a measured 4D-STEM datacube (HDF5/EMD): writes
                 calibrated.emd, com.npy and report.json.
    devices    — show the CUDA devices and the default (frame, probe) mesh
                 (under torchrun also the world and make_mesh()'s layout).

Example:
    python -m pyslice_tpu_torch run --trajectory md.lammpstrj \\
        --timestep 0.005 --atom-mapping 1=B,2=N --mode tacaw \\
        --output-dir results/
    python -m pyslice_tpu_torch run --config run.json --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np


def _parse_mapping(text):
    out = {}
    for pair in text.split(","):
        k, v = pair.split("=")
        v = v.strip()
        out[int(k)] = int(v) if v.isdigit() else v
    return out


def _no_card(args) -> bool:
    """True (after a message) when the command asks for the card and
    there is none: the command never carries on on the CPU by itself."""
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return True
    return False


def cmd_run(args) -> int:
    from .engine.config import SimulationConfig

    if args.config:
        cfg = SimulationConfig.load(args.config)
    else:
        cfg = SimulationConfig()
    for name in ("trajectory", "timestep", "aperture", "voltage_eV",
                 "defocus", "slice_thickness", "sampling", "precision",
                 "mode", "collection_angle", "output_dir", "max_frames",
                 "cache_root"):
        v = getattr(args, name, None)
        if v is not None:
            setattr(cfg, name, v)
    if args.atom_mapping:
        cfg.atom_mapping = _parse_mapping(args.atom_mapping)
    if args.probe_grid:
        cfg.probe_grid = tuple(float(x) for x in args.probe_grid.split(","))
    if args.save_wf:
        cfg.save_wf = True
    if args.no_cache:
        cfg.use_cache = False
    if args.fast_grid:
        cfg.fast_grid = True
    if not cfg.trajectory:
        print("error: no trajectory given (--trajectory or --config)",
              file=sys.stderr)
        return 2
    if _no_card(args):
        return 1

    from . import (HAADFData, MultisliceCalculator, TACAWData,
                   TrajectoryLoader)

    out_dir = Path(cfg.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "config.json").write_text(cfg.to_json())

    print(f"Loading {cfg.trajectory} ...")
    traj = TrajectoryLoader(cfg.trajectory, timestep=cfg.timestep,
                            atom_mapping=cfg.atom_mapping,
                            use_cache=cfg.use_cache).load()
    if cfg.max_frames and traj.n_frames > cfg.max_frames:
        traj = traj.slice_timesteps(list(range(cfg.max_frames)))
    print(f"{traj.n_frames} frames, {traj.n_atoms} atoms")

    calc = MultisliceCalculator(device=args.device, precision=cfg.precision)
    calc.setup(traj, aperture=cfg.aperture, voltage_eV=cfg.voltage_eV,
               defocus=cfg.defocus, slice_thickness=cfg.slice_thickness,
               sampling=cfg.sampling,
               probe_positions=cfg.resolve_probe_positions(),
               batch_size=cfg.batch_size, slice_axis=cfg.slice_axis,
               record_layers=cfg.record_layers, use_cache=cfg.use_cache,
               cache_root=cfg.cache_root, fast_grid=cfg.fast_grid,
               aberrations=cfg.aberrations,
               bandwidth_limit=cfg.bandwidth_limit, tilt=cfg.tilt,
               debye_waller=cfg.debye_waller)
    print(f"Grid {calc.nx}x{calc.ny}x{calc.nz}, {calc.n_probes} probes")
    t0 = time.time()
    wf = calc.run()
    print(f"Simulation: {time.time() - t0:.1f}s")

    if cfg.save_wf or cfg.mode == "wf":
        wf.save(out_dir / "wf_data.npz")
        print("  wrote wf_data.npz")

    if cfg.mode == "tacaw":
        tac = TACAWData(wf)
        np.save(out_dir / "frequencies.npy", tac.frequencies)
        np.save(out_dir / "spectrum.npy", tac.spectrum(None))
        np.save(out_dir / "diffraction.npy", tac.diffraction(None))
        print("  wrote frequencies.npy spectrum.npy diffraction.npy")
    elif cfg.mode == "haadf":
        h = HAADFData(wf)
        image = h.calculateADF(collection_angle=cfg.collection_angle)
        np.save(out_dir / "haadf_image.npy", image)
        print(f"  wrote haadf_image.npy {image.shape}")
    print(f"Results in {out_dir}/")
    return 0


def cmd_info(args) -> int:
    if _no_card(args):
        return 1
    from . import TrajectoryLoader
    traj = TrajectoryLoader(args.trajectory, use_cache=not args.no_cache).load()
    print(f"frames:     {traj.n_frames}")
    print(f"atoms:      {traj.n_atoms}")
    print(f"types:      {sorted(set(np.asarray(traj.atom_types).tolist()))}")
    print(f"box diag:   {np.diag(traj.box_matrix)}")
    print(f"box tilts:  {traj.box_tilts}")
    return 0


def cmd_calibrate(args) -> int:
    """Calibrate a measured 4D-STEM datacube on ``--device``: dark/gain,
    stuck pixels, beam centering, descan fit, rotation/transpose solve,
    dose — then write the calibrated cube (EMD) + CoM field + a JSON
    report."""
    if _no_card(args):
        return 1
    import json

    from .analysis.calibration import calibrate_datacube
    from .io.data4d import load_4dstem, save_4dstem

    r = load_4dstem(args.datacube, dataset=args.dataset,
                    crop_k=args.crop_k, bin_k=args.bin_k, device=args.device)
    n_sx, n_sy = r["scan_shape"]
    cube = r["data"].reshape(n_sx, n_sy, *r["data"].shape[-2:])
    xs = np.arange(n_sx) * args.scan_step
    ys = np.arange(n_sy) * args.scan_step
    dark = np.load(args.dark) if args.dark else None
    gain = np.load(args.gain) if args.gain else None
    g_expected = (np.asarray(args.lattice, float).reshape(2, 2)
                  if args.lattice else None)
    res = calibrate_datacube(cube, xs, ys, dark=dark, gain=gain,
                             k_per_pixel=args.k_per_pixel,
                             apply_ellipse=args.apply_ellipse,
                             g_expected=g_expected,
                             apply_affine=args.apply_affine,
                             device=args.device)
    for line in res["report"]:
        print("  -", line)
    out = Path(args.output_dir or "calibrated")
    out.mkdir(parents=True, exist_ok=True)
    save_4dstem(out / "calibrated.emd", res["data"])
    np.save(out / "com.npy", res["com"].cpu().numpy())
    (out / "report.json").write_text(json.dumps(report_json(res), indent=1))
    print(f"Wrote {out}/calibrated.emd com.npy report.json")
    return 0


def report_json(res: dict) -> dict:
    """The JSON report of a ``calibrate_datacube`` result (report.json)."""
    return {
        "report": res["report"],
        "rotation_rad": res["rotation"],
        "transpose": bool(res["transpose"]),
        "rotation_skewness": res["rotation_diag"]["skewness"],
        "curl_rms": res["rotation_diag"]["curl_rms"],
        "beam_center_shift": list(res["beam_center_shift"]),
        "descan_coeffs": res["descan"]["coeffs"].tolist(),
        "bad_pixels": int(res["bad_pixels"].sum()),
        "ellipticity": (res["ellipse"]["ellipticity"]
                        if res["ellipse"] else None),
        "ellipse_angle_rad": (res["ellipse"]["angle"]
                              if res["ellipse"] else None),
        "affine_A": (res["affine"]["A"].tolist()
                     if res["affine"] else None),
        "dose_e_per_A2": res["dose"]["dose"],
    }


def cmd_devices(args) -> int:
    import torch

    from .parallel.mesh import factor_mesh
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{n} CUDA device(s)")
    for i in range(n):
        print(f"  cuda:{i} {torch.cuda.get_device_name(i)}")
    if not n:
        print("error: no CUDA device", file=sys.stderr)
        return 1
    f, p = factor_mesh(n)
    print(f"default mesh: frame={f} x probe={p}")
    if "WORLD_SIZE" in os.environ:
        # under torchrun: the world make_mesh() lays out, rank-major
        world = int(os.environ["WORLD_SIZE"])
        f, p = factor_mesh(world)
        print(f"torchrun world: {world} rank(s), this is rank "
              f"{os.environ.get('RANK', 0)} (local rank "
              f"{os.environ.get('LOCAL_RANK', 0)} of "
              f"{os.environ.get('LOCAL_WORLD_SIZE', world)})")
        print(f"make_mesh(): frame={f} x probe={p}, ranks "
              f"{np.arange(world).reshape(f, p).tolist()}")
    return 0


def _device_flag(parser) -> None:
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where to run (default: the card)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pyslice_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    sub = ap.add_subparsers(dest="command", required=True)

    run = sub.add_parser("run", help="run a simulation")
    run.add_argument("--config", help="JSON SimulationConfig file")
    run.add_argument("--trajectory")
    run.add_argument("--timestep", type=float)
    run.add_argument("--atom-mapping", help="e.g. 1=B,2=N")
    run.add_argument("--aperture", type=float)
    run.add_argument("--voltage-eV", dest="voltage_eV", type=float)
    run.add_argument("--defocus", type=float)
    run.add_argument("--slice-thickness", dest="slice_thickness", type=float)
    run.add_argument("--sampling", type=float)
    run.add_argument("--probe-grid", help="x0,x1,y0,y1,n,m")
    run.add_argument("--precision", choices=["single", "double"])
    run.add_argument("--mode", choices=["tacaw", "haadf", "wf"])
    run.add_argument("--collection-angle", dest="collection_angle", type=float)
    run.add_argument("--max-frames", dest="max_frames", type=int)
    run.add_argument("--output-dir", dest="output_dir")
    run.add_argument("--cache-root", dest="cache_root")
    run.add_argument("--fast-grid", dest="fast_grid", action="store_true",
                     help="snap grid to 128-multiples")
    run.add_argument("--save-wf", action="store_true")
    run.add_argument("--no-cache", action="store_true")
    _device_flag(run)
    run.set_defaults(fn=cmd_run)

    info = sub.add_parser("info", help="inspect a trajectory file")
    info.add_argument("trajectory")
    info.add_argument("--no-cache", action="store_true")
    _device_flag(info)
    info.set_defaults(fn=cmd_info)

    cal = sub.add_parser(
        "calibrate", help="calibrate a measured 4D-STEM datacube "
        "(bad pixels, centering, descan, rotation, dose)")
    cal.add_argument("datacube", help="HDF5/EMD file")
    cal.add_argument("--scan-step", dest="scan_step", type=float,
                     required=True, help="scan pitch in Angstrom")
    cal.add_argument("--dataset", help="explicit HDF5 dataset path")
    cal.add_argument("--crop-k", dest="crop_k", type=int)
    cal.add_argument("--bin-k", dest="bin_k", type=int, default=1)
    cal.add_argument("--dark", help=".npy dark frame")
    cal.add_argument("--gain", help=".npy gain map")
    cal.add_argument("--k-per-pixel", dest="k_per_pixel", type=float,
                     default=1.0, help="detector k sampling (1/A/px)")
    cal.add_argument("--apply-ellipse", dest="apply_ellipse",
                     action="store_true",
                     help="circularize the fitted BF-disk ellipse "
                     "(the ellipticity is always fitted and reported)")
    cal.add_argument("--lattice", dest="lattice", type=float, nargs=4,
                     metavar=("G1X", "G1Y", "G2X", "G2Y"),
                     help="expected reciprocal lattice vectors (1/A) of a "
                     "known calibration crystal -> fit the affine scan "
                     "distortion")
    cal.add_argument("--apply-affine", dest="apply_affine",
                     action="store_true",
                     help="resample the scan axes with the fitted affine "
                     "inverse (needs --lattice)")
    cal.add_argument("--output-dir", dest="output_dir")
    _device_flag(cal)
    cal.set_defaults(fn=cmd_calibrate)

    dev = sub.add_parser("devices", help="show devices / default mesh")
    dev.set_defaults(fn=cmd_devices)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
