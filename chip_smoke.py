#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pyslice_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one line (or a few) and failing hard:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the CUDA kernels (ops/csrc/fused_step.cu) with nvcc;
3. each kernel (A in every mode, B, C) against its plain torch.fft version
   at the main path's shapes (16 probes, 1024^2, complex64), plus one
   depth-recording chain: max|d|/max|ref| <= 1e-4 and the magnitude
   residual sum((|F|-|D|)^2)/sum(|F|^2) <= 1e-6;
4. the main path: an hBN monolayer filling a 102.35 A box (3,680 atoms,
   10 thermal frames) through MultisliceCalculator(device="cuda") at
   1024^2 x 16 probes x 14 slices; launch counts, the plain-path residual
   on frame 0, TACAW and HAADF outputs, ms/frame both ways;
5. a JSON line per kernel, the nvidia-smi line, and the final JSON line.

Exits non-zero, printing no result, without a CUDA device or without the
repository around it.
"""

import json
import subprocess
import sys
import time

MAX_REL = 1e-4
MAX_RESIDUAL = 1e-6
N_PROBES, N_GRID, N_SLICES, N_FRAMES = 16, 1024, 14, 10
SOURCE = "pyslice_tpu_torch/ops/csrc/fused_step.cu"
REPLACES = {"a": "pyslice_tpu/ops/fused_step.py:472",
            "b": "pyslice_tpu/ops/fused_step.py:503",
            "c": "pyslice_tpu/ops/fused_step.py:423"}


def require(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def errors(got, want):
    """(max|d|, max|d|/max|ref|, magnitude residual) of two tensors."""
    import torch
    torch.cuda.synchronize()
    d = (got - want).abs().max().item()
    f, r = got.abs().double(), want.abs().double()
    res = (((f - r) ** 2).sum() / (f ** 2).sum()).item()
    return d, d / want.abs().max().item(), res


def check(name, got, want):
    d, rel, res = errors(got, want)
    print(f"  {name}: max|d| {d:.3e}  max|d|/max|ref| {rel:.3e}  "
          f"residual {res:.3e}")
    require(rel <= MAX_REL and res <= MAX_RESIDUAL, f"{name} disagrees")
    return d


def cuda_ms(fn, reps=20):
    """Mean device time of fn() over reps launches, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def kernel_phase(dev, P=N_PROBES, n=N_GRID, nz=N_SLICES):
    """Phase 3: every kernel against its plain version. Returns the JSON
    records (without launch counts) keyed by kernel."""
    import numpy as np
    import torch
    from pyslice_tpu_torch.core.constants import (interaction_parameter,
                                                  wavelength)
    from pyslice_tpu_torch.ops import fused_step as fs

    lam, sigma = wavelength(100e3), interaction_parameter(100e3)
    g = torch.Generator(device=dev).manual_seed(0)
    psi = torch.randn((P, n, n), dtype=torch.complex64, device=dev,
                      generator=g)
    # phases of tens of radians, as sigma*V reaches near atom cores
    sv = torch.randn((n, n), device=dev, generator=g) * 20.0
    t = torch.complex(torch.cos(sv), torch.sin(sv))
    kxs = np.fft.fftfreq(n, 0.1)
    prop = fs.fresnel_plane(kxs, kxs, lam, 0.4846, device=dev)
    errs = {"a": 0.0, "b": 0.0, "c": 0.0}
    for mode in fs.ROW_MODES:
        for label, tt in (("planes", t), ("phase", sv)):
            errs["a"] = max(errs["a"], check(
                f"A {mode:5s} {label:6s}", fs.row_pass(mode, psi, tt),
                fs._plain_row_pass(mode, psi, tt)))
    errs["b"] = check("B", fs.col_pass(psi, prop),
                      fs._plain_col_pass(psi, prop))
    errs["c"] = check("C", fs.kconvert(psi), fs._plain_kconvert(psi))
    v = torch.randn((nz, n, n), device=dev, generator=g) * 50.0
    kw = dict(sigma=sigma, lam=lam, dz=0.4846, record_layers=(3, nz - 1))
    check("chain record_layers=(3, 13)",
          fs.fused_multislice(psi, v, kxs, kxs, **kw),
          fs.fused_multislice_plain(psi, v, kxs, kxs, **kw))
    del v

    buf = psi.clone()
    only_ms = (cuda_ms(lambda: fs.row_pass("only", buf, sv, out=buf)),
               cuda_ms(lambda: fs._plain_row_pass("only", buf, sv)))
    print(f"  A only, sigma*V in the kernel (the transmit kernel's work) at "
          f"{P}x{n}^2: {only_ms[0]:.4f} ms, plain {only_ms[1]:.4f} ms")
    timings = {
        "a": (cuda_ms(lambda: fs.row_pass("mid", buf, t, out=buf)),
              cuda_ms(lambda: fs._plain_row_pass("mid", buf, t))),
        "b": (cuda_ms(lambda: fs.col_pass(buf, prop, out=buf)),
              cuda_ms(lambda: fs._plain_col_pass(buf, prop))),
        "c": (cuda_ms(lambda: fs.kconvert(buf)),
              cuda_ms(lambda: fs._plain_kconvert(buf))),
    }
    names = {"a": "fused_step.row_pass (A)", "b": "fused_step.col_pass (B)",
             "c": "fused_step.kconvert (C)"}
    records = {}
    for k in ("a", "b", "c"):
        ms, plain_ms = timings[k]
        print(f"  {names[k]} at {P}x{n}^2: {ms:.4f} ms, plain torch.fft "
              f"{plain_ms:.4f} ms")
        records[k] = {"name": names[k], "route": "cuda", "source": SOURCE,
                      "replaces": REPLACES[k], "max_abs_err": errs[k],
                      "ms": ms, "plain_ms": plain_ms}
    return records


def hbn_box(lx, n_frames, seed=0, lz=6.784):
    """hBN monolayer filling an lx x lx box (whole rectangular cells,
    a = 2.504 A, 4 atoms each) plus n_frames uniform thermal frames of
    0.05 A from a seeded torch.Generator."""
    import numpy as np
    import torch
    from pyslice_tpu_torch import Trajectory
    a = 2.504
    by = np.sqrt(3.0) * a
    z0 = lz / 4.0
    base = np.array([[0.0, 0.0, z0], [a / 2, by / 6, z0],
                     [a / 2, by / 2, z0], [0.0, by / 2 + by / 6, z0]])
    ncx, ncy = int(lx // a), int(lx // by)
    pos = np.concatenate([base + np.array([i * a, j * by, 0.0])
                          for i in range(ncx) for j in range(ncy)])[None]
    types = np.tile(np.array([5, 7, 5, 7], dtype=np.int32), ncx * ncy)
    traj = Trajectory(atom_types=types, positions=pos,
                      velocities=np.zeros_like(pos),
                      box_matrix=np.diag([lx, lx, lz]), timestep=0.005)
    return traj.generate_random_displacements(
        n_frames, 0.05, generator=torch.Generator().manual_seed(seed))


def slice_phase(dev, card, lx=102.35, n_frames=N_FRAMES):
    """Phase 4: the main path. Returns the launch counts of the run."""
    import numpy as np
    import torch
    import pyslice_tpu_torch as pt
    from pyslice_tpu_torch.engine.pipeline import frame_exit_waves
    from pyslice_tpu_torch.ops import config as ops_config
    from pyslice_tpu_torch.ops import fused_step as fs

    traj = hbn_box(lx, n_frames)
    calc = pt.MultisliceCalculator(device=dev)
    calc.setup(traj, aperture=30.0, voltage_eV=100e3, sampling=0.1,
               slice_thickness=0.5,
               probe_positions=pt.probe_grid([10, 90], [10, 90], 4, 4),
               device_output=True, use_cache=False)
    print(f"  {traj.n_atoms} atoms, {n_frames} frames, grid "
          f"{calc.nx}x{calc.ny}x{calc.nz}, {calc.n_probes} probes")

    for k in fs.launches:
        fs.launches[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wf = calc.run(progress=False)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = dict(fs.launches)
    want = {"a": n_frames * calc.nz, "b": n_frames * (calc.nz - 1),
            "c": n_frames}
    print(f"  launches {counts}, expected {want}")
    require(counts == want, "the main path did not run every kernel")
    w = wf.wavefunction_data
    require(tuple(w.shape) == (calc.n_probes, n_frames, calc.nx, calc.ny, 1)
            and w.is_cuda and w.dtype == torch.complex64,
            f"WFData shape/device {tuple(w.shape)} {w.device} {w.dtype}")
    require(bool(torch.isfinite(torch.view_as_real(w)).all()),
            "non-finite exit waves")

    probes = calc._probes_array()
    pos0 = traj.positions[0]

    def frame(mode):
        ops_config.fused_multislice = mode
        try:
            out = frame_exit_waves(pos0, probes, calc.spec)
            torch.cuda.synchronize()
            return out
        finally:
            ops_config.fused_multislice = "auto"

    plain0 = frame("off")
    _, rel, res = errors(w[:, 0], plain0)
    print(f"  frame 0, kernels vs plain path: max|d|/max|ref| {rel:.3e}  "
          f"residual {res:.3e}")
    require(res <= MAX_RESIDUAL, "kernel path disagrees with plain path")

    # ms/frame, taken in turns (plain, kernel, kernel, plain)
    times = {"off": [], "auto": []}
    for mode in ("off", "auto", "auto", "off"):
        t0 = time.perf_counter()
        frame(mode)
        times[mode].append(1e3 * (time.perf_counter() - t0))
    k_ms, p_ms = min(times["auto"]), min(times["off"])
    print(f"  ms/frame ({calc.nx}x{calc.ny} x {calc.n_probes} probes x "
          f"{calc.nz} slices, rasterizer included): kernels {k_ms:.2f}, "
          f"plain torch.fft {p_ms:.2f}; "
          f"run() {1e3 * run_s / n_frames:.2f} ms/frame over {n_frames} "
          f"frames; card {card}")

    tac = pt.TACAWData(wf)
    spec = tac.spectrum()
    diff = tac.diffraction()
    adf = pt.HAADFData(wf).calculateADF(45)
    print(f"  TACAW spectrum {spec.shape}, diffraction {diff.shape}, "
          f"HAADF {adf.shape}; ADF range {adf.min():.4e}..{adf.max():.4e}")
    require(spec.shape == (n_frames,) and np.isfinite(spec).all(),
            "TACAW spectrum")
    require(diff.shape == (calc.nx, calc.ny) and np.isfinite(diff).all(),
            "TACAW diffraction")
    require(adf.shape == (4, 4) and np.isfinite(adf).all() and adf.min() > 0,
            "HAADF image")
    return counts


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from pyslice_tpu_torch.ops import fused_step as fs

    dev = torch.device("cuda")
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    b = fs.build()
    print(f"[2] built {b.path.name} in {b.seconds:.1f} s")
    for line in b.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"    {line.strip()}")

    print(f"[3] kernels vs plain versions at {N_PROBES} x {N_GRID}^2:")
    records = kernel_phase(dev)
    print("[4] main path:")
    counts = slice_phase(dev, card)
    for k, rec in records.items():
        rec["launches"] = counts[k]
    print(json.dumps({"kernels": [records[k] for k in ("a", "b", "c")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
