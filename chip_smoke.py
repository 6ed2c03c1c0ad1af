#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pyslice_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one line (or a few) and failing hard:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the CUDA kernels (every ops/csrc/*.cu, one nvcc each, together);
3. kernels A (every mode), B and C against their plain torch.fft versions
   at 16 probes x 1024^2 complex64, plus one depth-recording chain:
   max|d|/max|ref| <= 1e-4 and the magnitude residual
   sum((|F|-|D|)^2)/sum(|F|^2) <= 1e-6; A and B each with its tile plan
   and persistent grid, B also at 32 planes (the adjoint's pair stream);
4. the mixed-radix kernels the same way: K4 (every mode) and K5 at
   16 x 1023^2, each with its tile plan and persistent grid (K5 also at
   32 planes, the adjoint's pair stream), K6 (the resident slice loop) at
   1 x 1023^2 and 1 x 1024^2 x 14 slices (its mixed-radix and its
   power-of-two instantiation), exit wave and k space with the complex t
   stack and the phase stack, each with its plan and grid, two launches
   the same bits, one depth-recording chain each, and its barrier floor
   (the launch's grid barriers alone);
5. STEM at 1024^2: an hBN monolayer filling a 102.35 A box (3,680 atoms,
   10 thermal frames) through MultisliceCalculator(device="cuda") at
   16 probes x 14 slices; A/B/C launch counts, the plain-path residual on
   frame 0, TACAW and HAADF outputs, ms/frame both ways;
6. the README quick start at the reference-natural grid: an hBN LAMMPS
   dump written with write_lammps_dump (102.25 A box, 100 frames), read by
   TrajectoryLoader, a plane wave (aperture=0.0) at 1023^2: one K6 launch
   a frame and no other kernel, the plain-path residual on frame 0, TACAW
   spectrum and diffraction; ms/frame for K6, the K4/K5 chain and plain;
7. the same with fast_grid=True (1024^2, 10 frames): K6's power-of-two
   instantiation; ms/frame for K6, the A/B/C chain and plain;
8. 16-probe STEM on the 1023^2 box (10 frames): K4 and K5 launch nz and
   nz - 1 times a frame, HAADF finite and positive;
9. the adjoint's kernels against their plain versions: K7 at 16 pairs x
   1024^2 and K8 at 16 pairs x 1023^2 (mid mode with planes and with the
   phase, last mode; each with its tile plan and persistent grid; vbar of
   two launches bit-identical), then each whole adjoint chain (14 slices)
   against its plain twin on lambda_0 and vbar;
10. multislice ptychography at 1024^2 and at 1023^2: frame 0 of the boxes
   of phases 5 and 8, data from the kernel forward (64 positions on an
   8 x 8 scan), the gradients of one minibatch loss (V and probe) through
   the kernels against the plain path, then msp_reconstruct (batch 16,
   5 steps) with the kernels and with the plain path: launch counts reset
   before and checked after every step, finite and falling losses, s/step;
11. refine_structure at 1024^2 for 3 steps, the launches of every step
   checked;
12. config 5 (BASELINE.json) at full width, its frames cut from 1000 to 8:
   the hBN box of 204.75 A (15,228 atoms, 2048^2 x 14), 64 probes at
   25 mrad in chunks of 16, StreamingTACAW at [10, 20, 40] THz fed in
   out-of-order blocks of 4: A/B/C launches and one rasterization a frame;
   each bin against the same stream with the kernels off and the
   complex128 stream (the residual bar; max|d| against complex128 at most
   twice the plain float32 stream's), the batch path on the first 16
   probes (max|d|/max|ref| <= 1e-4); the peak memory beside the state; the
   fold alone within one chunk's exit waves of memory; ms/frame in turns
   and the fold's share; StreamingHAADF on the same frames against
   HAADFData;
13. those frames as a gzipped 17-digit LAMMPS dump through
   TrajectoryStream into a 16-probe stream, a checkpoint after the first
   block restored into a fresh stream: bit-identical to the uninterrupted
   stream, within 1e-4 of phase 12; an 8-digit dump's difference printed;
14. StreamingHAADF at 512^2 over 48 x 48 probes: the automatic route picks
   the S-matrix (K6 on 64-beam chunks), held against the direct route
   (K6 on 256-probe chunks); frozen_phonon_haadf at 16 probes (K4, K5) and
   frozen_phonon_diffraction (K6 mixed radix) on the 1023^2 box;
15. Potential -> Propagate at 16 probes x 1024^2 (A, B) against the plain
   multislice;
16. HRTEM (hrtem_image) on the 1023^2 box of phase 6 at Scherzer focus
   (Cs 1.2 mm, 20 mrad objective aperture; Cc 1.2 mm, dE 0.8 eV over 7
   chromatic nodes; a 0.5 mrad illumination cone as 5 x 5 tilts, snapped
   to 25 distinct lattice tilts and printed; 4 frozen-phonon
   configurations): the tilt batch through K4/K5 (4 x 14, 4 x 13), with
   fast_grid at 1024^2 through A/B/C (4 x (14, 13, 1)), and the coherent
   plane wave through K6 (4, mixed engine), each run with the kernels and
   plain in turns, launch counts reset before and checked after, images
   held to 1e-4 / the residual bar, contrast and ms a configuration;
17. one exit wave of that box (K6), its focal series at 10 defoci and
   iwfr_reconstruct for 400 iterations (torch.fft), as
   tests/test_ewr.py's multislice round trip: the residual falls 100x and
   the wave agrees with the truth to 5e-3 after removing its global
   phase; the residual after 50 iterations, and ms an iteration;
18. on that box, chromatic_stem over 16 x 16 probes at 30 mrad (7 nodes x
   4 configurations, 0.8 A source blur; K4/K5 392/364 launches),
   precession_diffraction at 20 mrad (12 azimuths x 4 configurations; K6
   48) and chromatic_diffraction with a 20 mrad CBED probe (K6 28), each
   with the kernels and plain, held as phase 16;
19. phase retrieval at 256^2 (tests/test_ptychography.py's weak-phase
   problem at a full scan: 64 x 64 positions at 0.4 A, 20 mrad, 2
   slices): the exit waves through pt.multislice in chunks of 256 (K6's
   register engine, 16 launches) against the plain loop, scan_grid_data
   on the 1.07 GB stack, SSB on all 4,096 patterns (correlation > 0.9,
   radian ratio 0.9-1.1), iCoM (> 0.95, 0.85-1.15, curl < 0.2) and ePIE
   on the 32 x 32 subset for 40 sweeps with the probe known (loss falls
   10x, correlation > 0.8); s a sweep and the sweep's idle share
   (torch.profiler's device time against the wall);
20. the command line (``python -m pyslice_tpu_torch``) at the quick
   start's width: phase 6's dump written anew, ``info`` in process, the
   native dump parser against the Python one (bit-equal arrays, both
   times, ``last_parser == "native"``), ``run --mode tacaw`` in process
   (a plane wave at 1023^2: 100 K6 launches and no other kernel;
   spectrum and diffraction within 1e-6 of MultisliceCalculator +
   TACAWData), ``run --mode haadf`` on a 4 x 4 probe grid at 30 mrad for
   10 frames at 1023^2 (K4 14, K5 13 a frame) and with --fast-grid at
   1024^2 (A 14, B 13, C 1 a frame), that config replayed by
   ``python3 -m pyslice_tpu_torch run --config`` in a subprocess (its
   image against the in-process one), ``devices``;
21. measured-data calibration at a real 4D-STEM size: the 25.55 A hBN box
   (256^2 x 14 slices) scanned at 128 x 128 positions (25 mrad, 100 kV,
   the 2/3 band limit, so that the total-count image the affine fit reads
   shows the lattice) through MultisliceCalculator in chunks of 2,048
   probes (8 K6 launches), scan_grid_data's 16,384 x 256^2 float32 cube
   (4.29 GB) corrupted as tests/test_calibration.py corrupts it (PSF sigma
   1.2 px, its sub-pixel descan, a hot and a dead pixel) behind a seeded
   dark frame and gain map; calibrate_datacube in float32 and float64
   held to that test's bars (the two bad pixels, rotation under 1 degree,
   no transpose, skewness < -0.1 on the chosen branch, descan slopes
   within 0.005 px, iCoM within 2% of the clean cube's), float32 against
   float64 (masks, transpose, CoM within 1e-4), again with the integer-
   roll descan, the ellipse and the affine resampling; per call (profiled
   first, then timed warm) its seconds, device time, idle share, peak
   memory over the cube's bytes, and its dispatched operations, the same
   at 64 x 64 positions; with h5py, the 64 x 64 cube through save_4dstem
   and ``calibrate``, whose report.json equals the in-process result;
22. multi-GPU: the (frame, probe) mesh on torch.distributed, the ranks
   launched by torchrun (``pyslice_tpu_torch.parallel.dryrun``, each launch
   with a time limit of its own; the kernels built here first, the ranks
   only load them) and each held against a single-process run here. The
   card is one, and NCCL refuses two ranks on one device: 22a one NCCL
   rank on a 1 x 1 mesh, STEM at 1024^2 x 16 probes x 4 frames through
   MultisliceCalculator(mesh=), bit-identical to the run without a mesh;
   22b four Gloo ranks sharing the card on a 2 x 2 mesh: STEM at 1024^2 x
   16 probes x 8 frames (A/B/C; the exit-wave blocks, the six TACAW
   methods and HAADF to 1e-4 / the residual bar), config 5's
   StreamingTACAW frame-sharded at 2048^2 x 64 probes x 8 frames (phase
   12's bars; a checkpoint and resume a rank bit-identical, refused on
   another mesh), msp_reconstruct(mesh=) at 1024^2 (A, B, K7; batch 16,
   2 steps; the parameters the same bits on every rank, the first
   minibatch's gradient to 1e-3), compute_smatrix(mesh=) at 512^2 (K6
   power-of-two); 22c the same ranks on a 4 x 1 mesh of their own (one
   start-up for both): the quick start frame-sharded at 1023^2, 8 frames,
   one plane wave (K6 mixed, kx padded 1023 -> 1024), spectrum and
   diffraction. On a machine with four cards 22b and 22c run NCCL, a card
   a rank. Each part's launches, summed over the ranks (the counters are
   per process), checked and added to the kernels line; the all_to_all's
   seconds, ms a frame sharded against single-process (ranks that share
   one card over Gloo: not a scaling figure). ``python3
   chip_smoke.py --phase 22`` runs phases 1, 2 and 22 alone;
23. a JSON line per kernel, the nvidia-smi line, and the final JSON line.

Each kernel's record carries its bound: the least time an H100 could take
for the launch timed, the larger of the bytes it must move (each input
read once, each output written once) over the HBM rate and its floating-
point operations over the FP32 rate (data sheet), with FFTs counted as
5 n log2 n a length-n transform. No single PyTorch call computes any of
these functions (each fuses FFT passes with a product, a reduction or a
shifted store), so library_ms is null.

Exits non-zero, printing no result, without a CUDA device or without the
repository around it.
"""

import json
import math
import subprocess
import sys
import tempfile
import time

MAX_REL = 1e-4
MAX_RESIDUAL = 1e-6
N_PROBES, N_GRID, N_SLICES, N_FRAMES = 16, 1024, 14, 10
N_ODD = 1023                 # int(102.25 / 0.1) + 1
QUICK_FRAMES = 100           # BASELINE.json config 2: 100 frames, 1 probe
CSRC = "pyslice_tpu_torch/ops/csrc/"
# kernel -> (name, source, the TPU kernel it replaces)
KERNELS = {
    "a": ("fused_step.row_pass (A)", "fused_step.cu",
          "pyslice_tpu/ops/fused_step.py:472"),
    "b": ("fused_step.col_pass (B)", "fused_step.cu",
          "pyslice_tpu/ops/fused_step.py:503"),
    "c": ("fused_step.kconvert (C)", "fused_step.cu",
          "pyslice_tpu/ops/fused_step.py:423"),
    "k4": ("fused_step_odd.row_pass_mr (K4)", "fused_step_odd.cu",
           "pyslice_tpu/ops/fused_step_odd.py:272"),
    "k5": ("fused_step_odd.col_pass_mr (K5)", "fused_step_odd.cu",
           "pyslice_tpu/ops/fused_step_odd.py:304"),
    "k6_mixed": ("fused_step_resident.resident_loop (K6, mixed-radix)",
                 "resident.cu",
                 "pyslice_tpu/ops/fused_step_odd_resident.py:369"),
    "k6_pow2": ("fused_step_resident.resident_loop (K6, power-of-two)",
                "resident.cu", "pyslice_tpu/ops/fused_step_resident.py:250"),
    "k7": ("fused_step_adjoint.row_pass_bwd (K7)", "fused_step_adjoint.cu",
           "pyslice_tpu/ops/fused_step_adjoint.py:148"),
    "k8": ("fused_step_adjoint.row_pass_mr_bwd (K8)",
           "fused_step_adjoint_odd.cu",
           "pyslice_tpu/ops/fused_step_adjoint.py:346"),
}
MSP_SCAN, MSP_BATCH, MSP_STEPS = 8, 16, 5   # 64 positions, 16 a step
MSP_STEP_A = 0.5             # scan step (A): neighbouring probes overlap
REFINE_STEPS = 3
GRAD_REL = 1e-3     # float32 gradients, kernel path against plain
HBM_BYTES_S = 3.35e12   # H100 SXM, HBM3 (data sheet)
FP32_FLOP_S = 67e12     # H100 SXM, float32 outside the tensor cores
C64, F32 = 8, 4         # bytes of a complex64 and a float32 element


def require(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def errors(got, want, scale=None):
    """(max|d|, max|d|/scale, magnitude residual) of two tensors; ``scale``
    defaults to max|ref|. Two tensors that are both zero give (0, 0, 0)."""
    import torch
    torch.cuda.synchronize()
    d = (got - want).abs().max().item()
    f, r = got.abs().double(), want.abs().double()
    den = (f ** 2).sum().item()
    res = ((f - r) ** 2).sum().item() / den if den else float(d > 0)
    scale = scale or want.abs().max().item()
    return d, d / scale if scale else d, res


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


def fft_flops(n):
    """The conventional operation count of a length-n complex FFT."""
    return 5.0 * n * math.log2(n)


def kernel_bound(kind, P, n, nz=0):
    """The bound of one launch on P planes (P pairs for "pairs") of n^2:
    {"bound_ms", "bound_by", "bound", "library_ms"}. Kinds: "pass" (A mid,
    B, K4 mid, K5: a transform each way and a product with one complex
    plane), "kconvert" (C), "only" (A only with sigma*V; cos/sin not
    counted), "resident" (K6, an nz-slice loop with a complex t stack),
    "pairs" (K7, K8 mid: both members of each pair, and V-bar)."""
    px = n * n
    nbytes, flops = {
        "pass": ((2 * P + 1) * px * C64, P * n * 2 * fft_flops(n) + 6 * P * px),
        "kconvert": (2 * P * px * C64, P * n * fft_flops(n)),
        "only": (2 * P * px * C64 + px * F32, 6 * P * px),
        "resident": ((2 * P + nz + 1) * px * C64,
                     P * (nz - 1) * 4 * n * fft_flops(n)
                     + P * (2 * nz - 1) * 6 * px),
        "pairs": ((4 * P + 1) * px * C64 + px * F32,
                  2 * P * (n * 2 * fft_flops(n) + 6 * px) + 4 * P * px),
    }[kind]
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / FP32_FLOP_S
    by_bytes = t_bytes >= t_ops
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if by_bytes else "operations",
            "bound": "hbm" if by_bytes else "fp32", "library_ms": None}


def kernel_name(mangled):
    """The last name component of a mangled C++ kernel name
    (``_ZN<len><name>...<len><kernel>E...``), as -Xptxas -v prints it."""
    s = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    name, i = mangled, 0
    while i < len(s) and s[i].isdigit():
        j = i
        while s[j].isdigit():
            j += 1
        name, i = s[j:j + int(s[i:j])], j + int(s[i:j])
    return name


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def launches_of(fn):
    """fn() with every launch count set to 0 just before it and read just
    after (synchronized); returns (result, counts, seconds)."""
    import torch
    from pyslice_tpu_torch.ops import fused_step as fs
    for k in fs.launches:
        fs.launches[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(fs.launches), time.perf_counter() - t0


def want_counts(**n):
    from pyslice_tpu_torch.ops import fused_step as fs
    want = dict.fromkeys(fs.launches, 0)
    want.update(n)
    return want


class dispatch:
    """The kernels' dispatch flags for the duration of a block."""

    def __init__(self, fused="auto", resident="auto"):
        self.flags = (fused, resident)

    def __enter__(self):
        from pyslice_tpu_torch.ops import config as ops_config
        ops_config.fused_multislice, ops_config.resident_multislice = \
            self.flags

    def __exit__(self, *exc):
        from pyslice_tpu_torch.ops import config as ops_config
        ops_config.fused_multislice = "auto"
        ops_config.resident_multislice = "auto"


def kernel_phase(dev, P=N_PROBES, n=N_GRID, nz=N_SLICES):
    """Phase 3: kernels A, B, C against their plain versions. Returns the
    JSON records (without launch counts) keyed by kernel."""
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
          f"{P}x{n}^2: {only_ms[0]:.4f} ms, plain {only_ms[1]:.4f} ms, "
          f"bound {kernel_bound('only', P, n)['bound_ms']:.4f} ms")
    timings = {
        "a": (cuda_ms(lambda: fs.row_pass("mid", buf, t, out=buf)),
              cuda_ms(lambda: fs._plain_row_pass("mid", buf, t))),
        "b": (cuda_ms(lambda: fs.col_pass(buf, prop, out=buf)),
              cuda_ms(lambda: fs._plain_col_pass(buf, prop))),
        "c": (cuda_ms(lambda: fs.kconvert(buf)),
              cuda_ms(lambda: fs._plain_kconvert(buf))),
    }
    plans = {k: dict(fs.last_launch[k]) for k in ("a", "b")}
    for k, plan in plans.items():
        print(f"    {k.upper()} tile plan and persistent grid at {P}x{n}^2: "
              f"{plan}")
    del buf
    # B on 2P planes: the adjoint chain's pair stream
    buf = torch.randn((2 * P, n, n), dtype=torch.complex64, device=dev,
                      generator=g)
    errs["b"] = max(errs["b"], check(
        f"B {2 * P} planes", fs.col_pass(buf, prop),
        fs._plain_col_pass(buf, prop)))
    b_pairs = {"ms": cuda_ms(lambda: fs.col_pass(buf, prop, out=buf)),
               "plain_ms": cuda_ms(lambda: fs._plain_col_pass(buf, prop)),
               "bound_ms": kernel_bound("pass", 2 * P, n)["bound_ms"]}
    print(f"  B at {2 * P}x{n}^2: {b_pairs['ms']:.4f} ms, plain "
          f"{b_pairs['plain_ms']:.4f} ms, bound {b_pairs['bound_ms']:.4f} "
          f"ms; plan and grid {fs.last_launch['b']}")
    del buf
    bounds = {"a": kernel_bound("pass", P, n), "b": kernel_bound("pass", P, n),
              "c": kernel_bound("kconvert", P, n)}
    records = records_for(errs, timings, bounds, f"{P}x{n}^2")
    records["b"][f"at_{2 * P}_planes"] = b_pairs
    for k, plan in plans.items():
        records[k]["plan"] = plan
    return records


def records_for(errs, timings, bounds, shape):
    """JSON records (without launch counts) of the kernels in ``errs``."""
    records = {}
    for k, err in errs.items():
        name, src, replaces = KERNELS[k]
        ms, plain_ms = timings[k]
        b = bounds[k]
        print(f"  {name} at {shape}: {ms:.4f} ms, plain torch.fft "
              f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound']})")
        records[k] = {"name": name, "route": "cuda", "source": CSRC + src,
                      "replaces": replaces, "max_abs_err": err,
                      "ms": ms, "plain_ms": plain_ms, **b}
    return records


def mr_kernel_phase(dev, P=N_PROBES, n=N_ODD, nz=N_SLICES):
    """Phase 4: K4, K5 at P x n^2 and K6 at 1 x n^2 and 1 x 1024^2 against
    their plain versions. Returns the JSON records keyed by kernel."""
    import numpy as np
    import torch
    from pyslice_tpu_torch.core.constants import (interaction_parameter,
                                                  wavelength)
    from pyslice_tpu_torch.ops import fused_step as fs
    from pyslice_tpu_torch.ops import fused_step_odd as fo
    from pyslice_tpu_torch.ops import fused_step_odd_resident as fodr
    from pyslice_tpu_torch.ops import fused_step_resident as fr

    lam, sigma = wavelength(100e3), interaction_parameter(100e3)
    g = torch.Generator(device=dev).manual_seed(1)
    psi = torch.randn((P, n, n), dtype=torch.complex64, device=dev,
                      generator=g)
    sv = torch.randn((n, n), device=dev, generator=g) * 20.0
    t = torch.complex(torch.cos(sv), torch.sin(sv))
    kxs = np.fft.fftfreq(n, 0.1)
    prop = fs.fresnel_plane(kxs, kxs, lam, 0.4846, device=dev)
    errs = {"k4": 0.0, "k5": 0.0, "k6_mixed": 0.0, "k6_pow2": 0.0}
    for mode in fs.ROW_MODES:
        for label, tt in (("planes", t), ("phase", sv)):
            errs["k4"] = max(errs["k4"], check(
                f"K4 {mode:5s} {label:6s}", fo.row_pass_mr(mode, psi, tt),
                fs._plain_row_pass(mode, psi, tt)))
    errs["k5"] = check("K5", fo.col_pass_mr(psi, prop),
                       fs._plain_col_pass(psi, prop))
    v = torch.randn((nz, n, n), device=dev, generator=g) * 50.0
    kw = dict(sigma=sigma, lam=lam, dz=0.4846, record_layers=(3, nz - 1))
    check(f"K4/K5 chain record_layers=(3, {nz - 1})",
          fo.fused_multislice_odd(psi, v, kxs, kxs, **kw),
          fs.fused_multislice_plain(psi, v, kxs, kxs, **kw))
    del v

    loops, k6_plans = {}, {}
    for key, m, entry in (("k6_mixed", n, fodr.fused_multislice_odd_resident),
                           ("k6_pow2", 1024, fr.fused_multislice_resident)):
        ks = np.fft.fftfreq(m, 0.1)
        p1 = torch.randn((1, m, m), dtype=torch.complex64, device=dev,
                         generator=g)
        v = torch.randn((nz, m, m), device=dev, generator=g) * 50.0
        tstack = fs.transmission_stack(sigma, v)
        pm = fs.fresnel_plane(ks, ks, lam, 0.4846, device=dev)
        for label, tt in (("t stack", tstack), ("phase", sigma * v)):
            for kspace in (False, True):
                errs[key] = max(errs[key], check(
                    f"K6 1x{m}^2x{nz} {label:7s} kspace={kspace!s:5s}",
                    fr.resident_loop(p1, tt, pm, kspace),
                    fr._plain_resident_loop(p1, tt, pm, kspace)))
        again = fr.resident_loop(p1, tstack, pm, True)
        require(torch.equal(again, fr.resident_loop(p1, tstack, pm, True)),
                f"K6 at 1x{m}^2: two launches differ")
        k6_plans[key] = dict(fr.last_launch)
        print(f"    K6 plan and grid at 1x{m}^2 (two launches the same "
              f"bits): {k6_plans[key]}")
        check(f"K6 1x{m}^2 record_layers=(3, {nz - 1})",
              entry(p1, v, ks, ks, **kw),
              fs.fused_multislice_plain(p1, v, ks, ks, **kw))
        loops[key] = (p1, tstack, pm)

    buf = psi.clone()
    timings = {
        "k4": (cuda_ms(lambda: fo.row_pass_mr("mid", buf, t, out=buf)),
               cuda_ms(lambda: fs._plain_row_pass("mid", buf, t))),
        "k5": (cuda_ms(lambda: fo.col_pass_mr(buf, prop, out=buf)),
               cuda_ms(lambda: fs._plain_col_pass(buf, prop))),
    }
    plans = {k: dict(fo.last_launch[k]) for k in ("k4", "k5")}
    for k, plan in plans.items():
        print(f"    {k.upper()} tile plan and persistent grid at {P}x{n}^2: "
              f"{plan}")
    del buf
    # K5 on 2P planes: the adjoint chain's pair stream
    buf = torch.randn((2 * P, n, n), dtype=torch.complex64, device=dev,
                      generator=g)
    errs["k5"] = max(errs["k5"], check(
        f"K5 {2 * P} planes", fo.col_pass_mr(buf, prop),
        fs._plain_col_pass(buf, prop)))
    k5_pairs = {"ms": cuda_ms(lambda: fo.col_pass_mr(buf, prop, out=buf)),
                "plain_ms": cuda_ms(lambda: fs._plain_col_pass(buf, prop)),
                "bound_ms": kernel_bound("pass", 2 * P, n)["bound_ms"]}
    print(f"  K5 at {2 * P}x{n}^2: {k5_pairs['ms']:.4f} ms, plain "
          f"{k5_pairs['plain_ms']:.4f} ms, bound {k5_pairs['bound_ms']:.4f} "
          f"ms; plan and grid {fo.last_launch['k5']}")
    del buf
    barrier_ms = {}
    for key, (p1, tstack, pm) in loops.items():
        timings[key] = (
            cuda_ms(lambda: fr.resident_loop(p1, tstack, pm), reps=10),
            cuda_ms(lambda: fr._plain_resident_loop(p1, tstack, pm),
                    reps=10))
        fr.resident_loop(p1, tstack, pm)     # the launch the floor repeats
        barrier_ms[key] = cuda_ms(fr.barrier_floor, reps=10)
        print(f"  K6 barrier floor at 1x{p1.shape[1]}^2x{nz}: "
              f"{barrier_ms[key]:.4f} ms ({2 * nz - 2} grid barriers, "
              f"grid {fr.last_launch['grid']} x {fr.last_launch['threads']})")
    bounds = {"k4": kernel_bound("pass", P, n), "k5": kernel_bound("pass", P, n),
              "k6_mixed": kernel_bound("resident", 1, n, nz),
              "k6_pow2": kernel_bound("resident", 1, 1024, nz)}
    records = records_for({k: errs[k] for k in ("k4", "k5")}, timings,
                          bounds, f"{P}x{n}^2")
    records["k5"][f"at_{2 * P}_planes"] = k5_pairs
    for k, plan in plans.items():
        records[k]["plan"] = plan
    records.update(records_for(
        {"k6_mixed": errs["k6_mixed"]}, timings, bounds,
        f"1x{n}^2x{nz} slices"))
    records.update(records_for(
        {"k6_pow2": errs["k6_pow2"]}, timings, bounds,
        f"1x1024^2x{nz} slices"))
    for key in loops:
        records[key].update(plan=k6_plans[key], barrier_ms=barrier_ms[key])
    return records


def hbn_box(lx, n_frames, seed=0):
    """hBN monolayer filling an lx x lx box (whole rectangular cells,
    a = 2.504 A, 4 atoms each) plus n_frames uniform thermal frames of
    0.05 A from a seeded torch.Generator (the dry run's hbn_box)."""
    from pyslice_tpu_torch.parallel.dryrun import hbn_box as build
    return build(lx, n_frames, seed)


def slice_phase(dev, card, lx=102.35, n_frames=N_FRAMES):
    """Phase 5: STEM at 1024^2. Returns the launch counts of the run."""
    import numpy as np
    import torch
    import pyslice_tpu_torch as pt
    from pyslice_tpu_torch.ops import fused_step as fs

    traj = hbn_box(lx, n_frames)
    calc = pt.MultisliceCalculator(device=dev)
    calc.setup(traj, aperture=30.0, voltage_eV=100e3, sampling=0.1,
               slice_thickness=0.5,
               probe_positions=pt.probe_grid([10, 90], [10, 90], 4, 4),
               device_output=True, use_cache=False)
    print(f"  {traj.n_atoms} atoms, {n_frames} frames, grid "
          f"{calc.nx}x{calc.ny}x{calc.nz}, {calc.n_probes} probes")

    want = dict.fromkeys(fs.launches, 0)
    want.update(a=n_frames * calc.nz, b=n_frames * (calc.nz - 1),
                c=n_frames)
    wf, counts, run_s = counted_run(calc, want)
    w = wf.wavefunction_data
    require(tuple(w.shape) == (calc.n_probes, n_frames, calc.nx, calc.ny, 1)
            and w.is_cuda and w.dtype == torch.complex64,
            f"WFData shape/device {tuple(w.shape)} {w.device} {w.dtype}")
    require(bool(torch.isfinite(torch.view_as_real(w)).all()),
            "non-finite exit waves")

    check_frame0(calc, traj, w)
    frame_times(calc, traj, card, run_s, n_frames,
                {"kernels": ("auto", "auto"), "plain torch.fft": ("off",)})

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


def counted_run(calc, want):
    """calc.run() with every launch count set to 0 just before and read
    just after; fails unless the counts are ``want``. Returns (WFData,
    counts, seconds)."""
    wf, counts, run_s = launches_of(lambda: calc.run(progress=False))
    print(f"  launches {counts}, expected {want}")
    require(counts == want, "the path did not run exactly its kernels")
    return wf, counts, run_s


def frame_at(calc, traj, fused="auto", resident="auto"):
    """Frame 0's k-space exit waves under the given dispatch flags."""
    import torch
    from pyslice_tpu_torch.engine.pipeline import frame_exit_waves
    with dispatch(fused, resident):
        out = frame_exit_waves(traj.positions[0], calc._probes_array(),
                               calc.spec)
        torch.cuda.synchronize()
    return out


def check_frame0(calc, traj, w):
    _, rel, res = errors(w[:, 0], frame_at(calc, traj, "off"))
    print(f"  frame 0, kernels vs plain path: max|d|/max|ref| {rel:.3e}  "
          f"residual {res:.3e}")
    require(res <= MAX_RESIDUAL, "kernel path disagrees with plain path")


def frame_times(calc, traj, card, run_s, n_frames, ways, rounds=5):
    """Median ms/frame of each way (label -> dispatch flags) over
    ``rounds`` rounds taken in turns, the order reversed every other
    round."""
    import numpy as np
    times = {label: [] for label in ways}
    for r in range(rounds):
        for label in (list(ways) if r % 2 == 0 else list(ways)[::-1]):
            t0 = time.perf_counter()
            frame_at(calc, traj, *ways[label])
            times[label].append(1e3 * (time.perf_counter() - t0))
    med = {label: float(np.median(ts)) for label, ts in times.items()}
    parts = ", ".join(f"{label} {ms:.2f}" for label, ms in med.items())
    print(f"  ms/frame, median of {rounds} ({calc.nx}x{calc.ny} x "
          f"{calc.n_probes} probes x {calc.nz} slices, rasterizer included): "
          f"{parts}; run() {1e3 * run_s / n_frames:.2f} ms/frame over "
          f"{n_frames} frames; card {card}")
    return med


def quick_start_phase(dev, card, tmp, n_frames=QUICK_FRAMES, lx=102.25,
                      fast_grid=False, grid=N_ODD):
    """Phases 6 and 7: the README quick start. An hBN dump written with
    write_lammps_dump, TrajectoryLoader, a plane wave through
    MultisliceCalculator; one K6 launch a frame and nothing else. Returns
    the K6 launch count and the trajectory."""
    import numpy as np
    import torch
    import pyslice_tpu_torch as pt
    from pyslice_tpu_torch.io.lammps import write_lammps_dump
    from pyslice_tpu_torch.ops import fused_step as fs
    from pyslice_tpu_torch.ops import fused_step_resident as fr

    dump = f"{tmp}/hbn_{n_frames}.lammpstrj"
    src = hbn_box(lx, n_frames)
    t0 = time.perf_counter()
    write_lammps_dump(dump, np.where(src.atom_types == 5, 1, 2),
                      src.positions, src.velocities, src.box_matrix)
    traj = pt.TrajectoryLoader(dump, timestep=0.005,
                               atom_mapping={1: "B", 2: "N"}).load()
    print(f"  wrote and loaded {dump.rsplit('/', 1)[-1]}: {traj.n_atoms} "
          f"atoms x {traj.n_frames} frames in "
          f"{time.perf_counter() - t0:.1f} s")
    require(traj.n_frames == n_frames and set(traj.atom_types) == {5, 7},
            "TrajectoryLoader output")
    calc = pt.MultisliceCalculator(device=dev)
    calc.setup(traj, aperture=0.0, voltage_eV=100e3, sampling=0.1,
               slice_thickness=0.5, device_output=True, use_cache=False,
               fast_grid=fast_grid)
    print(f"  grid {calc.nx}x{calc.ny}x{calc.nz}, {calc.n_probes} probe")
    require((calc.nx, calc.ny, calc.n_probes) == (grid, grid, 1),
            f"expected a 1 x {grid}^2 plane wave")
    want = dict.fromkeys(fs.launches, 0)
    want["k6"] = n_frames
    wf, counts, run_s = counted_run(calc, want)
    engine = "pow2" if fast_grid else "mixed"
    print(f"  K6 plan and grid {fr.last_launch}")
    require(fr.last_launch["engine"] == engine, f"K6 ran not the {engine} "
            "engine")
    w = wf.wavefunction_data
    require(tuple(w.shape) == (1, n_frames, grid, grid, 1)
            and bool(torch.isfinite(torch.view_as_real(w)).all()),
            f"WFData {tuple(w.shape)}")
    check_frame0(calc, traj, w)
    chain = "A/B/C chain" if fast_grid else "K4/K5 chain"
    frame_times(calc, traj, card, run_s, n_frames,
                {"K6": ("auto", "auto"), chain: ("auto", "off"),
                 "plain torch.fft": ("off", "auto")})
    tac = pt.TACAWData(wf)
    spec, diff = tac.spectrum(), tac.diffraction()
    print(f"  TACAW spectrum {spec.shape}, diffraction {diff.shape}")
    require(spec.shape == (n_frames,) and np.isfinite(spec).all(),
            "TACAW spectrum")
    require(diff.shape == (grid, grid) and np.isfinite(diff).all(),
            "TACAW diffraction")
    return counts["k6"], traj


def odd_stem_phase(dev, card, traj, n_frames=N_FRAMES):
    """Phase 8: 16-probe STEM on the 1023^2 box through the K4/K5 chain.
    Returns the launch counts."""
    import numpy as np
    import pyslice_tpu_torch as pt
    from pyslice_tpu_torch.ops import fused_step as fs

    traj = traj.slice_timesteps(list(range(n_frames)))
    calc = pt.MultisliceCalculator(device=dev)
    calc.setup(traj, aperture=30.0, voltage_eV=100e3, sampling=0.1,
               slice_thickness=0.5,
               probe_positions=pt.probe_grid([10, 90], [10, 90], 4, 4),
               device_output=True, use_cache=False)
    print(f"  {traj.n_atoms} atoms, {traj.n_frames} frames, grid "
          f"{calc.nx}x{calc.ny}x{calc.nz}, {calc.n_probes} probes")
    require((calc.nx, calc.ny, calc.n_probes) == (N_ODD, N_ODD, N_PROBES),
            "expected 16 probes at 1023^2")
    want = dict.fromkeys(fs.launches, 0)
    want.update(k4=traj.n_frames * calc.nz, k5=traj.n_frames * (calc.nz - 1))
    wf, counts, run_s = counted_run(calc, want)
    check_frame0(calc, traj, wf.wavefunction_data)
    frame_times(calc, traj, card, run_s, traj.n_frames,
                {"K4/K5 chain": ("auto", "auto"),
                 "plain torch.fft": ("off", "auto")})
    adf = pt.HAADFData(wf).calculateADF(45)
    print(f"  HAADF {adf.shape}; ADF range {adf.min():.4e}..{adf.max():.4e}")
    require(adf.shape == (4, 4) and np.isfinite(adf).all() and adf.min() > 0,
            "HAADF image")
    return counts


def check_rel(name, got, want):
    """A real tensor (vbar) against its reference: max|d|/max|ref|."""
    d, rel, _ = errors(got, want)
    print(f"  {name}: max|d| {d:.3e}  max|d|/max|ref| {rel:.3e}")
    require(rel <= MAX_REL, f"{name} disagrees")
    return d


def adjoint_kernel_phase(dev, P=N_PROBES, nz=N_SLICES,
                         sizes=(("k7", N_GRID), ("k8", N_ODD))):
    """Phase 9: K7 and K8 on P pairs against their plain version, and each
    adjoint chain against its plain twin. Returns the JSON records keyed by
    kernel."""
    import numpy as np
    import torch
    from pyslice_tpu_torch.core.constants import (interaction_parameter,
                                                  wavelength)
    from pyslice_tpu_torch.ops import fused_step as fs
    from pyslice_tpu_torch.ops import fused_step_adjoint as fa

    lam, sigma = wavelength(100e3), interaction_parameter(100e3)
    kernels = {"k7": (fa.row_pass_bwd, fa.fused_adjoint_chain),
               "k8": (fa.row_pass_mr_bwd, fa.fused_adjoint_chain_odd)}
    g = torch.Generator(device=dev).manual_seed(3)
    records = {}
    for key, n in sizes:
        row_bwd, chain = kernels[key]
        state = torch.randn((2 * P, n, n), dtype=torch.complex64,
                            device=dev, generator=g)
        sv = torch.randn((n, n), device=dev, generator=g) * 20.0
        t = torch.complex(torch.cos(sv), torch.sin(sv))
        err = 0.0
        # last mode reads no transmission: one case covers it
        for mode, label, tt in (("mid", "planes", t), ("mid", "phase", sv),
                                ("last", "", None)):
            got = row_bwd(mode, state, tt, sigma)
            want = fa._plain_row_pass_bwd(mode, state, tt, sigma)
            err = max(err, check(f"{key.upper()} {mode:4s} {label:6s} pairs",
                                 got[0], want[0]))
            check_rel(f"{key.upper()} {mode:4s} {label:6s} vbar", got[1],
                      want[1])
            again = row_bwd(mode, state, tt, sigma)
            torch.cuda.synchronize()
            require(torch.equal(again[1], got[1])
                    and torch.equal(again[0], got[0]),
                    f"{key.upper()} {mode} {label}: two launches differ")
        print(f"  {key.upper()}: two launches give the same bits, pairs and "
              "vbar, in every mode")
        del got, want, again
        a, gout = state[:P].clone(), state[P:].clone()
        v = torch.randn((nz, n, n), device=dev, generator=g) * 50.0
        ks = np.fft.fftfreq(n, 0.1)
        kw = dict(sigma=sigma, lam=lam, dz=0.5)
        lam0, vbar = chain(a, gout, v, ks, ks, **kw)
        lam0_p, vbar_p = fa.fused_adjoint_chain_plain(a, gout, v, ks, ks,
                                                      **kw)
        check(f"{key.upper()} chain ({nz} slices) lambda_0", lam0, lam0_p)
        check_rel(f"{key.upper()} chain ({nz} slices) vbar", vbar, vbar_p)
        chain_ms = (cuda_ms(lambda: chain(a, gout, v, ks, ks, **kw), reps=3),
                    cuda_ms(lambda: fa.fused_adjoint_chain_plain(
                        a, gout, v, ks, ks, **kw), reps=3))
        print(f"  {key.upper()} chain at {P}x{n}^2x{nz}: {chain_ms[0]:.3f} ms,"
              f" plain {chain_ms[1]:.3f} ms")
        del a, gout, v, lam0, vbar, lam0_p, vbar_p
        vb = torch.empty((n, n), device=dev)
        timing = (cuda_ms(lambda: row_bwd("mid", state, t, sigma, out=state,
                                          vbar=vb)),
                  cuda_ms(lambda: fa._plain_row_pass_bwd("mid", state, t,
                                                         sigma)))
        records.update(records_for({key: err}, {key: timing},
                                   {key: kernel_bound("pairs", P, n)},
                                   f"{P} pairs x {n}^2, mid"))
        plan = dict(fs.last_launch[key])
        print(f"    {key.upper()} tile plan and persistent grid at {P} pairs "
              f"x {n}^2: {plan}")
        records[key]["plan"] = plan
        del state
    return records


class counted_calls:
    """Replace ``owner.name`` (a method or a module function) by a wrapper
    that counts its calls; restores the original on exit. With
    ``launches``, each call runs under ``launches_of`` and ``log`` holds its
    (launch counts, seconds); with ``events``, CUDA events are recorded
    around each call, and ``ms()`` sums them."""

    def __init__(self, owner, name, launches=False, events=False):
        self.owner, self.name = owner, name
        self.launches, self.events = launches, events
        self.calls, self.log, self.marks = 0, [], []

    def __enter__(self):
        import torch
        orig = self.orig = getattr(self.owner, self.name)

        def counted(*args, **kwargs):
            self.calls += 1
            if self.events:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            if self.launches:
                out, counts, seconds = launches_of(
                    lambda: orig(*args, **kwargs))
                self.log.append((counts, seconds))
            else:
                out = orig(*args, **kwargs)
            if self.events:
                end.record()
                self.marks.append((start, end))
            return out

        setattr(self.owner, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)

    def ms(self):
        """Summed device ms between each call's events."""
        import torch
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.marks)


def require_step_counts(log, want, what):
    for i, (counts, _) in enumerate(log):
        require(counts == want, f"{what} step {i}: launches {counts}, "
                f"expected {want}")


def step_want(keys, nz):
    """Launches of one gradient step of a 16-position minibatch on a
    chain family (forward A/K4 nz, B/K5 nz-1; backward entry A/K4 1,
    B/K5 nz-1, K7/K8 nz-1)."""
    from pyslice_tpu_torch.ops import fused_step as fs
    row, col, bwd = keys
    want = dict.fromkeys(fs.launches, 0)
    want.update({row: nz + 1, col: 2 * (nz - 1), bwd: nz - 1})
    return want


def msp_phase(dev, card, lx, grid, keys, scan=MSP_SCAN, batch=MSP_BATCH,
              steps=MSP_STEPS):
    """Phase 10: multislice ptychography on frame 0 of the hBN box of side
    lx. Returns (K7/K8 launches of the kernel run, the data, the
    calculator, the trajectory)."""
    import numpy as np
    import torch
    import pyslice_tpu_torch as pt
    from pyslice_tpu_torch.analysis import ptychography as ptycho
    from pyslice_tpu_torch.core.dtypes import SINGLE
    from pyslice_tpu_torch.ops import fused_step as fs

    traj = hbn_box(lx, 1)
    calc = pt.MultisliceCalculator(device=dev)
    # a dense scan at the box centre: neighbouring probes (~1 A wide at
    # 30 mrad) overlap, so every minibatch constrains the same region
    half = 0.5 * MSP_STEP_A * (scan - 1)
    span = [0.5 * lx - half, 0.5 * lx + half]
    calc.setup(traj, aperture=30.0, voltage_eV=100e3, sampling=0.1,
               slice_thickness=0.5,
               probe_positions=pt.probe_grid(span, span, scan, scan),
               device_output=True, use_cache=False)
    require((calc.nx, calc.ny) == (grid, grid), f"expected {grid}^2")
    nz = calc.nz
    wf = calc.run(progress=False)
    data = (wf.wavefunction_data[:, 0, :, :, 0].abs() ** 2).cpu().numpy()
    positions = np.asarray(calc.probe_positions, np.float64)
    probe = calc.base_probe
    print(f"  data: {data.shape[0]} positions, {grid}^2, {nz} slices, "
          "from the kernel forward")

    # Gradients of one minibatch loss at half the frame's potential. At
    # V = 0 the dark-field model pixels are roundoff, and so is their part
    # of the gradient; near the solution the gradient is a small remainder
    # of cancelling terms. Float32 against float64 on the CPU at 256^2, the
    # probe gradient's max|d|/max|ref| is 1.6 at V = 0, 1.3e-4 at 0.5 V and
    # 6.7e-4 at 0.9 V.
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    amps = f32(ptycho._detector_amplitudes(data))
    first = ptycho._epoch_batches(len(positions), batch, 1, 0)[0]
    idx = torch.as_tensor(first, device=dev).long()
    v_true = pt.rasterize(torch.as_tensor(traj.positions[0], device=dev),
                          calc.spec.plan)
    kx, ky = f32(probe.kxs), f32(probe.kys)

    def grads():
        v = (0.5 * v_true).requires_grad_()
        modes = probe.array[None].clone().requires_grad_()
        val = ptycho._msp_loss(v, modes, f32(positions)[idx], amps[idx], kx,
                               ky, eV=100e3, dz=0.5, prec=SINGLE,
                               loss="amplitude", reg_tv=0.0)
        return torch.autograd.grad(val, [v, modes])

    for k in fs.launches:
        fs.launches[k] = 0
    g_kernel = grads()
    torch.cuda.synchronize()
    counts = dict(fs.launches)
    require(counts == step_want(keys, nz),
            f"gradient launches {counts}, expected {step_want(keys, nz)}")
    with dispatch("off"):
        g_plain = grads()
    for name, a, b in zip(("dL/dV", "dL/dprobe"), g_kernel, g_plain):
        d, rel, _ = errors(a, b)
        print(f"  {name}, kernels vs plain path: max|d| {d:.3e}  "
              f"max|d|/max|ref| {rel:.3e}")
        require(rel <= GRAD_REL, f"{name} disagrees between the paths")
    del g_kernel, g_plain

    times = {}
    k_bwd = 0
    for label, flag in (("kernels", "auto"), ("plain torch.fft", "off")):
        with dispatch(flag), counted_calls(ptycho._MspRun, "step", launches=True) as c:
            rec = pt.msp_reconstruct(data, positions, probe, n_slices=nz,
                                     dz=0.5, batch=batch, steps=steps)
        losses = rec["losses"]
        print(f"  {label}: losses {np.array2string(losses, precision=6)}; "
              f"launches a step {c.log[0][0]}")
        require(len(c.log) == steps, "msp_reconstruct took another step count")
        require_step_counts(c.log, step_want(keys, nz) if flag == "auto"
                            else dict.fromkeys(fs.launches, 0), label)
        require(np.isfinite(losses).all() and losses[-1] < losses[0],
                f"{label}: losses not finite and falling")
        require(np.isfinite(rec["potential"]).all(), "non-finite potential")
        times[label] = float(np.median([s for _, s in c.log]))
        if flag == "auto":
            k_bwd = sum(counts[keys[2]] for counts, _ in c.log)
    print(f"  s/step, median of {steps} ({batch} positions x {grid}^2 x {nz} "
          f"slices): kernels {times['kernels']:.4f}, plain torch.fft "
          f"{times['plain torch.fft']:.4f}; card {card}")
    return k_bwd, data, calc, traj


def refine_phase(data, calc, traj, steps=REFINE_STEPS, batch=MSP_BATCH):
    """Phase 11: refine_structure from frame 0 jittered by 0.02 A in plane;
    every step's launches checked. Returns the K7 launches."""
    import numpy as np
    import pyslice_tpu_torch as pt
    from pyslice_tpu_torch.engine import inverse

    pos0 = np.array(traj.positions[0], np.float64)
    pos0[:, :2] += np.random.default_rng(0).normal(0, 0.02,
                                                   (len(pos0), 2))
    with counted_calls(inverse, "_step", launches=True) as c:
        rec = pt.refine_structure(data, np.asarray(calc.probe_positions),
                                  calc.base_probe, pos0, traj.atom_types,
                                  calc.zs, steps=steps, batch=batch)
    print(f"  {len(pos0)} atoms, losses "
          f"{np.array2string(rec['losses'], precision=6)}; launches a step "
          f"{c.log[0][0]}; s/step {np.median([s for _, s in c.log]):.4f}")
    require(len(c.log) == steps, "refine_structure took another step count")
    require_step_counts(c.log, step_want(("a", "b", "k7"), calc.nz),
                        "refine_structure")
    require(np.isfinite(rec["losses"]).all()
            and np.isfinite(rec["positions"]).all(), "non-finite refinement")
    return sum(counts["k7"] for counts, _ in c.log)


# --- config 5's streaming path (phases 12-15) --------------------------------

STREAM_LX, STREAM_FRAMES, STREAM_SCAN = 204.75, 8, 8   # 2048^2, 64 probes
STREAM_CHUNK, STREAM_BLOCK = 16, 4
STREAM_FREQS = [10.0, 20.0, 40.0]     # THz; bins 0, 1, 2 at 8 frames
# Config 5's f!=0 amplitudes, kernel stream against the plain float32 one:
# 1.5e-4 of max|ref| read on an H100 (the plain stream is itself 3.8e-4 to
# 4.4e-4 from complex128 there), so the bar is twice that reading.
STREAM_MAX_REL = 3e-4
RESUME_PROBES, RESUME_CHUNK = 16, 8
SM_LX, SM_SCAN, SM_FRAMES = 51.15, 48, 2      # 512^2, 2,304 probes
SM_DIRECT_CHUNK = 256
FP_CONFIGS = 8


def gib(nbytes):
    return nbytes / 2 ** 30


def stream_setup(dev, lx, n_frames, scan):
    """Config 5's set-up (tools/bench_configs.py _config5): the hBN box of
    side lx with n_frames thermal frames, its grid at 0.1 A and 0.5 A
    slices, 100 kV, and a scan x scan probe grid over [20, 180] A of the
    204.75 A box (scaled with lx) at 25 mrad."""
    import pyslice_tpu_torch as pt
    from pyslice_tpu_torch.engine.pipeline import SimSpec
    traj = hbn_box(lx, n_frames)
    g = pt.grid_from_trajectory(traj, sampling=0.1, slice_thickness=0.5)
    plan = pt.make_plan(g.xs, g.ys, g.zs, traj.positions, traj.atom_types)
    spec = SimSpec.create(g, plan, 100e3)
    span = [20.0 * lx / 204.75, 180.0 * lx / 204.75]
    pg = pt.probe_grid(span, span, scan, scan)
    base = pt.Probe(g.xs, g.ys, 25.0, 100e3, device=dev)
    return traj, g, spec, pg, base


def per_bin(got, want):
    """errors() of each bin of two (bins, ...) tensors, each scaled by the
    largest |ref| over all bins (the f=0 bin is zero after the mean
    correction)."""
    scale = want.abs().max().item()
    return [errors(got[i], want[i], scale) for i in range(len(want))]


def amplitude(st, f):
    """Bin f's complex amplitude over all probes of a StreamingTACAW run:
    the accumulator, less the mean at f=0 (|.|^2 is the intensity)."""
    import torch
    return torch.cat([
        acc[f] - st._mean_chunks[i] if st._track_mean and st.bins[f] == 0
        else acc[f] for i, acc in enumerate(st._acc_chunks)])


def stream_phase(dev, card, lx=STREAM_LX, n_frames=STREAM_FRAMES,
                 scan=STREAM_SCAN, chunk=STREAM_CHUNK, block=STREAM_BLOCK):
    """Phase 12: config 5, StreamingTACAW and StreamingHAADF at full width.
    Returns (launch counts of the main path's runs, the set-up and the
    kernel stream's intensity)."""
    import dataclasses
    import numpy as np
    import torch
    import pyslice_tpu_torch as pt
    from pyslice_tpu_torch.core.dtypes import DOUBLE
    from pyslice_tpu_torch.engine import streaming
    from pyslice_tpu_torch.engine.pipeline import exit_waves_from_potential
    from pyslice_tpu_torch.ops import fused_step as fs

    traj, g, spec, pg, base = stream_setup(dev, lx, n_frames, scan)
    probes = pt.create_batched_probes(base, pg).array
    P, nx, ny, nz = len(pg), g.nx, g.ny, g.nz
    n_chunks = -(-P // chunk)
    order = [int(t) for t in np.random.default_rng(0).permutation(n_frames)]
    blocks = [order[i:i + block] for i in range(0, n_frames, block)]
    print(f"  {traj.n_atoms} atoms, grid {nx}x{ny}x{nz}, {P} probes in "
          f"{n_chunks} chunks of {chunk}, frequencies {STREAM_FREQS} THz; "
          f"frames cut from config 5's 1000 to {n_frames} for the run's time "
          f"limit, fed in blocks {blocks}")

    def stream(fused):
        st = pt.StreamingTACAW(spec, probes, n_frames, traj.timestep,
                               frequencies=STREAM_FREQS, probe_chunk=chunk)
        with dispatch(fused):
            for b in blocks:
                st.add_frame_block(b, traj.positions[b])
        return st

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with counted_calls(streaming, "rasterize") as rast:
        st, counts, run_s = launches_of(lambda: stream("auto"))
    peak = torch.cuda.max_memory_allocated() - before
    want = want_counts(a=n_frames * n_chunks * nz,
                       b=n_frames * n_chunks * (nz - 1),
                       c=n_frames * n_chunks)
    print(f"  bins {st.bins.tolist()} ({st.frequencies.tolist()} THz); "
          f"launches {counts}, expected {want}; rasterizations "
          f"{rast.calls} for {n_frames} frames; {run_s:.2f} s")
    require(counts == want, "the stream did not run exactly its kernels")
    require(rast.calls == n_frames, "not one rasterization a frame")
    nb = len(st.bins)
    c64 = probes.element_size()
    plane = nx * ny * c64
    state = (nb + 1) * P * plane
    print(f"  peak memory over the stream {gib(peak):.2f} GiB above the "
          f"{gib(before):.2f} allocated before: state {gib(state):.2f} GiB "
          f"({nb} bins + the mean, {state / 1e9:.2f} GB), probes "
          f"{gib(P * plane):.2f} GiB ({P * plane / 1e9:.2f} GB), one chunk's "
          f"exit waves {gib(chunk * plane):.2f} GiB "
          f"({chunk * plane / 1e9:.2f} GB); card {card}")
    inten = st.intensity()
    require(tuple(inten.shape) == (nb, P, nx, ny)
            and bool(torch.isfinite(inten).all()), "stream intensity")

    # Reference 1: the same stream with the kernels off, and the exact
    # stream (complex128, plain): each bin's complex amplitude (the
    # accumulator, less the mean at f=0; |.|^2 is the intensity). The f!=0
    # bins are small differences of large waves: float32 itself, plain or
    # kernels, lands ~4e-4 of max|ref| from the exact stream there, so the
    # kernel stream is held to the residual bar against both, to
    # STREAM_MAX_REL against the plain stream, and to at most twice the
    # plain float32 stream's max|d| against the exact one.
    plain = stream("off")
    exact = pt.StreamingTACAW(
        dataclasses.replace(spec, precision=DOUBLE),
        pt.create_batched_probes(pt.Probe(spec.grid.xs, spec.grid.ys, 25.0,
                                          100e3, precision=DOUBLE,
                                          device=dev), pg).array,
        n_frames, traj.timestep, frequencies=STREAM_FREQS, probe_chunk=chunk)
    for b in blocks:
        exact.add_frame_block(b, traj.positions[b])
    for f, b in enumerate(st.bins):
        pairs = {k: errors(amplitude(x, f), amplitude(y, f))[1:] for k, x, y
                 in (("kernels vs plain", st, plain),
                     ("kernels vs complex128", st, exact),
                     ("plain vs complex128", plain, exact))}
        print(f"  bin {b} ({st.frequencies[f]:.1f} THz) amplitudes, "
              "max|d|/max|ref| and residual: " + "; ".join(
                  f"{k} {rel:.3e}, {res:.3e}"
                  for k, (rel, res) in pairs.items()))
        require(pairs["kernels vs plain"][0] <= STREAM_MAX_REL
                and pairs["kernels vs plain"][1] <= MAX_RESIDUAL
                and pairs["kernels vs complex128"][1] <= MAX_RESIDUAL
                and pairs["kernels vs complex128"][0]
                <= 2 * pairs["plain vs complex128"][0],
                f"bin {b}: kernel stream disagrees with plain or complex128")
    del exact
    inten_p = plain.intensity()
    del plain
    for i, (_, rel, res) in enumerate(per_bin(inten, inten_p)):
        print(f"  bin {st.bins[i]} intensity, kernels vs plain: "
              f"max|d|/max|ref| {rel:.3e}  residual {res:.3e}")
    del inten_p

    # The fold alone, on one chunk's k-space waves (this and the timings
    # below fold into st, whose results are taken).
    pos0 = torch.as_tensor(traj.positions[0], device=dev)
    v = pt.rasterize(pos0, spec.plan)
    psi = exit_waves_from_potential(v, probes[:chunk], spec)[..., 0]
    phases = st._phases([0])[0]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    streaming.fold(st._acc_chunks[0], st._mean_chunks[0], psi, phases)
    torch.cuda.synchronize()
    fold_peak = torch.cuda.max_memory_allocated() - held
    fold_ms = cuda_ms(lambda: streaming.fold(st._acc_chunks[0],
                                             st._mean_chunks[0], psi,
                                             phases), reps=5)
    fold_bytes = (2 * (nb + 1) + 1) * chunk * plane
    print(f"  fold alone ({nb} bins + mean, {chunk} x {nx}^2): peak "
          f"{fold_peak / 1e9:.3f} GB above the {held / 1e9:.2f} GB held "
          f"(limit one chunk's exit waves, {chunk * plane / 1e9:.2f} GB); "
          f"{fold_ms:.3f} ms, bound {1e3 * fold_bytes / HBM_BYTES_S:.3f} ms "
          f"(HBM, {fold_bytes / 1e9:.2f} GB)")
    require(fold_peak <= chunk * plane, "the fold allocates more than one "
            "chunk's exit waves")

    # ms a frame in turns, the fold's share, A/B/C at the chunk's shape.
    pos = torch.as_tensor(traj.positions[order[0]], device=dev)
    times = {"kernels": [], "plain torch.fft": []}
    flags = {"kernels": "auto", "plain torch.fft": "off"}
    for r in range(3):
        for way in (list(times) if r % 2 == 0 else list(times)[::-1]):
            with dispatch(flags[way]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st._fold_frame(pos, phases)
                torch.cuda.synchronize()
            times[way].append(1e3 * (time.perf_counter() - t0))
    med = {way: float(np.median(ts)) for way, ts in times.items()}
    with counted_calls(streaming, "fold", events=True) as folds, \
            counted_calls(st, "_fold_frame", events=True) as frame:
        st._fold_frame(pos, phases)
    fold_share = folds.ms() / frame.ms()
    print(f"  ms/frame, median of 3 in turns ({P} probes x {nx}^2 x {nz} "
          f"slices, rasterizer included): kernels {med['kernels']:.2f}, "
          f"plain torch.fft {med['plain torch.fft']:.2f}; one frame's device "
          f"time {frame.ms():.2f} ms, the fold {folds.ms():.2f} ms "
          f"({100 * fold_share:.1f}%, {folds.calls} calls); run "
          f"{1e3 * run_s / n_frames:.2f} ms/frame over {n_frames}; card {card}")
    buf = probes[:chunk].clone()
    t = torch.complex(torch.cos(v[0]), torch.sin(v[0]))
    prop = fs.fresnel_plane(spec.plan.kxs, spec.plan.kys, spec.lam, spec.dz,
                            device=dev)
    abc = {"a": cuda_ms(lambda: fs.row_pass("mid", buf, t, out=buf)),
           "b": cuda_ms(lambda: fs.col_pass(buf, prop, out=buf)),
           "c": cuda_ms(lambda: fs.kconvert(buf))}
    plain_abc = {"a": cuda_ms(lambda: fs._plain_row_pass("mid", buf, t)),
                 "b": cuda_ms(lambda: fs._plain_col_pass(buf, prop)),
                 "c": cuda_ms(lambda: fs._plain_kconvert(buf))}
    kern = n_chunks * (nz * abc["a"] + (nz - 1) * abc["b"] + abc["c"])
    print(f"  at {chunk}x{nx}^2, ms (plain torch.fft, bound): A mid "
          f"{abc['a']:.4f} ({plain_abc['a']:.4f}, "
          f"{kernel_bound('pass', chunk, nx)['bound_ms']:.4f}), B "
          f"{abc['b']:.4f} ({plain_abc['b']:.4f}, same bound), C "
          f"{abc['c']:.4f} ({plain_abc['c']:.4f}, "
          f"{kernel_bound('kconvert', chunk, nx)['bound_ms']:.4f}): "
          f"{kern:.2f} ms of kernels a frame")
    del buf, t, psi, v

    # Reference 2: the batch path on the first chunk's probes.
    calc = pt.MultisliceCalculator(device=dev)
    calc.setup(traj, aperture=25.0, voltage_eV=100e3, sampling=0.1,
               slice_thickness=0.5, probe_positions=pg[:chunk],
               device_output=True, use_cache=False)
    wf = calc.run(progress=False)
    tac = pt.TACAWData(wf)
    fi = [int(np.argmin(np.abs(tac.frequencies - f))) for f in st.frequencies]
    ref = tac.intensity[:, fi].transpose(0, 1)          # (bins, chunk, ...)
    for i, (_, rel, _) in enumerate(per_bin(inten[:, :chunk], ref)):
        print(f"  bin {st.bins[i]}, stream vs batch TACAWData on {chunk} "
              f"probes: max|d|/max|ref| {rel:.3e}")
        require(rel <= MAX_REL, f"bin {st.bins[i]}: stream disagrees with "
                "the batch path")
    adf = pt.HAADFData(wf).calculateADF(45)
    del wf, tac, ref, calc

    # StreamingHAADF on the same frames.
    sh = pt.StreamingHAADF(spec, probes, pg, collection_angle=45,
                           probe_chunk=chunk)
    _, h_counts, h_s = launches_of(lambda: [
        sh.add_frame_block(traj.positions[b], b) for b in blocks])
    require(h_counts == want, f"StreamingHAADF launches {h_counts}")
    img = sh.image()
    cols = chunk // scan
    d = np.abs(img[:, :cols] - adf).max() / np.abs(adf).max()
    print(f"  StreamingHAADF image {img.shape}, range {img.min():.4e}.."
          f"{img.max():.4e}; launches as the TACAW stream's; {h_s:.2f} s; "
          f"vs HAADFData.calculateADF(45) on {chunk} probes: max|d|/max|ref| "
          f"{d:.3e}")
    require(img.shape == (scan, scan) and np.isfinite(img).all()
            and img.min() > 0, "StreamingHAADF image")
    require(d <= MAX_REL, "StreamingHAADF disagrees with HAADFData")
    total = {k: counts[k] + h_counts[k] for k in counts}
    return total, (traj, spec, pg, base), inten[:, :RESUME_PROBES].clone()


def resume_phase(dev, card, setup, inten_ref, tmp, n_probes=RESUME_PROBES,
                 chunk=RESUME_CHUNK, block=STREAM_BLOCK):
    """Phase 13: the phase-12 frames as a gzipped LAMMPS dump (17 digits,
    exact in float64), streamed by TrajectoryStream into StreamingTACAW; a
    checkpoint after the first block restored into a fresh stream. The
    same from an 8-digit dump, whose rounding is printed, not held to the
    bar. Returns the launch counts."""
    import gzip
    import os
    import shutil
    import numpy as np
    import torch
    import pyslice_tpu_torch as pt
    from pyslice_tpu_torch.io.lammps import write_lammps_dump

    traj, spec, pg, base = setup
    n_frames = traj.n_frames

    def dump(digits):
        plain = f"{tmp}/config5_{digits}.lammpstrj"
        t0 = time.perf_counter()
        write_lammps_dump(plain, np.where(traj.atom_types == 5, 1, 2),
                          traj.positions, traj.velocities, traj.box_matrix,
                          digits=digits)
        with open(plain, "rb") as src, gzip.open(plain + ".gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
        os.remove(plain)
        source = pt.TrajectoryStream(plain + ".gz", timestep=traj.timestep,
                                     atom_mapping={1: "B", 2: "N"},
                                     block_frames=block)
        print(f"  wrote {digits}-digit config5.lammpstrj.gz "
              f"({os.path.getsize(plain + '.gz') / 1e6:.1f} MB) in "
              f"{time.perf_counter() - t0:.1f} s: {source.count_frames()} "
              f"frames of {source.n_atoms} atoms")
        require(source.count_frames() == n_frames
                and source.n_atoms == traj.n_atoms, "TrajectoryStream")
        return source

    probes = pt.create_batched_probes(base, pg[:n_probes]).array

    def stream(source):
        st = pt.StreamingTACAW(spec, probes, n_frames, traj.timestep,
                               frequencies=STREAM_FREQS, probe_chunk=chunk)
        for idx, pos in source.blocks():
            st.add_frame_block(list(idx), pos)
        return st

    source = dump(17)

    def run():
        full = stream(source)
        part = pt.StreamingTACAW(spec, probes, n_frames, traj.timestep,
                                 frequencies=STREAM_FREQS, probe_chunk=chunk)
        blocks = source.blocks()
        idx, pos = next(blocks)
        blocks.close()
        part.add_frame_block(list(idx), pos)
        ck = f"{tmp}/checkpoint"
        t0 = time.perf_counter()
        part.save_checkpoint(ck)
        save_s = time.perf_counter() - t0
        resumed = pt.StreamingTACAW(spec, probes, n_frames, traj.timestep,
                                    frequencies=STREAM_FREQS,
                                    probe_chunk=chunk)
        t0 = time.perf_counter()
        seen = resumed.restore(ck)
        load_s = time.perf_counter() - t0
        require(seen == set(int(t) for t in idx), f"restored frames {seen}")
        for idx, pos in source.blocks():
            if int(idx[0]) not in seen:
                resumed.add_frame_block(list(idx), pos)
        nbytes = sum(os.path.getsize(f"{ck}/{n}") for n in os.listdir(ck))
        return full.intensity(), resumed.intensity(), save_s, load_s, nbytes

    (full, resumed, save_s, load_s, nbytes), counts, run_s = launches_of(run)
    n_chunks = -(-n_probes // chunk)
    fed = 2 * n_frames
    want = want_counts(a=fed * n_chunks * spec.grid.nz,
                       b=fed * n_chunks * (spec.grid.nz - 1),
                       c=fed * n_chunks)
    print(f"  {n_probes} probes in chunks of {chunk}: checkpoint "
          f"{nbytes / 1e9:.2f} GB saved in {save_s:.1f} s, restored in "
          f"{load_s:.1f} s; launches {counts}, expected {want}; {run_s:.1f} s")
    require(counts == want, "the streams did not run exactly their kernels")
    require(torch.equal(full, resumed), "resume is not bit-identical")
    rel = max(r for _, r, _ in per_bin(full, inten_ref))
    print(f"  resumed stream == uninterrupted stream, bit for bit; vs phase "
          f"12 (another frame order and chunking): max|d|/max|ref| "
          f"{rel:.3e}")
    require(rel <= MAX_REL, "the dump-fed stream disagrees with phase 12")
    rounded = stream(dump(8)).intensity()
    rel8 = max(r for _, r, _ in per_bin(rounded, inten_ref))
    print(f"  the 8-digit dump (positions rounded by up to 5e-6 A) vs phase "
          f"12: max|d|/max|ref| {rel8:.3e} (printed, not held to the bar)")
    return counts


def smatrix_phase(dev, card, lx=SM_LX, scan=SM_SCAN, n_frames=SM_FRAMES):
    """Phase 14a: StreamingHAADF at 512^2 over a scan x scan scan: the
    automatic route (the S-matrix above SMATRIX_MIN_PROBES) against the
    direct route in 256-probe chunks. Returns the K6 launches."""
    import numpy as np
    import torch
    import pyslice_tpu_torch as pt
    from pyslice_tpu_torch.engine import smatrix

    traj, g, spec, _, base = stream_setup(dev, lx, n_frames, scan)
    span = [0.5, lx - 0.5]
    pg = pt.probe_grid(span, span, scan, scan)
    probes = pt.create_batched_probes(base, pg).array
    P = len(pg)
    sm = pt.StreamingHAADF(spec, probes, pg, collection_angle=45, mrad=25.0)
    nb = sm._beams.n_beams if sm.use_smatrix else 0
    n_bc = -(-nb // min(64, max(nb, 1)))
    print(f"  grid {g.nx}x{g.ny}x{g.nz}, {P} probes: S-matrix route "
          f"{sm.use_smatrix} (SMATRIX_MIN_PROBES {smatrix.SMATRIX_MIN_PROBES});"
          f" {nb} beams in {n_bc} chunks of <= 64, S "
          f"{nb * g.nx * g.ny * probes.element_size() / 1e9:.2f} GB")
    require(sm.use_smatrix, "the automatic route did not pick the S-matrix")
    direct = pt.StreamingHAADF(spec, probes, pg, collection_angle=45,
                               mrad=25.0, use_smatrix=False,
                               probe_chunk=SM_DIRECT_CHUNK)
    n_pc = -(-P // SM_DIRECT_CHUNK)
    k6 = 0
    for name, st, per in (("S-matrix", sm, n_bc), ("direct", direct, n_pc)):
        _, counts, s = launches_of(lambda: [
            st.add_frame(traj.positions[f], frame_index=f)
            for f in range(n_frames)])
        want = want_counts(k6=n_frames * per)
        print(f"  {name}: launches {counts}, expected {want}; "
              f"{1e3 * s / n_frames:.1f} ms/frame over {n_frames}")
        require(counts == want, f"{name} route launches")
        k6 += counts["k6"]
    a, b = sm.image(), direct.image()
    rel = np.abs(a - b).max() / np.abs(b).max()
    print(f"  images {a.shape}: S-matrix vs direct max|d|/max|ref| {rel:.3e}")
    require(a.shape == (scan, scan) and np.isfinite(a).all() and a.min() > 0,
            "S-matrix image")
    require(rel <= MAX_REL, "S-matrix route disagrees with the direct route")
    pos = torch.as_tensor(traj.positions[0], device=dev)
    times = {"S-matrix": [], "direct": []}
    for r in range(2):
        for name in (list(times) if r % 2 == 0 else list(times)[::-1]):
            st = sm if name == "S-matrix" else direct
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st._fold_frame(pos)
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0))
    print(f"  ms/frame in turns (S-matrix, direct, direct, S-matrix): "
          f"S-matrix {times['S-matrix']}, direct {times['direct']}; "
          f"card {card}")
    return k6


def thermal_phase(dev, card, lx=102.25, n=N_ODD, n_configs=FP_CONFIGS):
    """Phase 14b: frozen_phonon_haadf at 16 probes and
    frozen_phonon_diffraction as a plane wave on the 1023^2 box. Returns
    the launch counts."""
    import numpy as np
    import torch
    import pyslice_tpu_torch as pt
    from pyslice_tpu_torch.engine import thermal
    from pyslice_tpu_torch.ops import fused_step_resident as fr

    traj = hbn_box(lx, 1)
    pg = pt.probe_grid([10, 90], [10, 90], 4, 4)
    gen = lambda: torch.Generator().manual_seed(0)
    (img, xs, ys), counts, s = launches_of(lambda: thermal.frozen_phonon_haadf(
        traj, pg, n_configs=n_configs, generator=gen(), aperture=30.0,
        device=dev))
    nz = pt.grid_from_trajectory(traj, 0.1, 0.5).nz
    want = want_counts(k4=n_configs * nz, k5=n_configs * (nz - 1))
    print(f"  frozen_phonon_haadf, {n_configs} configurations x 16 probes: "
          f"launches {counts}, expected {want}; image {img.shape} range "
          f"{img.min():.4e}..{img.max():.4e}; {s:.2f} s")
    require(counts == want, "frozen_phonon_haadf launches")
    require(img.shape == (4, 4) and np.isfinite(img).all() and img.min() > 0,
            "frozen-phonon HAADF image")
    patt, dcounts, s = launches_of(lambda: thermal.frozen_phonon_diffraction(
        traj, n_configs=n_configs, generator=gen(), device=dev))
    dwant = want_counts(k6=n_configs)
    print(f"  frozen_phonon_diffraction, plane wave: launches {dcounts}, "
          f"expected {dwant}; K6 engine {fr.last_launch.get('engine')}; pattern "
          f"{patt.shape}, sum {patt.sum():.4e}; {s:.2f} s")
    require(dcounts == dwant and fr.last_launch.get("engine") == "mixed",
            "frozen_phonon_diffraction launches")
    require(patt.shape == (n, n) and np.isfinite(patt).all()
            and patt.sum() > 0, "frozen-phonon diffraction pattern")
    counts["k6"] = dcounts["k6"]
    return counts


def surface_phase(dev, card, lx=102.35, n=N_GRID):
    """Phase 15: Potential -> Propagate on frame 0 of phase 5's box at 16
    probes, against the plain multislice. Returns the launch counts."""
    import numpy as np
    import pyslice_tpu_torch as pt

    traj = hbn_box(lx, 1)
    g = pt.grid_from_trajectory(traj, sampling=0.1, slice_thickness=0.5)
    pot = pt.Potential(g.xs, g.ys, g.zs, traj.positions[0], traj.atom_types,
                       device=dev)
    probe = pt.create_batched_probes(
        pt.Probe(g.xs, g.ys, 30.0, 100e3, device=dev),
        pt.probe_grid([10, 90], [10, 90], 4, 4))
    out, counts, s = launches_of(lambda: pt.Propagate(probe, pot))
    want = want_counts(a=g.nz, b=g.nz - 1)
    print(f"  Potential {tuple(pot.array.shape)} on {pot.device}, Propagate "
          f"{tuple(out.shape)}: launches {counts}, expected {want}")
    require((g.nx, g.ny) == (n, n) and tuple(out.shape) == (16, n, n),
            "Propagate shape")
    require(counts == want, "Propagate launches")
    dz = float(np.asarray(pot.zs)[1] - np.asarray(pot.zs)[0])
    check("Propagate vs plain multislice", out,
          pt.multislice(probe.array, pot.array_szy, pot.kxs, pot.kys,
                        eV=100e3, dz=dz, fused=False))
    return counts


# --- the imaging toolkit (phases 16-19) --------------------------------------

HR_LX, HR_CONFIGS = 102.25, 4           # phase 16's box: 1023^2 x 14 slices
HR_CS = HR_CC = 1.2e7                   # 1.2 mm, in Angstrom
HR_DE, HR_NODES = 0.8, 7                # eV (FWHM), chromatic nodes
HR_APERTURE, HR_BEAM, HR_TILTS = 20.0, 0.5, 5   # mrad, mrad, 5 x 5 tilts
EWR_DEFOCI = tuple(float(d) for d in range(-400, 501, 100))  # A
EWR_ITERS = 400   # tests/test_ewr.py's multislice round trip: 400, 5e-3
CS_SCAN, CS_MRAD, CS_FWHM = 16, 30.0, 0.8   # chromatic_stem: 256 probes
PED_MRAD, PED_AZIMUTHS = 20.0, 12
PR_N, PR_SAMPLING, PR_DZ = 256, 0.1, 1.0    # phase retrieval at 256^2
PR_ATOMS, PR_MRAD, PR_MAX_PHASE = 71, 20.0, 0.05
PR_SCAN, PR_STEP, PR_CHUNK = 64, 0.4, 256   # 64 x 64 positions at 0.4 A
EPIE_EVERY, EPIE_SWEEPS = 2, 40             # ePIE on the 32 x 32 subset


def generator():
    """A CPU generator seeded 0: every run of a path draws the same
    frozen-phonon configurations."""
    import torch
    return torch.Generator().manual_seed(0)


def kernel_vs_plain(name, fn, want, unit, n_units, rounds=1):
    """fn() with the kernels ("auto") and with the plain path ("off") in
    turns: one untimed warm-up run each way, then ``rounds`` rounds (the
    order reversed every other round), each run's launch counts reset just
    before it and read just after: ``want`` with the kernels, none plain.
    Prints the median wall time a unit of work of each way, and the device
    time of one more kernel run (``device_seconds``) with the share of the
    kernel wall the device was idle. Returns (the kernel run's output, the
    plain run's, the first timed kernel run's counts)."""
    import numpy as np
    ways = [("kernels", "auto", want), ("plain torch.fft", "off",
                                        want_counts())]
    for _, flag, _ in ways:
        with dispatch(flag):
            fn()
    outs, times, first = {}, {w[0]: [] for w in ways}, None
    for r in range(rounds):
        for label, flag, w in (ways if r % 2 == 0 else ways[::-1]):
            with dispatch(flag):
                out, counts, s = launches_of(fn)
            if label == "kernels" and first is None:
                print(f"  {name}: launches {counts}, expected {w}")
                first = counts
            require(counts == w, f"{name} ({label}): launches {counts}")
            outs[label] = out
            times[label].append(1e3 * s / n_units)
    med = {label: float(np.median(t)) for label, t in times.items()}
    with dispatch("auto"):
        dev_ms = 1e3 * device_seconds(fn) / n_units
    print(f"  {name}: ms/{unit} (median of {rounds} in turns, after a "
          "warm-up) " + ", ".join(f"{label} {ms:.2f}"
                                  for label, ms in med.items())
          + f"; kernels' device time {dev_ms:.2f} ms/{unit}, idle "
          f"{100 * (1 - dev_ms / med['kernels']):.1f}% of the wall")
    return outs["kernels"], outs["plain torch.fft"], first


def check_np(name, got, want):
    """check() on two host arrays."""
    import numpy as np
    import torch
    return check(name, torch.as_tensor(np.asarray(got)),
                 torch.as_tensor(np.asarray(want)))


def add_counts(total, counts):
    """Sum launch counts, K6 under its engine's record key."""
    from pyslice_tpu_torch.ops import fused_step_resident as fr
    for k, v in counts.items():
        if k == "k6":
            k = "k6_pow2" if fr.last_launch.get("engine") == "pow2" \
                else "k6_mixed"
        total[k] = total.get(k, 0) + v
    return total


def hrtem_phase(dev, card, lx=HR_LX, n=N_ODD, n_configs=HR_CONFIGS,
                n_tilts=HR_TILTS, beam=HR_BEAM, rounds=2):
    """Phase 16: hrtem_image on the 1023^2 hBN box at Scherzer focus
    (Cs 1.2 mm, 20 mrad objective aperture, Cc 1.2 mm at dE 0.8 eV over 7
    nodes, a 0.5 mrad illumination cone as 5 x 5 tilts snapped to distinct
    lattice tilts, 4 frozen-phonon configurations): the tilt batch through
    K4/K5 at 1023^2 and through A/B/C with fast_grid (1024^2), the coherent
    plane wave through K6, each against the plain path. Returns the launch
    counts of the kernel runs."""
    import numpy as np
    import pyslice_tpu_torch as pt
    from pyslice_tpu_torch.core.constants import wavelength
    from pyslice_tpu_torch.engine import ctem
    from pyslice_tpu_torch.ops import fused_step_resident as fr

    traj = hbn_box(lx, 1)
    lam = wavelength(100e3)
    ab = pt.Aberrations(C3=HR_CS)
    df = ab.scherzer_defocus(lam)
    g = pt.grid_from_trajectory(traj, sampling=0.1, slice_thickness=0.5)
    tilts, _ = ctem._tilt_series(beam, n_tilts, lam)
    quanta = np.round(ctem.snapped_tilts(tilts, g.lx, g.ly)
                      * np.array([g.lx, g.ly])).astype(int)
    print(f"  Scherzer defocus {df:.2f} A; {len(quanta)} tilts in units of "
          f"1/{g.lx} A^-1: {sorted(set(map(tuple, quanta.tolist())))}")
    require(len(set(map(tuple, quanta.tolist()))) == n_tilts ** 2,
            "the snapped tilts are not distinct")
    from pyslice_tpu_torch.engine.coherence import (defocus_series,
                                                    defocus_spread)
    nodes, _ = defocus_series(defocus_spread(HR_CC, HR_DE, 100e3), HR_NODES)
    t0 = time.perf_counter()
    ctem._defocus_transfers(g.kxs(), g.kys(), lam,
                            pt.Aberrations(C1=df, C3=HR_CS), nodes,
                            HR_APERTURE, None, None)
    print(f"  the {HR_NODES} transfer functions a call (NumPy on the host): "
          f"{1e3 * (time.perf_counter() - t0):.1f} ms")

    def run(beam=beam, fast_grid=False):
        return lambda: pt.hrtem_image(
            traj, aberrations=ab, defocus=df, objective_aperture=HR_APERTURE,
            Cc=HR_CC, dE=HR_DE, n_nodes=HR_NODES, beam_semiangle=beam,
            n_tilts=n_tilts, n_configs=n_configs, generator=generator(),
            fast_grid=fast_grid, device=dev)

    nz = g.nz
    fast = pt.grid_from_trajectory(traj, 0.1, 0.5, fast_grid=True).nx
    total, images = {}, {}
    for key, fn, want, m in (
            ("tilts", run(), want_counts(k4=n_configs * nz,
                                         k5=n_configs * (nz - 1)), n),
            ("fast_grid", run(fast_grid=True),
             want_counts(a=n_configs * nz, b=n_configs * (nz - 1),
                         c=n_configs), fast),
            ("coherent", run(beam=0.0), want_counts(k6=n_configs), n)):
        (img, xs, ys), (plain, _, _), counts = kernel_vs_plain(
            f"HRTEM {key} ({m}^2)", fn, want, "configuration", n_configs,
            rounds)
        if key == "coherent":
            require(fr.last_launch.get("engine") == "mixed",
                    "the coherent image ran not K6's mixed engine")
        add_counts(total, counts)
        check_np(f"HRTEM {key} image, kernels vs plain", img, plain)
        contrast = float(img.std() / img.mean())
        print(f"  HRTEM {key} image {img.shape}: mean {img.mean():.4e}, "
              f"contrast (std/mean) {contrast:.4e}")
        require(img.shape == (m, m) and (len(xs), len(ys)) == (m, m)
                and np.isfinite(img).all() and img.min() >= 0
                and contrast > 1e-4, f"HRTEM {key} image")
        images[key] = img
    # a partially coherent cone blurs: no more contrast than the plane wave
    require(images["tilts"].std() <= images["coherent"].std() * 1.01,
            "the tilt average raised the contrast")
    return total


def ewr_phase(dev, card, lx=HR_LX, n=N_ODD, defoci=EWR_DEFOCI,
              n_iters=EWR_ITERS):
    """Phase 17: one exit wave of phase 16's box (a plane wave through K6),
    its focal series at 10 defoci and iwfr_reconstruct from it (plain
    torch.fft; no kernel launches). Holds tests/test_ewr.py's bars: the
    residual falls, and the wave agrees with the truth up to its global
    phase. Returns the launch counts of the exit wave."""
    import numpy as np
    import torch
    import pyslice_tpu_torch as pt
    from pyslice_tpu_torch.core.constants import wavelength
    from pyslice_tpu_torch.engine.pipeline import SimSpec, frame_exit_waves

    traj = hbn_box(lx, 1)
    g = pt.grid_from_trajectory(traj, sampling=0.1, slice_thickness=0.5)
    plan = pt.make_plan(g.xs, g.ys, g.zs, traj.positions, traj.atom_types)
    spec = SimSpec.create(g, plan, 100e3)
    wave = torch.ones((1, n, n), dtype=torch.complex64, device=dev)
    kw, counts, _ = launches_of(
        lambda: frame_exit_waves(traj.positions[0], wave, spec)[0, ..., 0])
    require(counts == want_counts(k6=1), f"exit wave launches {counts}")
    counts = add_counts({}, counts)
    psi = torch.fft.ifft2(torch.fft.ifftshift(kw))
    lam = wavelength(100e3)

    def solve():
        imgs = pt.focal_series(psi, defoci, plan.kxs, plan.kys, lam=lam)
        return imgs, pt.iwfr_reconstruct(imgs, defoci, plan.kxs, plan.kys,
                                         lam=lam, n_iters=n_iters)

    (imgs, (rec, errs)), ecounts, s = launches_of(solve)
    require(ecounts == want_counts(), f"focal series / IWFR ran kernels "
            f"{ecounts}")
    truth = psi.cpu().numpy()
    aligned = rec * np.exp(1j * np.angle(np.vdot(rec.ravel(),
                                                 truth.ravel())))
    rel = float(np.linalg.norm(aligned - truth) / np.linalg.norm(truth))
    print(f"  focal series {tuple(imgs.shape)} at defoci {list(defoci)} "
          f"A; IWFR {n_iters} iterations: residual {errs[0]:.3e} -> "
          f"{errs[min(49, n_iters - 1)]:.3e} (50) -> {errs[-1]:.3e}, "
          f"|rec - truth| / |truth| {rel:.3e} (global phase "
          f"removed); {1e3 * s / n_iters:.2f} ms/iteration, focal series "
          "included; card " + card)
    require(np.isfinite(errs).all() and errs[-1] < errs[0] * 1e-2,
            "the IWFR residual did not fall")
    require(rel < 5e-3, "IWFR disagrees with the exit wave")
    return counts


def coherence_phase(dev, card, lx=HR_LX, n=N_ODD, n_configs=HR_CONFIGS,
                    scan=CS_SCAN):
    """Phase 18: on the 1023^2 box, chromatic_stem (16 x 16 probes at 30
    mrad, 7 nodes x 4 configurations, 0.8 A source blur; K4/K5 on the
    direct route), precession_diffraction (20 mrad, 12 azimuths x 4
    configurations; K6) and chromatic_diffraction (a 20 mrad CBED probe,
    7 nodes x 4 configurations; K6), each against the plain path. Returns
    the launch counts of the kernel runs."""
    import numpy as np
    import pyslice_tpu_torch as pt
    from pyslice_tpu_torch.engine import coherence, smatrix

    traj = hbn_box(lx, 1)
    nz = pt.grid_from_trajectory(traj, 0.1, 0.5).nz
    pg = pt.probe_grid([10, 90], [10, 90], scan, scan)
    require(len(pg) < smatrix.SMATRIX_MIN_PROBES, "scan on the S-matrix")
    runs = n_configs * HR_NODES
    total = {}
    (img, xs, ys), (plain, _, _), counts = kernel_vs_plain(
        f"chromatic_stem, {len(pg)} probes", lambda: coherence.chromatic_stem(
            traj, pg, Cc=HR_CC, dE=HR_DE, aperture=CS_MRAD,
            n_nodes=HR_NODES, n_configs=n_configs, generator=generator(),
            source_fwhm=CS_FWHM, device=dev),
        want_counts(k4=runs * nz, k5=runs * (nz - 1)),
        "configuration and node", runs)
    add_counts(total, counts)
    check_np("chromatic_stem image, kernels vs plain", img, plain)
    print(f"  chromatic_stem image {img.shape}, range {img.min():.4e}.."
          f"{img.max():.4e}")
    require(img.shape == (scan, scan) and np.isfinite(img).all()
            and img.min() > 0, "chromatic_stem image")
    for name, fn, n_runs in (
            (f"precession_diffraction, {PED_MRAD} mrad x {PED_AZIMUTHS} "
             "azimuths", lambda: pt.precession_diffraction(
                 traj, PED_MRAD, n_azimuth=PED_AZIMUTHS, n_configs=n_configs,
                 generator=generator(), device=dev),
             PED_AZIMUTHS * n_configs),
            (f"chromatic_diffraction, {PED_MRAD} mrad CBED",
             lambda: coherence.chromatic_diffraction(
                 traj, Cc=HR_CC, dE=HR_DE, aperture=PED_MRAD,
                 n_nodes=HR_NODES, n_configs=n_configs,
                 generator=generator(), device=dev), runs)):
        pat, plain, counts = kernel_vs_plain(
            name, fn, want_counts(k6=n_runs), "run", n_runs)
        add_counts(total, counts)
        check_np(f"{name.split(',')[0]}, kernels vs plain", pat, plain)
        require(pat.shape == (n, n) and np.isfinite(pat).all()
                and pat.min() >= 0 and pat.sum() > 0, f"{name} pattern")
    return total


def weak_phase_problem(dev, n, scan):
    """tests/test_ptychography.py's problem at a full scan: a 256^2 grid
    (xs = linspace(0, 25.6, 256, endpoint=False)), PR_ATOMS random B/N
    atoms in two 1 A slices from NumPy's default_rng(3) (the fixture's
    density), the potential scaled to a 0.05 rad maximum phase, 100 kV,
    a 20 mrad probe, scan x scan positions at PR_STEP (64 x 64 at 0.4 A
    on the card)."""
    import numpy as np
    import torch
    import pyslice_tpu_torch as pt
    from pyslice_tpu_torch.core.constants import interaction_parameter
    lx = n * PR_SAMPLING
    xs = np.linspace(0, lx, n, endpoint=False)
    rng = np.random.default_rng(3)
    pos = rng.random((1, PR_ATOMS, 3)) * np.array([lx, lx, 2 * PR_DZ - 0.1])
    types = rng.choice([5, 7], PR_ATOMS).astype(np.int32)
    plan = pt.make_plan(xs, xs, np.array([0.0, PR_DZ]), pos, types)
    v = pt.rasterize(pos[0], plan, device=dev)
    sigma = interaction_parameter(100e3)
    v = v * (PR_MAX_PHASE / (sigma * v.abs().max()))
    axis = np.arange(scan) * PR_STEP
    positions = np.array([(sx, sy) for sx in axis for sy in axis])
    base = pt.Probe(xs, xs, PR_MRAD, 100e3, device=dev)
    return dict(v=v, base=base, axis=axis, positions=positions,
                phi_true=(sigma * v.sum(dim=0)).double().cpu().numpy())


def retrieval_phase(dev, card):
    """Phase 19: 4D-STEM phase retrieval at 256^2. The exit waves of 4,096
    positions through pt.multislice in chunks of 256 (K6's register engine,
    2 slices) against the plain loop; scan_grid_data on the k-space waves;
    SSB on all 4,096 patterns, iCoM, and ePIE on the 32 x 32 subset for 40
    sweeps with the probe known, each held to tests/test_ptychography.py's
    recovery bars. Returns the launch counts of the kernel run."""
    import numpy as np
    import torch
    import pyslice_tpu_torch as pt
    from pyslice_tpu_torch.analysis import ptychography as ptycho
    from pyslice_tpu_torch.core.constants import wavelength

    p = weak_phase_problem(dev, PR_N, PR_SCAN)
    base, n = p["base"], PR_N
    P = len(p["positions"])
    n_chunks = P // PR_CHUNK

    def exit_waves():
        out = torch.empty((P, n, n), dtype=torch.complex64, device=dev)
        for c in range(n_chunks):
            sl = slice(c * PR_CHUNK, (c + 1) * PR_CHUNK)
            probes = pt.shift_probes(base.array, base.kxs, base.kys,
                                     p["positions"][sl])
            out[sl] = pt.multislice(probes, p["v"], base.kxs, base.kys,
                                    eV=100e3, dz=PR_DZ)
        return out

    ew, plain, counts = kernel_vs_plain(
        f"exit waves, {P} positions in chunks of {PR_CHUNK} at {n}^2",
        exit_waves, want_counts(k6=n_chunks), "chunk", n_chunks)
    counts = add_counts({}, counts)
    check("exit waves, kernels vs plain", ew, plain)
    del plain
    kwave = torch.fft.fftshift(torch.fft.fft2(ew), dim=(-2, -1))
    del ew
    kxs = np.fft.fftshift(base.kxs)
    wf = pt.WFData(probe_positions=p["positions"], time=np.array([0.0]),
                   kxs=kxs, kys=kxs, layer=np.array([0]),
                   wavefunction_data=kwave[:, None, :, :, None], probe=base)
    t0 = time.perf_counter()
    sxs, sys_ys, data4d = pt.scan_grid_data(wf)
    print(f"  scan_grid_data: {data4d.shape} {data4d.dtype}, "
          f"{data4d.nbytes / 1e9:.2f} GB, {time.perf_counter() - t0:.2f} s")
    require(data4d.shape == (PR_SCAN, PR_SCAN, n, n)
            and np.allclose(sxs, p["axis"]), "scan_grid_data stack")
    del wf, kwave
    stack = torch.as_tensor(data4d, device=dev)
    q_band = 2 * (PR_MRAD * 1e-3) / wavelength(100e3)
    sub = round(PR_STEP / PR_SAMPLING)
    truth_full = band_limit(p["phi_true"], base.kxs, q_band)
    truth = truth_full[::sub, ::sub]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ssb = pt.ssb_reconstruct(stack, sxs, sys_ys, kxs, kxs, probe=base)
    s_ssb = time.perf_counter() - t0
    c, ratio = pearson(ssb["phase"], truth), spread_ratio(ssb["phase"],
                                                          truth)
    print(f"  SSB on {P} patterns: {s_ssb:.2f} s; phase correlation {c:.4f}"
          f", radian ratio {ratio:.4f}; trotter pixels "
          f"{int(ssb['trotter_pixels'].sum())}")
    require(c > 0.9 and 0.9 < ratio < 1.1, "SSB recovery")

    a2 = np.fft.ifftshift(np.abs(base.to_cpu()) ** 2)
    a2_hat = np.fft.fft2(a2)
    blurred = np.real(np.fft.ifft2(np.fft.fft2(p["phi_true"])
                                   * np.conj(a2_hat) / a2_hat[0, 0].real))
    t0 = time.perf_counter()
    icom = pt.icom_reconstruct(stack, sxs, sys_ys, kxs, kxs, probe=base)
    s_icom = time.perf_counter() - t0
    c, ratio = pearson(icom["phase"], blurred[::sub, ::sub]), spread_ratio(
        icom["phase"], blurred[::sub, ::sub])
    print(f"  iCoM: {s_icom:.2f} s; phase correlation {c:.4f}, radian "
          f"ratio {ratio:.4f}, curl_rms {icom['curl_rms']:.4f}")
    require(c > 0.95 and 0.85 < ratio < 1.15 and icom["curl_rms"] < 0.2,
            "iCoM recovery")
    del stack

    idx = np.array([i * PR_SCAN + j for i in range(0, PR_SCAN, EPIE_EVERY)
                    for j in range(0, PR_SCAN, EPIE_EVERY)])
    epie_data = data4d.reshape(P, n, n)[idx]
    pt.epie_reconstruct(epie_data[:4], p["positions"][idx][:4], base,
                        n_iters=1, update_probe=False)       # warm-up
    rec, ecounts, s = launches_of(lambda: pt.epie_reconstruct(
        epie_data, p["positions"][idx], base, n_iters=EPIE_SWEEPS,
        alpha=0.9, update_probe=False))
    require(ecounts == want_counts(), f"ePIE ran kernels {ecounts}")
    losses = rec["losses"]
    phase = band_limit(np.angle(rec["object"]), base.kxs, q_band)
    c = pearson(phase, truth_full)
    wall = s / EPIE_SWEEPS
    device_s = device_seconds(lambda: pt.epie_reconstruct(
        epie_data, p["positions"][idx], base, n_iters=1, alpha=0.9,
        update_probe=False))
    print(f"  ePIE on {len(idx)} patterns, {EPIE_SWEEPS} sweeps: loss "
          f"{losses[0]:.4e} -> {losses[-1]:.4e}, phase correlation {c:.4f};"
          f" {wall:.3f} s/sweep, device {device_s:.3f} s/sweep, idle "
          f"{100 * (1 - device_s / wall):.1f}%; card {card}")
    require(np.isfinite(losses).all() and losses[-1] < losses[0] / 10
            and c > 0.8, "ePIE recovery")
    return counts


def device_seconds(fn):
    """Device time of one run of fn(): the sum of the self device times of
    its kernels in a torch.profiler trace."""
    return device_profile(fn)[0]


def device_profile(fn):
    """One run of fn() under torch.profiler: (the sum of the self device
    times of its device events in seconds, the number of those events —
    kernels, copies and sets —, fn's result)."""
    import torch
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        out = fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            us += e.self_cuda_time_total if t is None else t
            n += e.count
    return 1e-6 * us, n, out


def band_limit(img, ks, q_max):
    import numpy as np
    mask = (np.asarray(ks)[:, None] ** 2 + np.asarray(ks)[None, :] ** 2) \
        < q_max ** 2
    return np.real(np.fft.ifft2(np.fft.fft2(img) * mask))


def pearson(a, b):
    import numpy as np
    a = np.asarray(a, np.float64) - np.mean(a)
    b = np.asarray(b, np.float64) - np.mean(b)
    return float((a * b).sum()
                 / np.sqrt((a ** 2).sum() * (b ** 2).sum() + 1e-30))


def spread_ratio(rec, truth):
    """|rec - mean| / |truth - mean|: the reconstruction's scale in
    radians against the truth's."""
    import numpy as np
    return float(np.linalg.norm(rec - rec.mean())
                 / np.linalg.norm(truth - truth.mean()))


CLI_REL = 1e-6      # CLI outputs against the same run through the API
CAL_LX, CAL_SCAN, CAL_CHUNK = 25.55, 128, 2048   # phase 21: 256^2 grid
CAL_MRAD, CAL_PSF = 25.0, 1.2                    # mrad; PSF sigma (px)
CAL_INJECT = ((0.1, -0.06, 0.04), (-0.08, 0.05, 0.06))   # descan (px)
CAL_F32_REL = 1e-4  # float32 calibration's CoM against float64's
# The 2/3 antialiasing band limit: the electrons it removes are lost as past
# a camera's edge, so the total-count image the affine fit reads shows the
# lattice (with every electron kept, that image is flat and the fit reads
# rounding noise).
CAL_BAND = 2 / 3


def load_npys(out, names):
    import numpy as np
    return {name: np.load(f"{out}/{name}.npy") for name in names}


def same_outputs(what, got, want, bar):
    """max|d|/max|ref| of every array of ``got`` against ``want``, each at
    most ``bar``; prints whether they are bit-identical."""
    import numpy as np
    for name, w in want.items():
        g = got[name]
        require(g.shape == w.shape and np.isfinite(g).all(),
                f"{what}: {name} {g.shape}")
        rel = float(np.abs(g - w).max() / np.abs(w).max())
        print(f"  {what}: {name} max|d|/max|ref| {rel:.3e}, bit-identical "
              f"{bool(np.array_equal(g, w))}")
        require(rel <= bar, f"{what}: {name} disagrees")


def cli_phase(dev, card, tmp, n_frames=QUICK_FRAMES, lx=102.25, grid=N_ODD,
              haadf_frames=N_FRAMES):
    """Phase 20: the command line on the card at the quick start's width.
    Phase 6's dump (written anew), ``info``, the native parser against the
    Python one, ``run --mode tacaw`` in process (one K6 launch a frame and
    nothing else; its outputs against MultisliceCalculator + TACAWData),
    ``run --mode haadf`` at 1023^2 (K4/K5) and with --fast-grid at 1024^2
    (A/B/C), the HAADF config replayed by ``python3 -m pyslice_tpu_torch``
    in a subprocess, and ``devices``. Returns the launch counts."""
    import os
    import numpy as np
    import pyslice_tpu_torch as pt
    from pyslice_tpu_torch.__main__ import main
    from pyslice_tpu_torch.io import lammps as lammps_io
    from pyslice_tpu_torch.io import native_loader

    dump = f"{tmp}/hbn_cli.lammpstrj"
    src = hbn_box(lx, n_frames)
    lammps_io.write_lammps_dump(dump, np.where(src.atom_types == 5, 1, 2),
                                src.positions, src.velocities,
                                src.box_matrix)
    on = ["--device", dev.type]
    require(main(["info", dump, "--no-cache", *on]) == 0, "info")
    native_loader.get_lib()                     # build outside the timing
    t0 = time.perf_counter()
    native = native_loader.parse_dump(dump)
    t_native = time.perf_counter() - t0
    require(native_loader.last_parser == "native", "the native parser did "
            f"not run ({native_loader.last_parser})")
    t0 = time.perf_counter()
    python = lammps_io.parse_lammps_dump(dump)
    t_python = time.perf_counter() - t0
    require(all(a.dtype == b.dtype and np.array_equal(a, b)
                for a, b in zip(native, python)),
            "native and Python parsers differ")
    print(f"  parse {src.n_atoms} atoms x {n_frames} frames: native "
          f"{t_native:.3f} s, Python {t_python:.3f} s "
          f"({t_python / t_native:.1f}x), arrays bit-equal")

    common = ["--trajectory", dump, "--timestep", "0.005", "--atom-mapping",
              "1=B,2=N", "--voltage-eV", "100000", "--sampling", "0.1",
              "--slice-thickness", "0.5", "--no-cache", "--cache-root",
              f"{tmp}/psi", *on]
    total = {}

    def counted_cli(what, argv, want):
        rc, counts, s = launches_of(lambda: main(argv))
        print(f"  {what}: exit {rc}, {s:.1f} s, launches {counts}, "
              f"expected {want}")
        require(rc == 0 and counts == want, f"{what}: exit {rc}, launches")
        add_counts(total, counts)

    out_t = f"{tmp}/cli_tacaw"
    counted_cli(f"run --mode tacaw ({n_frames} frames, {grid}^2)",
                ["run", *common, "--mode", "tacaw", "--output-dir", out_t],
                want_counts(k6=n_frames))
    traj = pt.TrajectoryLoader(dump, timestep=0.005,
                               atom_mapping={1: "B", 2: "N"},
                               use_cache=False).load()
    calc = pt.MultisliceCalculator(device=dev)
    calc.setup(traj, aperture=0.0, voltage_eV=100e3, sampling=0.1,
               slice_thickness=0.5, device_output=True, use_cache=False)
    require((calc.nx, calc.ny) == (grid, grid), f"grid {calc.nx}")
    tac = pt.TACAWData(calc.run(progress=False))
    same_outputs("CLI tacaw vs MultisliceCalculator + TACAWData",
                 load_npys(out_t, ("frequencies", "spectrum",
                                   "diffraction")),
                 {"frequencies": tac.frequencies,
                  "spectrum": tac.spectrum(None),
                  "diffraction": tac.diffraction(None)}, CLI_REL)
    del tac, calc

    haadf = ["--mode", "haadf", "--aperture", "30", "--probe-grid",
             "10,90,10,90,4,4", "--max-frames", str(haadf_frames)]
    out_h = f"{tmp}/cli_haadf"
    for fast in (False, True):
        g = pt.grid_from_trajectory(traj, sampling=0.1, slice_thickness=0.5,
                                    fast_grid=fast)
        f, nz = haadf_frames, g.nz
        want = (want_counts(a=f * nz, b=f * (nz - 1), c=f) if fast
                else want_counts(k4=f * nz, k5=f * (nz - 1)))
        out = out_h + ("_fast" if fast else "")
        counted_cli(f"run --mode haadf, 16 probes x {f} frames at "
                    f"{g.nx}^2" + (" (--fast-grid)" if fast else ""),
                    ["run", *common, *haadf, "--output-dir", out]
                    + (["--fast-grid"] if fast else []), want)
        img = np.load(f"{out}/haadf_image.npy")
        print(f"    haadf_image {img.shape}, range {img.min():.4e}.."
              f"{img.max():.4e}")
        require(img.shape == (4, 4) and np.isfinite(img).all()
                and img.min() > 0, "HAADF image")

    out_s = f"{tmp}/cli_haadf_subprocess"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pyslice_tpu_torch", "run", "--config",
         f"{out_h}/config.json", "--output-dir", out_s, *on],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    print(f"  python3 -m pyslice_tpu_torch run --config (haadf): exit "
          f"{proc.returncode}, {time.perf_counter() - t0:.1f} s")
    require(proc.returncode == 0, f"the subprocess run failed:\n"
            f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    same_outputs("subprocess vs in-process",
                 load_npys(out_s, ("haadf_image",)),
                 load_npys(out_h, ("haadf_image",)), CLI_REL)
    require(main(["devices"]) == 0, "devices")
    return total


class OpCount:
    """Counts the operations dispatched on tensors of one device, by name:
    the aten operations PyTorch runs there (views excluded: they launch
    nothing), whatever number of kernels each one launches."""

    def __init__(self, device):
        import collections
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves
        kind = torch.device(device).type
        counter = self

        def on_device(x):
            if isinstance(x, torch.Tensor):
                return x.device.type == kind
            return isinstance(x, torch.device) and x.type == kind

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if not func.is_view and any(
                        on_device(x) for x in tree_leaves((args, kwargs))):
                    counter.ops[str(func)] += 1
                return func(*args, **kwargs)

        self.mode = Mode()
        self.ops = collections.Counter()

    def __call__(self, fn):
        """(fn(), its operations by name)."""
        self.ops.clear()
        with self.mode:
            out = fn()
        return out, dict(self.ops)


def calibration_phase(dev, card, tmp, lx=CAL_LX, scan=CAL_SCAN,
                      chunk=CAL_CHUNK):
    """Phase 21: measured-data calibration at a real 4D-STEM size. The hBN
    box of phase 19's width (25.55 A, 256^2, 14 slices) scanned at scan x
    scan positions (25 mrad, 100 kV, CAL_BAND) through MultisliceCalculator
    in probe chunks (K6), scan_grid_data's cube corrupted as
    tests/test_calibration.py corrupts it (PSF, sub-pixel descan, a hot and
    a dead pixel) behind a seeded dark frame and gain map, then
    calibrate_datacube on the card in float32 and float64, held to that
    test's bars, and again with the ellipse and affine resampling; per
    call its seconds, device time, idle share, peak memory and operation
    counts (the same at half the scan in each axis); the EMD file and
    ``calibrate`` when h5py imports. Returns the launch counts."""
    import numpy as np
    import torch
    import pyslice_tpu_torch as pt
    from pyslice_tpu_torch.__main__ import main, report_json
    from pyslice_tpu_torch.analysis import calibration as cal

    traj = hbn_box(lx, 1)
    pg = pt.probe_grid([0.0, lx], [0.0, lx], scan, scan)
    calc = pt.MultisliceCalculator(device=dev)
    calc.setup(traj, aperture=CAL_MRAD, voltage_eV=100e3, sampling=0.1,
               slice_thickness=0.5, probe_positions=pg, batch_size=chunk,
               device_output=True, use_cache=False,
               bandwidth_limit=CAL_BAND)
    n_chunks = -(-calc.n_probes // chunk)
    print(f"  {traj.n_atoms} atoms, grid {calc.nx}x{calc.ny}x{calc.nz}, "
          f"{calc.n_probes} probes in {n_chunks} chunks of {chunk}")
    wf, counts, run_s = counted_run(calc, want_counts(k6=n_chunks))
    total = add_counts({}, counts)
    print(f"  exit waves: {run_s:.2f} s")
    xs, ys, raw = pt.scan_grid_data(wf)
    kxs, kys, probe = wf.kxs, wf.kys, wf.probe
    del wf, calc
    nk = raw.shape[-1]
    cube_bytes = raw.nbytes
    raw = torch.as_tensor(raw, device=dev)
    print(f"  scan_grid_data: {tuple(raw.shape)} {raw.dtype}, "
          f"{cube_bytes / 1e9:.2f} GB")

    fx = torch.fft.fftfreq(nk, dtype=torch.float64, device=dev)
    psf = torch.exp(-2 * math.pi ** 2 * CAL_PSF ** 2
                    * (fx[:, None] ** 2 + fx[None, :] ** 2)).float()
    clean = torch.fft.ifft2(torch.fft.fft2(raw) * psf).real.clamp(min=0.0)
    del raw
    inject = np.array(CAL_INJECT)
    cube = cal.apply_descan(clean, inject, xs, ys, 1.0, subpixel=True)
    gen = torch.Generator().manual_seed(0)
    dark = (0.01 * float(cube.mean())
            * torch.rand((nk, nk), generator=gen)).to(dev)
    gain = (0.9 + 0.2 * torch.rand((nk, nk), generator=gen)).to(dev)
    cube = cube * gain + dark
    hot, dead = (nk // 3, nk // 4), (2 * nk // 3, nk // 2)
    cube[:, :, hot[0], hot[1]] = cube.max() * 50
    cube[:, :, dead[0], dead[1]] = 0.0
    dk, dky = float(kxs[1] - kxs[0]), float(kys[1] - kys[0])
    a_, by = 2.504, math.sqrt(3.0) * 2.504
    g_hbn = [[1 / a_, -1 / by], [0.0, 2 / by]]   # of (a, 0), (a/2, by/2)
    # the first call shifts the patterns by Fourier ramps (the JAX test's
    # call); the second by the default integer roll, then resamples them
    # with the ellipse and the affine fit: three gathers over the cube
    kw1 = dict(kxs=kxs, kys=kys, subpixel_descan=True)
    kw2 = dict(kxs=kxs, kys=kys, apply_ellipse=True, g_expected=g_hbn,
               apply_affine=True)

    def run(c, x, y, kw):
        return cal.calibrate_datacube(c, x, y, dark=dark, gain=gain, **kw)

    ops = OpCount(dev)

    def measured(label, c, kw):
        """One profiled, counted call (which also warms up cuFFT's plans
        and the allocator), one timed call, and the operation count at half
        the scan in each axis."""
        torch.cuda.empty_cache()
        dev_s, n_events, (_, by_op) = device_profile(
            lambda: ops(lambda: run(c, xs, ys, kw)))
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res = run(c, xs, ys, kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before
        half = c[::2, ::2].contiguous()
        dev_h, n_events_h, (res_h, by_op_h) = device_profile(
            lambda: ops(lambda: run(half, xs[::2], ys[::2], kw)))
        del half
        n_ops, n_ops_h = sum(by_op.values()), sum(by_op_h.values())
        if n_ops != n_ops_h:
            print(f"  operations that differ: " + ", ".join(
                f"{k} {by_op.get(k, 0)}/{by_op_h.get(k, 0)}"
                for k in sorted(set(by_op) | set(by_op_h))
                if by_op.get(k) != by_op_h.get(k)))
            print(f"  reports: {res['report']} / {res_h['report']}")
        del res_h
        print(f"  {label}: {wall:.3f} s a call, device {1e3 * dev_s:.1f} ms,"
              f" idle {100 * (1 - dev_s / wall):.1f}% of the wall; peak "
              f"{peak / 1e9:.2f} GB over the {c.nbytes / 1e9:.2f} GB cube "
              f"({peak / c.nbytes:.2f}x); device operations {n_ops} at "
              f"{scan}^2 and {n_ops_h} at {scan // 2}^2 positions; device "
              f"events (kernels, copies, sets) {n_events} and {n_events_h}")
        require(n_ops == n_ops_h, f"{label}: the device operations depend "
                "on the number of patterns")
        require(res["data"].dtype == c.dtype
                and bool(torch.isfinite(res["data"]).all())
                and bool(torch.isfinite(res["com"]).all()),
                f"{label}: calibrated cube {res['data'].dtype}, finite")
        res["data"] = None                  # only the fits are held
        return res

    def bars(label, res):
        """tests/test_calibration.py's bars. Its ``skewness < -0.1`` reads
        the statistic of the [0, pi) candidate before the 180-degree flip:
        a true rotation of 0 lands there as ~0 or as ~pi by its last bits,
        and the flip negates the statistic. The chosen branch's skewness,
        -|skewness|, is what the bar holds (the branch is determined by
        the data); the rotation bar holds that the branch is right."""
        bad = res["bad_pixels"].cpu().numpy()
        rot = math.degrees(res["rotation"]) % 360.0
        skew = res["rotation_diag"]["skewness"]
        slopes = (res["descan"]["coeffs"][:, 1:].cpu().numpy()
                  / np.array([[dk], [dky]]))
        ref_cube = cal.fix_pixels(clean, res["bad_pixels"])
        ref_com = cal.fit_descan(cal.com_field(ref_cube, kxs, kys), xs,
                                 ys)["corrected"]
        del ref_cube
        ref = pt.icom_reconstruct(None, xs, ys, kxs, kys, probe=probe,
                                  com=ref_com)
        got = pt.icom_reconstruct(None, xs, ys, kxs, kys, probe=probe,
                                  com=res["com"])
        err = float(np.abs(got["phase"] - ref["phase"]).max()
                    / np.abs(ref["phase"]).max())
        print(f"  {label}: bad pixels {int(bad.sum())} (hot {bad[hot]}, "
              f"dead {bad[dead]}), rotation {min(rot, 360 - rot):.4f} deg, "
              f"transpose {res['transpose']}, skewness {skew:.4f} (the "
              f"chosen branch's {-abs(skew):.4f}), descan slopes "
              f"{np.round(slopes, 5).tolist()} px (injected "
              f"{(-inject[:, 1:]).tolist()}), iCoM against the clean cube "
              f"{err:.4f}, curl {got['curl_rms']:.4f} (clean "
              f"{ref['curl_rms']:.4f})")
        for line in res["report"]:
            print(f"    - {line}")
        require(bad.sum() == 2 and bad[hot] and bad[dead], "bad pixels")
        require(min(rot, 360 - rot) < 1.0 and not res["transpose"]
                and -abs(skew) < -0.1, "rotation")
        require(np.abs(slopes + inject[:, 1:]).max() <= 0.005, "descan")
        require(err < 0.02 and got["curl_rms"] < ref["curl_rms"] * 1.2
                + 0.02, "iCoM from the calibrated CoM")

    def f32_vs_f64(label, r32, r64):
        d, rel, _ = errors(r32["com"], r64["com"])
        same_mask = bool(torch.equal(r32["bad_pixels"], r64["bad_pixels"]))
        print(f"  {label}, float32 vs float64: bad-pixel masks equal "
              f"{same_mask}, transpose {r32['transpose']} / "
              f"{r64['transpose']}, CoM max|d|/max|ref| {rel:.3e}")
        require(same_mask and r32["transpose"] == r64["transpose"]
                and rel <= CAL_F32_REL, f"{label}: float32 vs float64")

    r32 = measured("calibrate_datacube, float32", cube, kw1)
    bars("float32", r32)
    e32 = measured("with the ellipse and affine resampling, float32", cube,
                   kw2)
    cube64 = cube.double()
    del cube
    r64 = measured("calibrate_datacube, float64", cube64, kw1)
    bars("float64", r64)
    f32_vs_f64("calibrate_datacube", r32, r64)
    del r32, r64
    e64 = measured("with the ellipse and affine resampling, float64",
                   cube64, kw2)
    for label, r in (("float32", e32), ("float64", e64)):
        print(f"  ellipse and affine, {label}: ellipticity "
              f"{r['ellipse']['ellipticity']:.5f}, angle "
              f"{math.degrees(r['ellipse']['angle']):.2f} deg, A "
              f"{np.round(r['affine']['A'].cpu().numpy(), 5).tolist()}, "
              f"peak SNR {np.round(r['affine']['peak_snr'], 2).tolist()}")
    f32_vs_f64("with the ellipse and affine resampling", e32, e64)
    del e32, e64, clean

    try:
        import h5py  # noqa: F401
    except ImportError:
        print("  h5py does not import here: the EMD file and `calibrate` "
              "were not run (they are CPU-tested)")
        return total
    half = cube64[::2, ::2].float().contiguous()
    del cube64
    step = float(xs[2] - xs[0])
    src = f"{tmp}/raw.emd"
    t0 = time.perf_counter()
    pt.save_4dstem(src, half)
    np.save(f"{tmp}/dark.npy", dark.cpu().numpy())
    np.save(f"{tmp}/gain.npy", gain.cpu().numpy())
    print(f"  save_4dstem {tuple(half.shape)}: "
          f"{time.perf_counter() - t0:.2f} s")
    out = f"{tmp}/calibrated"
    t0 = time.perf_counter()
    rc = main(["calibrate", src, "--scan-step", repr(step), "--dark",
               f"{tmp}/dark.npy", "--gain", f"{tmp}/gain.npy",
               "--k-per-pixel", repr(dk), "--output-dir", out,
               "--device", dev.type])
    print(f"  calibrate (CLI, float64): exit {rc}, "
          f"{time.perf_counter() - t0:.2f} s")
    require(rc == 0, "calibrate")
    axis = np.arange(half.shape[0]) * step
    want = report_json(cal.calibrate_datacube(
        half.double(), axis, axis, dark=dark.cpu().numpy(),
        gain=gain.cpu().numpy(), k_per_pixel=dk))
    got = json.loads(open(f"{out}/report.json").read())
    require(got.keys() == want.keys(), "report.json keys")
    for k, w in want.items():
        g = got[k]
        if isinstance(w, float):
            ok = math.isclose(g, w, rel_tol=1e-9, abs_tol=1e-15)
        elif isinstance(w, list) and w and isinstance(w[0], list):
            ok = np.allclose(g, w, rtol=1e-9, atol=1e-15)
        else:
            ok = g == w
        require(ok, f"report.json {k}: {g} != {w}")
    print(f"  report.json equals the in-process result "
          f"({got['bad_pixels']} bad pixels, rotation "
          f"{math.degrees(got['rotation_rad']):.3f} deg)")
    return total

MG_TIMEOUT = 300        # s, each torchrun launch of phase 22 (killed past it)
MG_STEM_FRAMES, MG_QUICK_FRAMES = 8, 8
MG_MSP_STEPS, MG_SM_SCAN = 2, 16


def stem_setup_kw():
    import pyslice_tpu_torch as pt
    return dict(aperture=30.0, voltage_eV=100e3, sampling=0.1,
                slice_thickness=0.5,
                probe_positions=pt.probe_grid([10, 90], [10, 90], 4,
                                              4).tolist())


def rank_counts(res, part):
    """The ranks' launch counts of one part, summed (counters are per
    process)."""
    total = {}
    for _, rec in res:
        for k, v in rec["counts"].get(part, {}).items():
            total[k] = total.get(k, 0) + v
    return total


def rank_blocks(res, key):
    """{(frame, probe) coordinate: the rank's block of ``key``}."""
    return {(r["coords"]["frame"], r["coords"]["probe"]): a[key]
            for a, r in res if key in a}


def free_card(tmp):
    """Free the allocator's cached blocks before ranks that share this card
    start, and print what is free (card and disk)."""
    import gc
    import shutil
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    free, size = torch.cuda.mem_get_info()
    print(f"  card {gib(free):.1f} of {gib(size):.1f} GiB free, this process "
          f"holding {gib(torch.cuda.memory_allocated()):.2f} GiB "
          f"({gib(torch.cuda.memory_reserved()):.2f} reserved); "
          f"{gib(shutil.disk_usage(tmp).free):.1f} GiB free on disk")


def launch_ranks(what, tmp, nproc, mesh, backend, config, device="cuda"):
    """The dry run in ``nproc`` ranks on the card (the kernels built here
    already, so the ranks only load them). A failed or late rank fails the
    phase. Starts no CUDA work of its own (22a's launch runs in a thread)."""
    from pyslice_tpu_torch.parallel import dryrun
    t0 = time.perf_counter()
    try:
        res = dryrun.launch(tmp, nproc, device=device, backend=backend,
                            mesh=mesh, config=config, timeout=MG_TIMEOUT)
    except (RuntimeError, TimeoutError) as e:
        raise SystemExit(f"chip_smoke FAILED: {what}: {e}")
    wall = time.perf_counter() - t0
    a2a = max(rec["stats"]["all_to_all_s"] for _, rec in res)
    print(f"  {what}: {nproc} rank(s), mesh {res[0][1]['mesh']}, backend "
          f"{res[0][1]['backend']}, {wall:.1f} s with start-up; all_to_all "
          f"{a2a:.4f} s (the slowest rank's); every collective on the "
          "ranks' own tensors (none staged through host memory by the "
          "port)")
    print(f"    rank 0's wall (s): "
          f"{ {k: round(v, 2) for k, v in res[0][1]['wall'].items()} }; "
          f"peak device memory a rank (GiB): "
          f"{[round(gib(r.get('peak_bytes', 0)), 2) for _, r in res]}")
    for _, rec in res:
        print(f"    rank {rec['rank']} {rec['coords']}: launches "
              f"{ {p: {k: v for k, v in c.items() if v} for p, c in rec['counts'].items()} }")
    return res


def require_launched(what, counts, want):
    print(f"  {what}: launches summed over the ranks {counts}, expected "
          f"{want}")
    require(counts == want, f"{what}: the ranks did not run exactly their "
            "kernels")


def multigpu_phase(dev, card, tmp, stem_lx=102.35, stream_lx=STREAM_LX,
                   stream_scan=STREAM_SCAN, msp_scan=MSP_SCAN, sm_lx=SM_LX,
                   sm_scan=MG_SM_SCAN, quick_lx=102.25):
    """Phase 22: the (frame, probe) mesh on torch.distributed. 22a one NCCL
    rank (1 x 1), 22b four Gloo ranks sharing the card (2 x 2: STEM, the
    config-5 stream, msp_reconstruct, the S-matrix), 22c the same ranks on
    a 4 x 1 mesh (the quick start frame-sharded at 1023^2). Each held
    against a single-process run here. Returns the launch counts, K6 under
    its engine's key. With four cards 22b and 22c run NCCL, a card a rank.
    On a CPU ``dev`` (a rehearsal at smaller sizes) the ranks run on the
    CPU and 22a on Gloo."""
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path
    import numpy as np
    import torch
    import pyslice_tpu_torch as pt
    from pyslice_tpu_torch.analysis import ptychography as ptycho
    from pyslice_tpu_torch.engine import smatrix as smx
    from pyslice_tpu_torch.engine.streaming import _haadf_mask
    from pyslice_tpu_torch.parallel import dryrun

    t_phase = time.perf_counter()
    tmp = Path(tmp)
    total = {}
    rdev = dev.type
    # four ranks: NCCL with a card each where the machine has four cards,
    # else Gloo with the four sharing this one (NCCL refuses that)
    cards = torch.cuda.device_count() if rdev == "cuda" else 0
    four = "nccl" if cards >= 4 else "gloo"
    how = ("on 4 cards over NCCL" if four == "nccl" else
           "sharing one card over Gloo: time-sliced contexts, not a scaling "
           "figure")
    launch = lambda *a: launch_ranks(*a, device=rdev)
    stem_kw = stem_setup_kw()

    # --- 22b: four ranks share the card over Gloo, a 2 x 2 mesh -----------
    out = tmp / "22b"
    out.mkdir()
    stem_traj = hbn_box(stem_lx, MG_STEM_FRAMES)
    dryrun.save_trajectory(out / "stem.npz", stem_traj)
    s_traj, s_g, s_spec, s_pg, s_base = stream_setup(dev, stream_lx,
                                                     STREAM_FRAMES,
                                                     stream_scan)
    dryrun.save_trajectory(out / "stream.npz", s_traj)
    stream_kw = dict(aperture=25.0, voltage_eV=100e3, sampling=0.1,
                     slice_thickness=0.5, probe_positions=s_pg.tolist())
    m_traj = hbn_box(stem_lx, 1)
    mcalc = pt.MultisliceCalculator(device=dev)
    half = 0.5 * MSP_STEP_A * (msp_scan - 1)
    span = [0.5 * stem_lx - half, 0.5 * stem_lx + half]
    mcalc.setup(m_traj, aperture=30.0, voltage_eV=100e3, sampling=0.1,
                slice_thickness=0.5,
                probe_positions=pt.probe_grid(span, span, msp_scan, msp_scan),
                device_output=True, use_cache=False)
    mwf = mcalc.run(progress=False)
    mdata = (mwf.wavefunction_data[:, 0, :, :, 0].abs() ** 2).cpu().numpy()
    v_init = 0.5 * pt.rasterize(torch.as_tensor(m_traj.positions[0],
                                                device=dev), mcalc.spec.plan)
    np.savez(out / "msp.npz", data=mdata,
             scan=np.asarray(mcalc.probe_positions, np.float64),
             probe=mcalc.base_probe.array.cpu().numpy(),
             xs=np.asarray(mcalc.xs), ys=np.asarray(mcalc.ys), mrad=30.0,
             eV=100e3, n_slices=mcalc.nz, dz=0.5,
             v_init=v_init.cpu().numpy())
    del mwf
    sm_traj = hbn_box(sm_lx, 1)
    dryrun.save_trajectory(out / "sm.npz", sm_traj)
    sm_span = [0.5, sm_lx - 0.5]
    sm_kw = dict(aperture=25.0, voltage_eV=100e3, sampling=0.1,
                 slice_thickness=0.5,
                 probe_positions=pt.probe_grid(sm_span, sm_span, sm_scan,
                                               sm_scan).tolist())
    msp_kw = {"steps": MG_MSP_STEPS, "batch": MSP_BATCH, "seed": 0}
    q_traj = hbn_box(quick_lx, MG_QUICK_FRAMES)
    dryrun.save_trajectory(out / "quick.npz", q_traj)
    q_kw = dict(aperture=0.0, voltage_eV=100e3, sampling=0.1,
                slice_thickness=0.5, probe_positions=None)
    # --- 22a: one rank on NCCL, a 1 x 1 mesh (launched beside 22b's ranks,
    # so that the two start-ups overlap) ------------------------------------
    out_a = tmp / "22a"
    out_a.mkdir()
    dryrun.save_trajectory(out_a / "stem.npz", hbn_box(stem_lx, 4))
    if rdev == "cuda":
        free_card(tmp)
    pool = ThreadPoolExecutor(1)
    job_a = pool.submit(
        launch, "22a STEM 1024^2 x 16 probes x 4 frames through "
        "MultisliceCalculator(mesh=)", out_a, 1, "1x1",
        "nccl" if rdev == "cuda" else "gloo",
        {"precision": "single", "problem": "stem.npz", "setup": stem_kw,
         "parts": ["stem"], "stem": {"compare_unsharded": True,
                                     "save_waves": False, "warmup": True}})
    # 22c runs in the same ranks, on a 4 x 1 mesh of its own (one start-up)
    res = launch(
        "22b STEM 1024^2 x 16 probes x 8 frames, config 5's StreamingTACAW "
        "at 2048^2 x 64 probes, msp_reconstruct at 1024^2, compute_smatrix "
        f"at 512^2; 22c the quick start at 1023^2 x {MG_QUICK_FRAMES} frames "
        "on a 4 x 1 mesh", out, 4, "2x2", four,
        {"precision": "single", "problem": "stem.npz", "setup": stem_kw,
         "parts": ["stem", "stream", "msp", "smatrix", "quick"],
         "stem": {"warmup": True, "functions": False},
         "quick": {"part": "stem", "mesh": "4x1", "problem": "quick.npz",
                   "setup": q_kw, "save_waves": False, "warmup": True},
         "stream": {"problem": "stream.npz", "setup": stream_kw,
                    "frequencies": STREAM_FREQS, "haadf": False},
         "msp": {"file": "msp.npz", "kwargs": msp_kw},
         "smatrix": {"problem": "sm.npz", "setup": sm_kw}})
    res_a = job_a.result()
    pool.shutdown()
    rec = res_a[0][1]
    nx, ny, nz, nf = rec["stem_grid"]
    print(f"  22a exit waves against the run without a mesh: bit-identical "
          f"{rec['checks']['unsharded_bitwise']}, max|d| "
          f"{rec['checks']['unsharded_max_abs']:.3e}")
    require(rec["checks"]["unsharded_bitwise"],
            "22a: the 1 x 1 NCCL mesh changed the exit waves")
    counts = rank_counts(res_a, "stem")
    require_launched("22a", counts, want_counts(a=nf * nz, b=nf * (nz - 1),
                                                c=nf))
    add_counts(total, counts)
    a0 = res[0][0]
    nx, ny, nz, nf = res[0][1]["stem_grid"]

    # STEM against the single-process run on the card
    calc = pt.MultisliceCalculator(device=dev)
    calc.setup(stem_traj, device_output=True, use_cache=False, **stem_kw)
    calc.run(progress=False)                              # warm-up
    wf, _, single_s = launches_of(lambda: calc.run(progress=False))
    ref = wf.wavefunction_data
    fb, pb = nf // 2, calc.n_probes // 2
    for (f, p), blk in sorted(rank_blocks(res, "wf").items()):
        check(f"exit waves, rank block (frame {f}, probe {p})",
              torch.as_tensor(blk, device=dev),
              ref[p * pb:(p + 1) * pb, f * fb:(f + 1) * fb])
    tac = pt.TACAWData(wf)
    f1 = float(a0["arg_f1"])
    last = int(a0["arg_last"])
    kxp, kyp, mask = a0["arg_kx_path"], a0["arg_ky_path"], a0["arg_mask"]
    for name, want in (
            ("spectrum", tac.spectrum()),
            ("spectrum_p", tac.spectrum(last)),
            ("spectrum_image", tac.spectrum_image(f1)),
            ("diffraction", tac.diffraction()),
            ("diffraction_p", tac.diffraction(last)),
            ("spectral_diffraction", tac.spectral_diffraction(f1)),
            ("spectral_diffraction_p", tac.spectral_diffraction(f1, last)),
            ("masked_spectrum", tac.masked_spectrum(mask)),
            ("masked_spectrum_p", tac.masked_spectrum(mask, last)),
            ("dispersion", tac.dispersion(kxp, kyp)),
            ("dispersion_p", tac.dispersion(kxp, kyp, last))):
        check_np(f"TACAW {name}", a0["tacaw_" + name], want)
    check_np("HAADF", a0["adf"], pt.HAADFData(wf).calculateADF(45))
    sharded_s = max(r["seconds"]["stem"] for _, r in res)
    print(f"  STEM ms/frame: sharded {1e3 * sharded_s / nf:.1f} (4 ranks "
          f"{how}), single-process {1e3 * single_s / nf:.1f}; card {card}")
    counts = rank_counts(res, "stem")
    require_launched("22b STEM", counts, want_counts(
        a=2 * nf * nz, b=2 * nf * (nz - 1), c=2 * nf))
    add_counts(total, counts)
    del wf, ref, tac, calc

    # config 5's stream against the single-process stream (phase 12's bars)
    probes = pt.create_batched_probes(s_base, s_pg).array
    st = pt.StreamingTACAW(s_spec, probes, STREAM_FRAMES, s_traj.timestep,
                           frequencies=STREAM_FREQS,
                           probe_chunk=STREAM_CHUNK)
    st.add_frame_block(list(range(STREAM_FRAMES)), s_traj.positions)
    inten = st.intensity()
    del st
    pb = stream_scan ** 2 // 2
    for (f, p), blk in sorted(rank_blocks(res, "stream_intensity").items()):
        errs = per_bin(torch.as_tensor(blk, device=dev),
                       inten[:, p * pb:(p + 1) * pb])
        for i, (d, rel, r) in enumerate(errs):
            print(f"  stream bin {i}, probe block {p}: max|d| {d:.3e}  "
                  f"max|d|/max|ref| {rel:.3e}  residual {r:.3e}")
            require(rel <= STREAM_MAX_REL and r <= MAX_RESIDUAL,
                    "the frame-sharded stream disagrees")
    del inten
    resumed = all(r["checks"]["stream_resume_bitwise"] for _, r in res)
    refused = all(r["checks"]["resume_refused_on_other_mesh"]
                  for _, r in res)
    print(f"  stream checkpoint + resume, one file set a rank: bit-identical "
          f"{resumed}; refused on a 1 x 4 mesh {refused}; "
          f"{max(r['seconds']['stream_tacaw'] for _, r in res):.2f} s")
    require(resumed and refused, "stream checkpoint/resume on the mesh")
    counts = rank_counts(res, "stream_tacaw")
    require_launched("22b stream", counts, want_counts(
        a=STREAM_FRAMES * 2 * s_g.nz, b=STREAM_FRAMES * 2 * (s_g.nz - 1),
        c=STREAM_FRAMES * 2))
    add_counts(total, counts)

    # msp_reconstruct(mesh=): parameters the same bits on every rank, the
    # first minibatch's mesh-averaged gradient against one process's
    for key in ("potential", "probe", "positions", "losses"):
        vals = [a["msp_" + key] for a, _ in res]
        require(all(np.array_equal(v, vals[0]) for v in vals[1:]),
                f"msp {key} differs between ranks")
    losses = a0["msp_losses"]
    print(f"  msp_reconstruct: losses {losses}; parameters bit-identical on "
          "the 4 ranks")
    require(np.isfinite(losses).all(), "msp losses")
    with np.load(out / "msp.npz") as z:
        mp = {k: z[k] for k in z.files}
    probe = pt.Probe(mp["xs"], mp["ys"], 30.0, 100e3, array=mp["probe"],
                     device=dev)
    run, batches = ptycho._msp_setup(mp["data"], mp["scan"], probe,
                                     int(mp["n_slices"]), 0.5,
                                     v_init=mp["v_init"], **msp_kw)
    _, grads = run.grads(batches[0])
    d, rel, _ = errors(torch.as_tensor(a0["msp_grad_v"], device=dev),
                       grads["v"])
    print(f"  dL/dV of minibatch 0, 4 ranks vs one process: max|d| {d:.3e} "
          f" max|d|/max|ref| {rel:.3e}")
    require(rel <= GRAD_REL, "the mesh-averaged gradient disagrees")
    counts = rank_counts(res, "msp")
    step = step_want(("a", "b", "k7"), int(mp["n_slices"]))
    require_launched("22b msp", counts, {
        k: 4 * MG_MSP_STEPS * v for k, v in step.items()})
    add_counts(total, counts)
    del run, grads, mp

    # compute_smatrix(mesh=) against one process's S-matrix
    calc = pt.MultisliceCalculator(device=dev)
    calc.setup(sm_traj, use_cache=False, **sm_kw)
    g = calc.grid
    beams = smx.build_beams(g.xs, g.ys, 25.0, 100e3)
    sm = smx.compute_smatrix(sm_traj.positions[0], calc.spec.plan, beams,
                             xs=g.xs, ys=g.ys, dz=calc.spec.dz,
                             beam_chunk=64, kmax2=calc.spec.kmax2,
                             device=dev)
    pp = np.asarray(calc.probe_positions)
    check_np("S-matrix reduce", a0["smatrix_reduce"],
             smx.smatrix_reduce(sm, pp, _haadf_mask(calc.spec, 45)))
    check_np("S-matrix exit waves", a0["smatrix_exit"],
             smx.smatrix_exit_kspace(sm, pp[:4]).cpu().numpy())
    nb = beams.n_beams
    n_ch = -(-(-(-nb // 64)) // 4) * 4
    chunk = -(-nb // n_ch)
    counts = rank_counts(res, "smatrix")
    require_launched(f"22b compute_smatrix ({nb} beams, {n_ch} chunks over "
                     "4 ranks)", counts, want_counts(k6=-(-nb // chunk)))
    total["k6_pow2"] = total.get("k6_pow2", 0) + counts["k6"]
    del sm, calc

    # --- 22c: the quick start frame-sharded over the same ranks (4 x 1) ---
    print(f"  22c quick start, a plane wave at 1023^2 x {MG_QUICK_FRAMES} "
          "frames on the ranks' 4 x 1 mesh (kx padded 1023 -> 1024)")
    a0 = res[0][0]
    calc = pt.MultisliceCalculator(device=dev)
    calc.setup(q_traj, device_output=True, use_cache=False, **q_kw)
    calc.run(progress=False)                              # warm-up
    wf, _, single_s = launches_of(lambda: calc.run(progress=False))
    tac = pt.TACAWData(wf)
    check_np("quick start spectrum", a0["quick_tacaw_spectrum"],
             tac.spectrum())
    check_np("quick start diffraction", a0["quick_tacaw_diffraction"],
             tac.diffraction())
    sharded_s = max(r["seconds"]["quick_stem"] for _, r in res)
    print(f"  quick start ms/frame: sharded {1e3 * sharded_s / MG_QUICK_FRAMES:.1f}"
          f" (4 ranks {how}), "
          f"single-process {1e3 * single_s / MG_QUICK_FRAMES:.1f}; card {card}")
    counts = rank_counts(res, "quick_stem")
    require_launched("22c", counts, want_counts(k6=MG_QUICK_FRAMES))
    total["k6_mixed"] = total.get("k6_mixed", 0) + counts["k6"]
    print(f"  phase 22: {time.perf_counter() - t_phase:.1f} s; card {card}")
    return total


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
    print(f"[2] built {', '.join(p.name for p in b.paths.values())} in "
          f"{b.seconds:.1f} s")
    for line in b.log.splitlines():
        if "Compiling entry function" in line:
            print(f"    {kernel_name(line.split(chr(39))[1])}:")
        elif "registers" in line or "spill" in line or line.startswith("---"):
            print(f"    {line.strip()}")
    if sys.argv[1:] == ["--phase", "22"]:
        # phase 22 alone (a quicker check of the multi-GPU path): no
        # kernels line and no result line
        with tempfile.TemporaryDirectory() as tmp:
            print("[22] multi-GPU alone:")
            print(multigpu_phase(dev, card, tmp))
        print(card)
        return 0

    print(f"[3] kernels A, B, C vs plain versions at {N_PROBES} x "
          f"{N_GRID}^2:")
    records = kernel_phase(dev)
    print(f"[4] kernels K4, K5 at {N_PROBES} x {N_ODD}^2, K6 at 1 x {N_ODD}^2 "
          "and 1 x 1024^2 vs plain versions:")
    records.update(mr_kernel_phase(dev))
    print("[5] STEM at 1024^2 (kernels A, B, C):")
    counts = slice_phase(dev, card)
    with tempfile.TemporaryDirectory() as tmp:
        print(f"[6] README quick start, plane wave at {N_ODD}^2 (K6):")
        k6_mixed, traj = quick_start_phase(dev, card, tmp)
        print("[7] the same with fast_grid=True, 1024^2 (K6):")
        k6_pow2, _ = quick_start_phase(dev, card, tmp, n_frames=N_FRAMES,
                                       fast_grid=True, grid=1024)
    print(f"[8] STEM at {N_ODD}^2 (kernels K4, K5):")
    odd = odd_stem_phase(dev, card, traj)
    print(f"[9] adjoint kernels K7 at {N_PROBES} pairs x {N_GRID}^2, K8 at "
          f"{N_PROBES} pairs x {N_ODD}^2, and the adjoint chains:")
    records.update(adjoint_kernel_phase(dev))
    print(f"[10a] multislice ptychography at {N_GRID}^2 (A, B, K7):")
    k7, data, calc, traj = msp_phase(dev, card, 102.35, N_GRID,
                                     ("a", "b", "k7"))
    print(f"[10b] multislice ptychography at {N_ODD}^2 (K4, K5, K8):")
    k8, *_ = msp_phase(dev, card, 102.25, N_ODD, ("k4", "k5", "k8"))
    print(f"[11] refine_structure at {N_GRID}^2 (A, B, K7):")
    k7 += refine_phase(data, calc, traj)
    del data, calc
    print(f"[12] config 5: StreamingTACAW at {STREAM_SCAN ** 2} probes x "
          "2048^2 (A, B, C), StreamingHAADF, against the plain stream and "
          "the batch path:")
    streamed, setup, inten = stream_phase(dev, card)
    with tempfile.TemporaryDirectory() as tmp:
        print("[13] the same frames through a gzipped dump, TrajectoryStream "
              "and a checkpoint resume at 2048^2:")
        resumed = resume_phase(dev, card, setup, inten, tmp)
    del setup, inten
    print(f"[14a] the S-matrix against the direct route, {SM_SCAN ** 2} "
          "probes at 512^2 (K6):")
    k6_sm = smatrix_phase(dev, card)
    print(f"[14b] frozen phonons on the {N_ODD}^2 box (K4, K5; K6):")
    thermal = thermal_phase(dev, card)
    print(f"[15] Potential -> Propagate at 16 probes x {N_GRID}^2 (A, B):")
    surface = surface_phase(dev, card)
    print(f"[16] HRTEM on the {N_ODD}^2 box: {HR_TILTS ** 2} tilts (K4, K5),"
          " fast_grid (A, B, C), a coherent plane wave (K6):")
    imaging = [hrtem_phase(dev, card)]
    print(f"[17] focal series and IWFR at {N_ODD}^2:")
    imaging.append(ewr_phase(dev, card))
    print(f"[18] chromatic_stem (K4, K5), precession_diffraction and "
          f"chromatic_diffraction (K6) on the {N_ODD}^2 box:")
    imaging.append(coherence_phase(dev, card))
    print(f"[19] phase retrieval from {PR_SCAN ** 2} patterns at {PR_N}^2 "
          "(K6): SSB, iCoM, ePIE:")
    imaging.append(retrieval_phase(dev, card))
    with tempfile.TemporaryDirectory() as tmp:
        print(f"[20] the command line at {N_ODD}^2: info, the native parser, "
              "run --mode tacaw (K6), run --mode haadf (K4, K5; --fast-grid "
              "A, B, C), python3 -m pyslice_tpu_torch, devices:")
        imaging.append(cli_phase(dev, card, tmp))
    with tempfile.TemporaryDirectory() as tmp:
        print(f"[21] measured-data calibration: {CAL_SCAN}^2 patterns at "
              f"256^2 (K6), float32 and float64:")
        imaging.append(calibration_phase(dev, card, tmp))
    with tempfile.TemporaryDirectory() as tmp:
        print("[22] multi-GPU: the (frame, probe) mesh on torch.distributed "
              "(22a one NCCL rank; 22b, 22c four ranks, on Gloo sharing the "
              "card where there is one):")
        imaging.append(multigpu_phase(dev, card, tmp))
    counts.update(k4=odd["k4"] + thermal["k4"], k5=odd["k5"] + thermal["k5"],
                  k6_mixed=k6_mixed + thermal["k6"],
                  k6_pow2=k6_pow2 + k6_sm, k7=k7, k8=k8)
    for k in ("a", "b", "c"):
        counts[k] += streamed[k] + resumed[k] + surface[k]
    for part in imaging:
        for k, v in part.items():
            counts[k] = counts.get(k, 0) + v
    for k, rec in records.items():
        rec["launches"] = counts[k]
    print(json.dumps({"kernels": [records[k] for k in KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
