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
16. a JSON line per kernel, the nvidia-smi line, and the final JSON line.

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
    counts.update(k4=odd["k4"] + thermal["k4"], k5=odd["k5"] + thermal["k5"],
                  k6_mixed=k6_mixed + thermal["k6"],
                  k6_pow2=k6_pow2 + k6_sm, k7=k7, k8=k8)
    for k in ("a", "b", "c"):
        counts[k] += streamed[k] + resumed[k] + surface[k]
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
