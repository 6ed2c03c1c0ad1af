"""Multi-process dry run of the sharded pipeline.

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        -m pyslice_tpu_torch.parallel.dryrun --out DIR \\
        [--device cpu|cuda] [--backend gloo|nccl] [--mesh FxP]

Every rank builds the (frame, probe) mesh (``make_mesh``) and runs the
parts named in ``DIR/config.json`` (all of them without one, on a small
built-in hBN problem). A part's entry of the config overrides the top
level's keys; ``{"part": "stem", "mesh": "4x1", ...}`` under another name
runs that part again, on a mesh of its own shape over the same ranks, its
outputs prefixed with the name:

* ``stem``: ``MultisliceCalculator.setup(mesh=)`` and ``run()``; the
  functions of ``parallel.sharded`` on its exit waves; the six TACAWData
  methods, HAADFData.calculateADF, virtual_image, center_of_mass, pacbed
  and scan_grid_data;
* ``stream``: StreamingTACAW and StreamingHAADF on the mesh, each with a
  checkpoint halfway and a resume into a fresh stream, and the HAADF
  stream's S-matrix route;
* ``smatrix``: ``compute_smatrix(mesh=)`` and its synthesis;
* ``msp``: ``msp_reconstruct(mesh=)`` and the gradients of one minibatch.

Each rank writes its outputs (replicated results in full, sharded ones as
its local block) to ``DIR/rank<r>.npz`` and its kernel launch counts,
seconds (``seconds``: the timed calls; ``wall``: the start-up, each part
whole and the save), collective statistics and, on the card, its peak
device memory to ``DIR/rank<r>.json``, and its whole standard error to
``DIR/rank<r>.stderr``. ``launch``
starts the ranks from a parent process with a time limit of its own;
``load`` reads what they wrote. On the card the parent builds the kernels
first (``ops.fused_step.build``): the ranks load the build and never run
nvcc themselves.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

PARTS = ("stem", "stream", "smatrix", "msp")


def hbn_box(lx: float, n_frames: int, seed: int = 0, lz: float = 6.784,
            sigma: float = 0.05):
    """hBN monolayer filling an lx x lx box (whole rectangular cells,
    a = 2.504 A) plus n_frames uniform thermal frames of ``sigma`` A from
    a seeded torch.Generator."""
    import torch
    from ..data.trajectory import Trajectory
    a = 2.504
    by = np.sqrt(3.0) * a
    z0 = lz / 4.0
    base = np.array([[0.0, 0.0, z0], [a / 2, by / 6, z0],
                     [a / 2, by / 2, z0], [0.0, by / 2 + by / 6, z0]])
    ncx, ncy = max(1, int(lx // a)), max(1, int(lx // by))
    pos = np.concatenate([base + np.array([i * a, j * by, 0.0])
                          for i in range(ncx) for j in range(ncy)])[None]
    types = np.tile(np.array([5, 7, 5, 7], dtype=np.int32), ncx * ncy)
    traj = Trajectory(atom_types=types, positions=pos,
                      velocities=np.zeros_like(pos),
                      box_matrix=np.diag([lx, lx, lz]), timestep=0.005)
    return traj.generate_random_displacements(
        n_frames, sigma, generator=torch.Generator().manual_seed(seed))


def save_trajectory(path, traj) -> None:
    """A trajectory as the .npz a part's ``"problem"`` names."""
    np.savez(path, positions=np.asarray(traj.positions),
             atom_types=np.asarray(traj.atom_types),
             box_matrix=np.asarray(traj.box_matrix),
             timestep=np.asarray(traj.timestep))


def _trajectory(out: Path, cfg: dict):
    from ..data.trajectory import Trajectory
    if cfg.get("problem"):
        with np.load(out / cfg["problem"]) as z:
            pos = z["positions"]
            return Trajectory(atom_types=z["atom_types"], positions=pos,
                              velocities=np.zeros_like(pos),
                              box_matrix=z["box_matrix"],
                              timestep=float(z["timestep"]))
    box = cfg.get("box", {})
    return hbn_box(box.get("lx", 5.008), box.get("n_frames", 8),
                   box.get("seed", 7))


DEFAULT_SETUP = dict(aperture=20.0, voltage_eV=100e3, sampling=0.3,
                     slice_thickness=0.8,
                     probe_positions=[[1.0, 1.0], [1.0, 3.0], [3.0, 1.0],
                                      [3.0, 3.0]])


def _calculator(out: Path, cfg: dict, precision, device, mesh=None,
                **extra):
    from ..engine.calculator import MultisliceCalculator
    traj = _trajectory(out, cfg)
    setup = dict(DEFAULT_SETUP, **cfg.get("setup", {}))
    if setup.get("probe_positions") is not None:
        setup["probe_positions"] = [tuple(p) for p in
                                    setup["probe_positions"]]
    calc = MultisliceCalculator(device=device, precision=precision)
    calc.setup(traj, use_cache=False, mesh=mesh, **setup, **extra)
    return calc, traj


class Rank:
    """One rank's run: the mesh, its outputs and its records."""

    def __init__(self, out: Path, mesh, device, cfg: dict):
        import torch.distributed as dist
        from .mesh import FRAME_AXIS, PROBE_AXIS, coord
        self.out, self.mesh, self.device = out, mesh, device
        self.precision = cfg.get("precision", "double")
        self.rank = dist.get_rank()
        self.tag = ""            # the output prefix of an aliased part
        self.arrays = {}
        self.record = {
            "rank": self.rank, "world": dist.get_world_size(),
            "mesh": [int(n) for n in mesh.shape],
            "coords": {"frame": coord(mesh, FRAME_AXIS),
                       "probe": coord(mesh, PROBE_AXIS)},
            "backend": str(dist.get_backend()), "device": str(device),
            "counts": {}, "seconds": {}, "checks": {}, "wall": {}}

    def put(self, name: str, value) -> None:
        from ..analysis.wf_data import to_numpy
        from .sharded import local_of
        self.arrays[self.tag + name] = to_numpy(local_of(value)) \
            if not isinstance(value, np.ndarray) else value

    def timed(self, part: str, fn):
        """fn() with the launch counts set to 0 just before and read just
        after (synchronized), recorded under ``part``."""
        import torch
        import torch.distributed as dist
        from ..ops import fused_step as fs
        for k in fs.launches:
            fs.launches[k] = 0
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        res = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
        self.record["seconds"][self.tag + part] = time.perf_counter() - t0
        self.record["counts"][self.tag + part] = dict(fs.launches)
        return res

    # --- parts -------------------------------------------------------------

    def stem(self, cfg: dict) -> None:
        """The calculator's sharded run and every analysis of it."""
        import torch
        from ..analysis import detectors, ptychography
        from ..analysis.haadf import HAADFData
        from ..analysis.tacaw import TACAWData
        from . import sharded as sh
        calc, traj = _calculator(self.out, cfg, self.precision, self.device,
                                 self.mesh)
        if cfg.get("warmup"):
            calc.run()       # first calls: plans, modules, the allocator
        wf = self.timed("stem", calc.run)
        w = wf.wavefunction_data
        self.record[self.tag + "stem_grid"] = [int(calc.nx), int(calc.ny),
                                    int(calc.nz), int(calc.n_frames)]
        if cfg.get("save_waves", True):
            self.put("wf", w)
        if cfg.get("compare_unsharded"):
            ref, _ = _calculator(self.out, cfg, self.precision, self.device,
                                 device_output=True)
            r = ref.run(progress=False).wavefunction_data
            loc = sh.local_of(w)
            fs = sh.block_of(calc.n_frames, self.mesh, "frame")
            ps = sh.block_of(calc.n_probes, self.mesh, "probe")
            r = r[ps, fs]
            self.record["checks"]["unsharded_bitwise"] = bool(
                torch.equal(loc, r))
            self.record["checks"]["unsharded_max_abs"] = float(
                (loc - r).abs().max())
        tac = TACAWData(wf)
        nf = len(tac.frequencies)
        f1 = float(tac.frequencies[min(nf - 1, nf // 2 + 1)])
        nx, ny = len(tac.kxs), len(tac.kys)
        mask = np.zeros((nx, ny))
        mask[: nx // 2, : ny // 3] = 1.0
        kx_path = np.linspace(tac.kxs.min(), tac.kxs.max(), 7)
        ky_path = np.linspace(tac.kys.min(), tac.kys.max(), 7)
        last = len(tac.probe_positions) - 1
        for name, val in (("f1", f1), ("mask", mask), ("last", last),
                          ("kx_path", kx_path), ("ky_path", ky_path)):
            self.put("arg_" + name, np.asarray(val))
        for name, val in (
                ("spectrum", tac.spectrum()),
                ("spectrum_p", tac.spectrum(last)),
                ("spectrum_image", tac.spectrum_image(f1)),
                ("diffraction", tac.diffraction()),
                ("diffraction_p", tac.diffraction(last)),
                ("spectral_diffraction", tac.spectral_diffraction(f1)),
                ("spectral_diffraction_p",
                 tac.spectral_diffraction(f1, last)),
                ("masked_spectrum", tac.masked_spectrum(mask)),
                ("masked_spectrum_p", tac.masked_spectrum(mask, last)),
                ("dispersion", tac.dispersion(kx_path, ky_path)),
                ("dispersion_p", tac.dispersion(kx_path, ky_path, last)),
                ("intensity", tac.intensity)):
            self.put("tacaw_" + name, val)
        haadf = HAADFData(wf)
        self.put("adf", haadf.calculateADF(45))
        self.put("adf_int", haadf.calculateADF(45, intensity=True))
        lam = wf.probe.wavelength
        ring = detectors.annular_mask(wf.kxs, wf.kys, lam, 10.0, 40.0)
        segs = detectors.segmented_mask(wf.kxs, wf.kys, lam, 5.0, 40.0)
        self.put("arg_ring", ring)
        self.put("arg_segs", segs)
        self.put("virtual_image", detectors.virtual_image(wf, ring))
        self.put("virtual_segments", detectors.virtual_image(wf, segs))
        self.put("com", detectors.center_of_mass(wf))
        self.put("pacbed", detectors.pacbed(wf))
        self.put("pacbed_sub", detectors.pacbed(wf, probe_indices=[0, last]))
        self.put("scan_grid", ptychography.scan_grid_data(wf)[2])
        if not cfg.get("functions", True):
            return
        if not sh.is_sharded(w):
            return
        # the functions on the run's mesh, of any size (a 1 x 1 mesh runs
        # their collectives over groups of one)
        mesh = w.device_mesh
        inten = sh.tacaw_intensity_sharded(w, mesh, crop=False)
        n_probes = w.shape[0]
        onehot = np.eye(n_probes)[last]
        pad = inten.shape[2] - nx
        for name, val in (
                ("intensity_pad", inten),
                ("intensity_crop", sh.tacaw_intensity_sharded(w, mesh)),
                ("spectrum", sh.tacaw_spectrum_sharded(inten, mesh)),
                ("probe_spectra", sh.tacaw_probe_spectra_sharded(inten,
                                                                 mesh)),
                ("probe_spectra_mask", sh.tacaw_probe_spectra_sharded(
                    inten, mesh, mask=np.pad(mask, ((0, pad), (0, 0))))),
                ("kplane", sh.tacaw_kplane_sharded(
                    inten, mesh, np.full(n_probes, 1.0 / n_probes))),
                ("kplane_f", sh.tacaw_kplane_sharded(inten, mesh, onehot,
                                                     freq_index=1)),
                ("dispersion", sh.tacaw_dispersion_sharded(
                    inten, mesh, onehot, [0, 1, nx - 1], [0, ny // 2, 2])),
                ("collected", sh.collected_sharded(
                    w, mesh, np.stack([ring, 1.0 - ring]))),
                ("collected_int", sh.collected_sharded(w, mesh, ring,
                                                       intensity=True)),
                ("frame_mean", sh.frame_mean_intensity_sharded(w, mesh))):
            self.put("fn_" + name, val)

    def stream(self, cfg: dict) -> None:
        """StreamingTACAW and StreamingHAADF on the mesh, each checkpointed
        halfway and resumed into a fresh stream (bit-identical checked),
        and the HAADF stream's S-matrix route."""
        import torch
        from ..engine.streaming import StreamingHAADF, StreamingTACAW
        from .mesh import FRAME_AXIS, coord, extent, make_mesh
        calc, traj = _calculator(self.out, cfg, self.precision, self.device)
        spec, probes = calc.spec, calc._probes_array()
        pos = torch.as_tensor(traj.positions, device=self.device)
        n = traj.n_frames
        f_ext = extent(self.mesh, FRAME_AXIS)
        block = f_ext if f_ext > 1 else 2
        order = np.random.default_rng(5).permutation(n)
        blocks = [order[i:i + block] for i in range(0, n, block)]
        half = len(blocks) // 2
        freqs = cfg.get("frequencies")
        ckpt = self.out / "ckpt"

        def tacaw():
            return StreamingTACAW(spec, probes, n, traj.timestep,
                                  frequencies=freqs, mesh=self.mesh)

        def feed_tacaw(st, bl):
            for b in bl:
                st.add_frame_block(b.tolist(), pos[b])

        def run_tacaw():
            st = tacaw()
            feed_tacaw(st, blocks[:half])
            st.save_checkpoint(ckpt / "tacaw")
            feed_tacaw(st, blocks[half:])
            return st, st.intensity()

        st, inten = self.timed("stream_tacaw", run_tacaw)
        if coord(self.mesh, FRAME_AXIS) == 0:       # replicated over frames
            self.put("stream_intensity", inten)
        self.put("stream_spectrum", st.spectrum())
        self.put("stream_frequencies", st.frequencies)
        # the uninterrupted stream's state, to hold the resumed one to
        state = {k: v.cpu() for k, v in st._arrays().items()}
        del st, inten
        back = tacaw()
        seen = back.restore(ckpt / "tacaw")
        feed_tacaw(back, blocks[half:])
        self.record["checks"]["stream_resume_bitwise"] = bool(
            seen == set(order[:half * block].tolist())
            and all(torch.equal(v.cpu(), state[k])
                    for k, v in back._arrays().items()))
        del back, state
        # the same checkpoint on another mesh shape over the same ranks
        world = self.mesh.size()
        other = make_mesh(*((world, 1) if self.mesh.shape[1] == world
                            else (1, world)), device=self.device.type)
        try:
            StreamingTACAW(spec, probes, n, traj.timestep, frequencies=freqs,
                           mesh=other).restore(ckpt / "tacaw")
            refused = False
        except ValueError:
            refused = True
        self.record["checks"]["resume_refused_on_other_mesh"] = refused
        if not cfg.get("haadf", True):
            return

        def haadf(**kw):
            return StreamingHAADF(spec, probes, calc.probe_positions,
                                  mesh=self.mesh, **kw)

        def feed_haadf(st, bl):
            for b in bl:
                st.add_frame_block(pos[b], frame_indices=b.tolist())

        def run_haadf():
            st = haadf()
            feed_haadf(st, blocks[:half])
            st.save_checkpoint(ckpt / "haadf")
            feed_haadf(st, blocks[half:])
            return st.image()

        img = self.timed("stream_haadf", run_haadf)
        self.put("stream_adf", img)
        back = haadf()
        back.restore(ckpt / "haadf")
        feed_haadf(back, blocks[half:])
        self.record["checks"]["haadf_resume_bitwise"] = bool(
            np.array_equal(back.image(), img))
        mrad = DEFAULT_SETUP["aperture"] if "aperture" not in cfg.get(
            "setup", {}) else cfg["setup"]["aperture"]
        if mrad > 0:
            st = haadf(mrad=mrad, use_smatrix=True)
            self.timed("stream_smatrix", lambda: feed_haadf(st, blocks))
            self.put("stream_adf_smatrix", st.image())

    def smatrix(self, cfg: dict) -> None:
        """compute_smatrix(mesh=) on frame 0 and its synthesis."""
        from ..engine import smatrix as sm
        from ..engine.streaming import _haadf_mask
        calc, traj = _calculator(self.out, cfg, self.precision, self.device)
        g = calc.grid
        beams = sm.build_beams(g.xs, g.ys, calc.aperture, calc.voltage_eV)
        mat = self.timed("smatrix", lambda: sm.compute_smatrix(
            traj.positions[0], calc.spec.plan, beams, xs=g.xs, ys=g.ys,
            dz=calc.spec.dz, precision=calc.precision,
            mesh=self.mesh, kmax2=calc.spec.kmax2, device=self.device))
        self.record["smatrix_beams"] = int(beams.n_beams)
        pp = np.asarray(calc.probe_positions)
        mask = _haadf_mask(calc.spec, 45)
        self.put("arg_sm_mask", mask.astype(np.float64))
        self.put("smatrix_reduce", sm.smatrix_reduce(
            mat, pp, mask, precision=calc.precision))
        self.put("smatrix_exit", sm.smatrix_exit_kspace(
            mat, pp[:4], precision=calc.precision))

    def msp(self, cfg: dict) -> None:
        """msp_reconstruct(mesh=) and the mesh-averaged gradients of its
        first minibatch."""
        from ..analysis import ptychography as pt
        from ..physics.probe import Probe
        with np.load(self.out / cfg["file"]) as z:
            p = {k: z[k] for k in z.files}
        probe = Probe(p["xs"], p["ys"], float(p["mrad"]), float(p["eV"]),
                      array=p["probe"], precision=self.precision,
                      device=self.device)
        kw = dict(n_slices=int(p["n_slices"]), dz=float(p["dz"]),
                  mesh=self.mesh, v_init=p.get("v_init"),
                  **cfg.get("kwargs", {}))
        res = self.timed("msp", lambda: pt.msp_reconstruct(
            p["data"], p["scan"], probe, **kw))
        for k, v in res.items():
            self.put("msp_" + k, v)
        run, batches = pt._msp_setup(p["data"], p["scan"], probe, **kw)
        loss, grads = run.grads(batches[0])
        self.put("msp_grad_loss", np.asarray(float(loss)))
        for k, g in grads.items():
            self.put("msp_grad_" + k, g)

    def finish(self) -> None:
        import torch
        from .sharded import STATS
        self.record["stats"] = STATS
        if self.device.type == "cuda":
            self.record["peak_bytes"] = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        np.savez(self.out / f"rank{self.rank}.npz", **self.arrays)
        self.record["wall"]["save"] = time.perf_counter() - t0
        (self.out / f"rank{self.rank}.json").write_text(
            json.dumps(self.record, default=float))


def _check_built() -> None:
    """The kernels must be built before the ranks start: the ranks load
    the build and never race nvcc into one directory."""
    from ..ops import fused_step as fs
    digest = fs._sources_digest()
    missing = [s for s in fs.SOURCES
               if not (fs._BUILD_DIR / f"{s}_{digest}.so").exists()]
    if missing:
        raise SystemExit(
            f"kernels not built ({', '.join(missing)}): run "
            "pyslice_tpu_torch.ops.fused_step.build() before the ranks")
    fs.build()


def keep_stderr(out: Path, rank: int) -> None:
    """Send this process's standard error, whole, to ``out/rank<r>.stderr``
    (a traceback, warnings, and a fatal signal's stack through
    faulthandler), where ``launch`` reads it when the rank fails."""
    import faulthandler
    out.mkdir(parents=True, exist_ok=True)
    fd = os.open(out / f"rank{rank}.stderr",
                 os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    sys.stderr.flush()
    os.dup2(fd, 2)
    os.close(fd)
    faulthandler.enable(sys.stderr)


def failed_ranks(out: Path, nproc: int, tail: int = 100) -> str:
    """The last ``tail`` lines of the standard error of every rank that
    failed (it wrote no record, or its log holds a traceback), the first
    to fail first (by the log's modification time)."""
    logs = []
    for r in range(nproc):
        log = out / f"rank{r}.stderr"
        text = log.read_text(errors="replace") if log.exists() else ""
        if not (out / f"rank{r}.json").exists() or "Traceback" in text \
                or "Fatal Python error" in text:
            when = log.stat().st_mtime if log.exists() else float("inf")
            logs.append((when, r, text.splitlines()[-tail:]))
    return "\n".join(
        f"--- rank {r}'s standard error, last {len(lines)} lines "
        f"({out / f'rank{r}.stderr'}) ---\n" + "\n".join(lines)
        for _, r, lines in sorted(logs))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="pyslice_tpu_torch.parallel.dryrun", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda")
    ap.add_argument("--backend", choices=["gloo", "nccl"])
    ap.add_argument("--mesh", help="FxP (default: make_mesh's)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    out = Path(args.out)
    keep_stderr(out, int(os.environ.get("RANK", "0")))

    import torch
    import torch.distributed as dist
    from .mesh import make_mesh
    cfg_path = out / "config.json"
    cfg = json.loads(cfg_path.read_text()) if cfg_path.exists() else {}
    if args.device == "cpu":
        torch.set_num_threads(1)
    elif not torch.cuda.is_available():
        raise SystemExit("dryrun: no CUDA device (pass --device cpu)")
    f, p = ((int(v) for v in args.mesh.lower().split("x")) if args.mesh
            else (None, None))
    mesh = make_mesh(f, p, backend=args.backend, device=args.device)
    if args.device == "cuda":
        _check_built()
    device = torch.device(args.device, torch.cuda.current_device()) \
        if args.device == "cuda" else torch.device("cpu")
    r = Rank(out, mesh, device, cfg)
    r.record["wall"]["start"] = time.perf_counter() - t0
    for name in cfg.get("parts", PARTS):
        part_cfg = dict(cfg, **cfg.get(name, {}))
        kind = part_cfg.get("part", name)
        if kind == "msp" and "file" not in part_cfg:
            continue
        t1 = time.perf_counter()
        # an aliased part ({"part": kind, ...} under another name) prefixes
        # its outputs with its name and may run on a mesh of its own shape
        r.tag = "" if kind == name else name + "_"
        r.mesh = mesh if "mesh" not in part_cfg else make_mesh(
            *(int(v) for v in part_cfg["mesh"].lower().split("x")),
            device=args.device)
        getattr(r, kind)(part_cfg)
        r.record["wall"][name] = time.perf_counter() - t1
    r.mesh, r.tag = mesh, ""
    r.finish()
    dist.barrier()
    dist.destroy_process_group()
    return 0


# --- the parent's side ----------------------------------------------------

def launch(out, nproc: int, *, device: str = "cpu", backend=None, mesh=None,
           config=None, timeout: float = 300.0, env=None):
    """Run the dry run in ``nproc`` ranks under torchrun (``--standalone``:
    a free port) and return ``load(out, nproc)``. ``config`` is written to
    ``out/config.json``. The ranks run in a process group of their own;
    past ``timeout`` seconds the whole group is killed and TimeoutError
    raised. Each rank keeps its whole standard error in
    ``out/rank<r>.stderr``; a rank that fails raises RuntimeError with the
    last 100 lines of each failed rank's. On the card the kernels are
    built here first."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    if config is not None:
        (out / "config.json").write_text(json.dumps(config))
    if device == "cuda":
        from ..ops import fused_step as fs
        fs.build()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), "-m",
           "pyslice_tpu_torch.parallel.dryrun", "--out", str(out),
           "--device", device]
    if backend:
        cmd += ["--backend", backend]
    if mesh:
        cmd += ["--mesh", mesh]
    root = Path(__file__).resolve().parents[2]
    run_env = dict(os.environ, **(env or {}))
    run_env["PYTHONPATH"] = os.pathsep.join(
        [str(root)] + [p for p in [run_env.get("PYTHONPATH")] if p])
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=run_env,
                            cwd=root, start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        raise TimeoutError(f"dryrun ranks ran past {timeout} s:\n"
                           f"{failed_ranks(out, nproc, tail=30)}\n"
                           f"{log[-6000:]}")
    if proc.returncode != 0:
        # the failed ranks' own standard error first: the launcher's
        # summary that ends its log does not hold their exceptions
        raise RuntimeError(f"dryrun ranks failed (exit {proc.returncode}):"
                           f"\n{failed_ranks(out, nproc)}\n--- the "
                           f"launcher's output, last 4000 bytes ---\n"
                           f"{log[-4000:]}")
    return load(out, nproc)


def load(out, nproc: int):
    """[(arrays, record)] of every rank, in rank order."""
    out = Path(out)
    res = []
    for r in range(nproc):
        with np.load(out / f"rank{r}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        res.append((arrays, json.loads((out / f"rank{r}.json").read_text())))
    return res


if __name__ == "__main__":
    sys.exit(main())
