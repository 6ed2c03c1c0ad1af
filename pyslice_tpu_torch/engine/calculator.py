"""MultisliceCalculator — the reference-compatible orchestration facade.

Counterpart of ``pyslice_tpu/engine/calculator.py`` (reference
``calculators.py:39-250``): ``setup``/``run`` with the same defaults, over
``engine.pipeline``. The device is explicit: ``MultisliceCalculator(device=
"cuda")`` runs on the card and never moves to the CPU on its own.

* ``run()`` (host path) pulls each frame's exit waves to a NumPy array
  (complex128 in double precision, complex64 otherwise) and keeps the
  crash-resume frame cache: one .npy per frame under
  ``psi_data/torch_<md5-12>/``, keyed by an md5 of the parameters. The key
  digests every frame's positions, so with the cache off ``output_dir`` is
  computed on first read only (``STATS["cache_key_digests"]`` counts the
  digests taken).
* ``setup(device_output=True)`` keeps the exit waves on the device: the
  WFData holds a tensor that TACAWData / HAADFData reduce in place.
* ``defocus`` is applied to the base probe; the probe batch is built once
  per (base probe, probe positions) pair, so rebinding
  ``probe_positions`` after ``setup`` is honoured.
* ``batch_size`` bounds the probes propagated per call.
* ``setup(mesh=...)`` (a ``parallel.mesh.make_mesh`` DeviceMesh; every
  rank runs the same calls) shards the run over (frame, probe): ``run()``
  returns a WFData whose wave data is a DTensor on the ranks' devices,
  reduced in place by TACAWData / HAADFData / the detectors. Construct the
  calculator on the rank's device (``device="cuda"`` is the card
  ``make_mesh`` made current).

``frame_block`` is gone, since eager PyTorch has no per-dispatch program to
amortize.
"""

from __future__ import annotations

import hashlib
import logging
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..analysis.wf_data import WFData, to_numpy
from ..core.dtypes import get_precision
from ..core.grids import grid_from_trajectory
from ..data.trajectory import Trajectory
from ..physics.aberrations import Aberrations
from ..physics.potential import make_plan
from ..physics.probe import Probe, create_batched_probes
from ..utils.profiling import span
from .pipeline import SimSpec, frame_exit_waves, simulate_frames_into

logger = logging.getLogger(__name__)

STATS = {"cache_key_digests": 0}


def device_memory_limit(device: torch.device) -> Optional[int]:
    """Free bytes on a CUDA ``device`` (``torch.cuda.mem_get_info``), or
    None for the CPU, whose host memory is not budgeted here."""
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[0]


class MultisliceCalculator:

    def __init__(self, device, precision=None):
        self.device = torch.device(device)
        self.precision = get_precision(precision)
        self.mesh = None

    def _generate_cache_key(self) -> str:
        """md5-12 of the simulation parameters, atomic positions included."""
        STATS["cache_key_digests"] += 1
        t = self.trajectory
        pos_digest = hashlib.md5(
            np.ascontiguousarray(t.positions).tobytes()).hexdigest()
        params = {
            "n_frames": t.n_frames,
            "n_atoms": t.n_atoms,
            "positions_md5": pos_digest,
            "box_matrix": np.asarray(t.box_matrix).tolist(),
            "atom_types": np.asarray(t.atom_types).tolist(),
            "aperture": self.aperture,
            "voltage_eV": self.voltage_eV,
            "defocus": self.defocus,
            "slice_thickness": self.slice_thickness,
            "sampling": self.sampling,
            "probe_positions": np.asarray(self.probe_positions).tolist(),
            "record_layers": self.record_layers,
            "slice_axis": self.slice_axis,
            "grid_shape": (self.nx, self.ny, self.nz),
            "backend": f"torch-{self.precision.name}",
        }
        if self.bandwidth_limit is not None:
            params["bandwidth_limit"] = self.bandwidth_limit
        if self.tilt is not None:
            params["tilt"] = self.tilt
        if self.aberrations is not None:
            params["aberrations"] = repr(self.aberrations)
        if self.debye_waller:
            params["debye_waller"] = sorted(
                (str(k), float(v)) for k, v in self.debye_waller.items())
        return hashlib.md5(str(sorted(params.items())).encode()).hexdigest()[:12]

    @property
    def output_dir(self) -> Path:
        """The frame cache's directory, ``<cache_root>/torch_<md5-12>``."""
        if self._output_dir is None:
            self._output_dir = (Path(self.cache_root)
                                / f"torch_{self._generate_cache_key()}")
        return self._output_dir

    def setup(self,
              trajectory: Trajectory,
              aperture: float = 0.0,
              voltage_eV: float = 60e3,
              defocus: float = 0.0,
              slice_thickness: float = 0.5,
              sampling: float = 0.1,
              probe_positions: Optional[List[Tuple[float, float]]] = None,
              batch_size: Optional[int] = None,
              save_path: Optional[Path] = None,
              cleanup_temp_files: bool = False,
              slice_axis: int = 2,
              record_layers: Optional[List[int]] = None,
              use_cache: bool = True,
              cache_root: str = "psi_data",
              fast_grid: bool = False,
              device_output: bool = False,
              aberrations=None,
              mesh=None,
              bandwidth_limit: Optional[float] = None,
              tilt: Optional[Tuple[float, float]] = None,
              debye_waller=None):
        """Reference-compatible setup (calculators.py:96-161); see the JAX
        package's docstring for ``batch_size``, ``bandwidth_limit``,
        ``tilt`` and ``debye_waller``. ``aberrations``: an
        ``Aberrations`` or a dict of its coefficients, applied to the base
        probe after ``defocus``. ``mesh``: a ('frame', 'probe')
        DeviceMesh; the frame and probe counts must divide by its
        extents (checked here)."""
        with span("setup"):
            if isinstance(aberrations, dict):
                aberrations = Aberrations(**aberrations)
            self.aberrations = aberrations
            self.trajectory = trajectory
            self.aperture = aperture
            self.voltage_eV = voltage_eV
            self.defocus = defocus
            self.slice_thickness = slice_thickness
            self.sampling = sampling
            self.save_path = save_path
            self.cleanup_temp_files = cleanup_temp_files
            self.slice_axis = slice_axis
            self.batch_size = batch_size
            self.device_output = device_output
            if device_output and use_cache:
                logger.info("device_output=True disables the frame cache "
                            "(use WFData.save for checkpointing)")
                use_cache = False
            self.use_cache = use_cache
            self.mesh = mesh

            grid = grid_from_trajectory(trajectory, sampling=sampling,
                                        slice_thickness=slice_thickness,
                                        fast_grid=fast_grid)
            self.grid = grid
            self.xs, self.ys, self.zs = grid.xs, grid.ys, grid.zs
            self.lx, self.ly, self.lz = grid.lx, grid.ly, grid.lz
            self.nx, self.ny, self.nz = grid.nx, grid.ny, grid.nz
            self.dx, self.dy = grid.dx, grid.dy

            if probe_positions is None:
                probe_positions = [(grid.lx / 2, grid.ly / 2)]  # center
            self.probe_positions = probe_positions
            self.n_probes = len(probe_positions)
            self.n_frames = trajectory.n_frames
            self.record_layers = (tuple(int(l) for l in record_layers)
                                  if record_layers is not None else None)

            oblique = grid.is_oblique
            with span("setup.probe"):
                self.base_probe = Probe(
                    grid.xs, grid.ys, aperture, voltage_eV,
                    precision=self.precision, device=self.device,
                    cell2d=grid.cell2d if oblique else None,
                    ksq=grid.ksq2d() if oblique else None)
                if defocus:
                    self.base_probe.defocus(defocus)
                if aberrations is not None:
                    self.base_probe.aberrate(aberrations)
            self._batched_probes = None

            self.debye_waller = dict(debye_waller) if debye_waller else None
            plan = make_plan(grid.xs, grid.ys, grid.zs, trajectory.positions,
                             trajectory.atom_types, kind="kirkland",
                             slice_axis=slice_axis,
                             cell2d=grid.cell2d if oblique else None,
                             debye_waller=debye_waller)
            self.bandwidth_limit = bandwidth_limit
            self.tilt = tuple(float(t) for t in tilt) if tilt is not None \
                else None
            self.spec = SimSpec.create(grid, plan, voltage_eV,
                                       record_layers=self.record_layers,
                                       precision=self.precision,
                                       bandwidth_limit=bandwidth_limit,
                                       tilt=tilt)

            if mesh is not None:
                from ..parallel.sharded import _check_divisible
                _check_divisible(mesh, n_frames=self.n_frames,
                                 n_probes=self.n_probes)
            elif device_output:
                self._warn_resident(device_memory_limit(self.device))

            self.cache_root = cache_root
            self._output_dir = None
            if self.use_cache:
                self.output_dir.mkdir(parents=True, exist_ok=True)

    def _warn_resident(self, limit: Optional[int]) -> None:
        """Warn at set-up, not mid-run, when the resident exit-wave array
        would take more than half of ``limit`` bytes, and point at the
        streaming engines, which exist for larger-than-memory runs."""
        n_layers = self._n_layers()
        est = (self.n_probes * self.n_frames * self.nx * self.ny * n_layers
               * torch.empty((), dtype=self.precision.complex).element_size())
        if limit is not None and est > 0.5 * limit:
            logger.warning(
                "device_output=True keeps a %.1f GiB exit-wave array "
                "resident (%d probes x %d frames x %dx%d%s) against "
                "%.1f GiB of free device memory. For larger-than-memory "
                "runs use engine.streaming.StreamingTACAW/StreamingHAADF "
                "(O(selected-bins) memory) or record fewer layers.",
                est / 2 ** 30, self.n_probes, self.n_frames, self.nx,
                self.ny, f" x {n_layers} layers" if n_layers > 1 else "",
                limit / 2 ** 30)

    def _n_layers(self) -> int:
        return len(self.record_layers) if self.record_layers else 1

    def _probes_array(self) -> torch.Tensor:
        """(n_probes, nx, ny) batched probes, rebuilt when the base probe
        array or the probe positions change."""
        ref = self.base_probe.array
        pos = np.array(self.probe_positions, dtype=np.float64)
        cached = self._batched_probes
        if (cached is None or cached[0] is not ref
                or not np.array_equal(cached[1], pos)):
            batch = create_batched_probes(self.base_probe, pos).array
            self._batched_probes = (ref, pos, batch)
        return self._batched_probes[2]

    def _frame_kspace(self, positions, probes) -> torch.Tensor:
        """(n_probes, nx, ny, n_layers) for one frame, probe-chunked if
        batch_size is set."""
        bs = self.batch_size
        if bs is None or self.n_probes <= bs:
            return frame_exit_waves(positions, probes, self.spec)
        return torch.cat([frame_exit_waves(positions, probes[i:i + bs],
                                           self.spec)
                          for i in range(0, self.n_probes, bs)], dim=0)

    def _ksq_shifted(self):
        if not self.grid.is_oblique:
            return None
        return np.fft.fftshift(self.grid.ksq2d())

    def _wf_data(self, wavefunction_data) -> WFData:
        # Exported k axes use the requested sampling (quirk 12).
        layer = (np.asarray(self.record_layers)
                 if self.record_layers is not None else np.array([0]))
        wf = WFData(probe_positions=self.probe_positions,
                    time=np.arange(self.n_frames) * self.trajectory.timestep,
                    kxs=self.grid.kxs_nominal_shifted(),
                    kys=self.grid.kys_nominal_shifted(),
                    layer=layer, wavefunction_data=wavefunction_data,
                    probe=self.base_probe, ksq_shifted=self._ksq_shifted())
        if self.save_path is not None:
            save_dir = Path(self.save_path)
            save_dir.mkdir(parents=True, exist_ok=True)
            wf.save(save_dir / "wf_data.npz")
        return wf

    def _progress(self, progress: bool):
        if not progress:
            return None
        try:
            from tqdm import tqdm
        except ImportError:
            return None
        return tqdm(total=self.n_frames, desc="Processing frames",
                    unit="frame")

    def _run_device(self, progress: bool) -> WFData:
        """Device-resident run: exit waves fill one device tensor and never
        cross to the host."""
        t0 = time.time()
        shape = (self.n_probes, self.n_frames, self.nx, self.ny,
                 self._n_layers())
        out = torch.zeros(shape, dtype=self.precision.complex,
                          device=self.device)
        probes = self._probes_array()
        # All frames' positions go to the device in one copy: a per-frame
        # copy from host memory would wait for the previous frame's kernels.
        positions = torch.as_tensor(self.trajectory.positions,
                                    device=self.device)
        bar = self._progress(progress)
        for i in range(self.n_frames):
            if self.batch_size is None:
                simulate_frames_into(out, i, positions[i:i + 1], probes,
                                     self.spec)
            else:
                out[:, i] = self._frame_kspace(positions[i], probes)
            if bar:
                bar.update(1)
        if bar:
            bar.close()
        logger.info("Device-resident simulation dispatched in %.2fs",
                    time.time() - t0)
        return self._wf_data(out)

    def _run_mesh(self) -> WFData:
        """Sharded run over the (frame, probe) mesh: each rank propagates
        its frames for its probes (``parallel.sharded.run_sharded``); the
        WFData holds the DTensor, and ``save_path`` writes wf_data.npz from
        rank 0 after a gather."""
        from ..parallel.sharded import run_sharded
        t0 = time.time()
        positions = torch.as_tensor(self.trajectory.positions,
                                    device=self.device)
        wf = run_sharded(positions, self._probes_array(), self.spec,
                         self.mesh)
        logger.info("Sharded simulation dispatched in %.2fs over mesh %s",
                    time.time() - t0, tuple(self.mesh.shape))
        return self._wf_data(wf)

    def run(self, progress: bool = True) -> WFData:
        with span("run"):
            if self.mesh is not None:
                return self._run_mesh()
            if self.device_output:
                return self._run_device(progress)
            return self._run_host(progress)

    def _run_host(self, progress: bool) -> WFData:
        """Host run: each frame's exit waves to a NumPy array, through the
        frame cache."""
        t0 = time.time()
        dtype = (np.complex128 if self.precision.name == "double"
                 else np.complex64)
        out = np.zeros((self.n_probes, self.n_frames, self.nx, self.ny,
                        self._n_layers()), dtype=dtype)
        probes = self._probes_array()
        computed = cached = 0
        bar = self._progress(progress)
        for i in range(self.n_frames):
            path = (self.output_dir / f"frame_{i}.npy" if self.use_cache
                    else None)
            if path is not None and path.exists():
                out[:, i] = np.load(path)
                cached += 1
            else:
                data = to_numpy(self._frame_kspace(
                    self.trajectory.positions[i], probes))
                out[:, i] = data
                if self.use_cache:
                    np.save(path, data)
                computed += 1
            if bar:
                bar.update(1)
        if bar:
            bar.close()
        logger.info("Simulation completed in %.2fs (%d computed, %d cached)",
                    time.time() - t0, computed, cached)
        wf = self._wf_data(out)
        if self.use_cache and self.cleanup_temp_files:
            for i in range(self.n_frames):
                (self.output_dir / f"frame_{i}.npy").unlink(missing_ok=True)
            try:
                self.output_dir.rmdir()
            except OSError:
                pass
        return wf
