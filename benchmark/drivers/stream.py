"""Config 5's streamed TACAW: frame blocks into ``StreamingTACAW``.

Set-up builds the grid, the rasterizer plan, the 64 probes and the first
stream, as a user's script does before its trajectory starts. A step
feeds one block of ``block_frames`` thermal frames (drawn on the host from
the seed and the block's index, in the stream's seeded frame order) with
``add_frame_block``; the stream's device work stays queued, so the window
ends with a synchronize. When a stream has taken all its frames it is
read out (``intensity()`` for the maps, ``spectrum()`` to the host) and a
new one starts.

The check takes the first stream: the read-out intensity of sampled
probes (one a probe chunk) at every bin, against the plain reference's
DFT over the same frames. A run whose window ends before the first
stream is whole feeds it to the end after the window.
"""

from __future__ import annotations

import numpy as np

import inputs
from common import host, ref_grid, rel_l2, scan
from reference import plain


def slice_loop_shape(cell):
    """(probes a frame, nx, ny, nz) of the cell's slice loops."""
    g = ref_grid(cell.config)
    return len(scan(cell.config["probe_grid"])), g.nx, g.ny, g.nz


class Driver:

    def __init__(self, run):
        import torch
        import pyslice_tpu_torch as pt
        from pyslice_tpu_torch.engine.pipeline import SimSpec
        self.run, self.cfg, self.tr = run, run.config, run.traffic
        cfg = self.cfg
        self.torch, self.pt = torch, pt
        self.base, self.types = inputs.hbn_box(cfg["box_A"],
                                               cfg["layer_z_A"])
        self.n = cfg["stream_frames"]
        self.block = cfg["block_frames"]
        self.stream_no, self.block_no = 0, 0
        self.order = self._order(0)
        pick = inputs.generator(run.seed, inputs.SAMPLE)
        chunk = cfg["probe_chunk"]
        n_probes = len(scan(cfg["probe_grid"]))
        self.check_probes = [c + int(pick.integers(chunk))
                             for c in range(0, n_probes, chunk)]
        first = self.frames(0, 0)
        grid = pt.grid_from_box(cfg["box_A"], cfg["box_A"],
                                cfg["box_height_A"],
                                sampling=cfg["sampling_A"],
                                slice_thickness=cfg["slice_thickness_A"])
        plan = pt.make_plan(grid.xs, grid.ys, grid.zs,
                            np.concatenate([self.base[None], first]),
                            self.types)
        self.spec = SimSpec.create(grid, plan, cfg["voltage_eV"])
        base = pt.Probe(grid.xs, grid.ys, cfg["aperture_mrad"],
                        cfg["voltage_eV"], device=run.device)
        self.probes = pt.create_batched_probes(
            base, scan(cfg["probe_grid"])).array
        self.kept = None
        self.stream = self._new_stream()

    def _order(self, stream_no: int) -> np.ndarray:
        return inputs.generator(self.run.seed, inputs.STREAM_ORDER,
                                stream_no).permutation(self.n)

    def frames(self, stream_no: int, block_no: int) -> np.ndarray:
        return inputs.thermal_frames(self.base, self.block,
                                     self.cfg["thermal_sigma_A"],
                                     self.run.seed, inputs.STREAM_BLOCK,
                                     stream_no, block_no)

    def _new_stream(self):
        cfg = self.cfg
        return self.pt.StreamingTACAW(
            self.spec, self.probes, self.n, cfg["timestep_ps"],
            frequencies=cfg["frequencies_THz"],
            probe_chunk=cfg["probe_chunk"])

    def prepare(self):
        """Blocks are drawn inside the step: the device is still busy
        with the blocks before it."""

    def warm(self):
        self.step()

    def step(self, x=None) -> int:
        run = self.run
        b = self.block_no
        idx = self.order[b * self.block:(b + 1) * self.block]
        with run.spans("feed"):
            self.stream.add_frame_block(idx.tolist(),
                                        self.frames(self.stream_no, b))
        self.block_no += 1
        if self.block_no * self.block == self.n:
            with run.spans("readout"):
                inten = self.stream.intensity()
                self.stream.spectrum()
            if self.stream_no == 0:
                self.kept = {"bins": host(inten[:, self.check_probes])}
            del inten
            self.stream = None
            self.stream_no += 1
            self.block_no = 0
            self.order = self._order(self.stream_no)
            self.stream = self._new_stream()
        return len(idx)

    def drain(self):
        """Feed the first stream to its end if the window did not."""
        while self.kept is None:
            self.step()

    def counters(self) -> dict:
        return {}

    def outputs(self) -> dict:
        return self.kept

    def release(self):
        self.stream = self.probes = None

    def reference(self, prec) -> dict:
        torch = self.torch
        cfg, dev = self.cfg, self.run.device
        grid = ref_grid(cfg)
        eV = cfg["voltage_eV"]
        bins = plain.stream_bins(self.n, cfg["timestep_ps"],
                                 cfg["frequencies_THz"])
        order = self._order(0)
        psi0 = plain.probes(grid, cfg["aperture_mrad"], eV,
                            scan(cfg["probe_grid"])[self.check_probes],
                            prec, dev)
        acc = torch.zeros((len(bins),) + tuple(psi0.shape),
                          dtype=prec.complex, device=dev)
        total = torch.zeros_like(psi0)
        for b in range(self.n // self.block):
            frames = self.frames(0, b)
            idx = order[b * self.block:(b + 1) * self.block]
            w = torch.as_tensor(plain.phase_weights(idx, bins, self.n),
                                device=dev).to(prec.complex)
            for k in range(len(idx)):
                v = plain.potential(frames[k], self.types, grid, prec, dev)
                psi = plain.exit_waves(psi0, v, grid, eV, prec)
                acc += w[k, :, None, None, None] * psi[None]
                total += psi
        weights = torch.as_tensor(
            plain.phase_weights(np.arange(self.n), bins, self.n).sum(0),
            device=dev).to(prec.complex)
        return {"bins": np.stack([host(plain.dft_intensity(
            acc[:, p], total[p], weights, self.n))
            for p in range(len(self.check_probes))], axis=1)}


def combine_outputs(parts: list) -> dict:
    return parts[0]


def combine_reference(parts: list, cell) -> dict:
    return parts[0]


def compare(got: dict, want: dict) -> dict:
    return {"stream_bins": rel_l2([got["bins"]], [want["bins"]])}
