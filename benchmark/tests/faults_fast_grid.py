"""Faults planted underneath a run of the fast-grid cell, one function
each; the harness calls the one a test names first (``opts["patch"]``)."""


def grid_not_snapped():
    """The job runs without ``fast_grid``: the calculator keeps the
    reference's unsnapped int(l / sampling) + 1 points a side."""
    from pyslice_tpu_torch.engine import calculator
    inner = calculator.grid_from_trajectory

    def grid(trajectory, **kw):
        return inner(trajectory, **dict(kw, fast_grid=False))
    calculator.grid_from_trajectory = grid


def k_axes_at_requested_sampling():
    """The exported k axes are fftfreq(n, sampling), the requested pitch,
    where the snapped grid's is l / n."""
    import numpy as np
    from pyslice_tpu_torch.core.grids import Grid
    Grid.kxs_nominal_shifted = lambda self: np.fft.fftshift(
        np.fft.fftfreq(self.nx, d=self.sampling))
    Grid.kys_nominal_shifted = lambda self: np.fft.fftshift(
        np.fft.fftfreq(self.ny, d=self.sampling))


def one_frame_high():
    """Frame 1 of every job comes out 1% too large."""
    from pyslice_tpu_torch.engine import calculator
    inner = calculator.simulate_frames_into

    def into(out, i0, positions_frames, probes, spec):
        inner(out, i0, positions_frames, probes, spec)
        if i0 == 1:
            out[:, 1] *= 1.01
        return out
    calculator.simulate_frames_into = into
