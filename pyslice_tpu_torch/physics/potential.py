"""Projected-potential rasterization in reciprocal space.

Counterpart of ``pyslice_tpu/physics/potential.py``. For every slice, each
atom is painted as a k-space sinusoid (a sub-pixel delta),

    S_s(kx, ky) = sum_{atoms a in slice s} exp(-2 pi i kx x_a) exp(-2 pi i ky y_a),

multiplied by the Kirkland form factor of its element; one inverse FFT per
slice, the real part, and the 1/(dx dy)^2 normalization give the potential.

The host plan (``make_plan``) is the JAX package's, field for field: atoms
of all frames are binned into (type, slice) buckets (here in one pass over
chunks of frames, where the JAX package loops over frames), and only
occupied buckets, each with padded capacity ``a_max``, are computed. At run
time each bucket's structure factor is one complex matrix product
(nx, a_max) @ (a_max, ny) (``torch.matmul``, TF32 off — see
``core.dtypes``), summed into the (nz, nx, ny) reciprocal stack, then one
batched ``torch.fft.ifft2``. The JAX package left this to XLA, so it is
library code here, not a kernel.

Slice-binning edge rules (reference potentials.py:302-307): bin s covers
[coord_s - dz/2, coord_s + dz/2), except bin 0 starts at 0 and the last bin
extends to coord_last + dz.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ..core.dtypes import Precision, get_precision
from ..utils.plotting import pyplot
from ..utils.profiling import span
from . import kirkland


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad_buckets(arr: np.ndarray) -> np.ndarray:
    """Pad a bucket list to a multiple of 4 with -1 sentinels (zero-work
    entries), as the JAX plan does."""
    pad = -len(arr) % 4
    if pad:
        arr = np.concatenate([arr, np.full(pad, -1, dtype=arr.dtype)])
    return arr


def slice_edges(slice_coords: np.ndarray, spacing: float) -> np.ndarray:
    """Bin edges implementing the reference's slice rules."""
    coords = np.asarray(slice_coords, dtype=np.float64)
    n = len(coords)
    edges = np.empty(n + 1, dtype=np.float64)
    edges[0] = 0.0
    if n > 1:
        edges[1:n] = coords[1:] - spacing / 2.0
    edges[n] = coords[-1] + spacing
    return edges


def bin_atoms_np(coords: np.ndarray, edges: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side binning: returns (slice_index, valid_mask)."""
    idx = np.searchsorted(edges, coords, side="right") - 1
    valid = (idx >= 0) & (idx < len(edges) - 1)
    return idx, valid


# make_plan bins the frames in chunks of at most this many atoms (at least
# one frame), so its host memory stays a few MB however long the run.
PLAN_CHUNK_ATOMS = 1 << 16

# A chunk whose coordinates span at most this many cell bounds is binned
# by one comparison per bound; a wider one by a binary search.
_COMPARE_BOUNDS = 16


def _float32_thresholds(edges: np.ndarray) -> np.ndarray:
    """For each (finite) edge e, the least float64 x with float32(x) >=
    float32(e). Rounding is monotone, so binning float32(x) against the
    float32 edges equals binning x against these thresholds."""
    c = edges.astype(np.float32)
    below = np.nextafter(c, np.float32(-np.inf))
    # The midpoint of two adjacent float32 values is exact in float64; it
    # rounds to c or to its neighbour below (ties to even).
    mid = (below.astype(np.float64) + c.astype(np.float64)) / 2.0
    return np.where(mid.astype(np.float32) >= c, mid,
                    np.nextafter(mid, np.inf))


def _cells(z: np.ndarray, bounds: np.ndarray, base: np.ndarray) -> np.ndarray:
    """``base + searchsorted(bounds, z, side="right")``. A chunk whose
    coordinates lie within a few bounds (a thin specimen's layer) is
    counted by comparisons against those bounds alone."""
    lo, hi = z.min(), z.max()
    if not np.isnan(lo):                 # a NaN coordinate makes lo NaN
        a, b = np.searchsorted(bounds, [lo, hi], side="right")
        if b - a <= _COMPARE_BOUNDS:
            cells = base + a
            for bound in bounds[a:b]:
                cells += z >= bound
            return cells
    cells = np.searchsorted(bounds, z, side="right")
    cells += base
    return cells


def _occupancy(pos: np.ndarray, slice_axis: int, edges: np.ndarray,
               type_ids: np.ndarray, n_types: int) -> Tuple[np.ndarray, int]:
    """(occupied (n_types * nz,) bool, largest atom count of one (frame,
    type, slice) bucket) over all frames, each binned both in float64 and
    in float32: the run bins in its own precision, and an atom exactly on
    an edge can round across it in float32.

    Both binnings are ``searchsorted(side="right") - 1`` against sorted
    bounds, so one search against the merged bounds (the edges and their
    float32 thresholds) finds each atom's cell, one ``bincount`` counts the
    cells of every (frame, type), and running sums over the cells give each
    cast's slices; out-of-slab cells fall in no slice."""
    nz = len(edges) - 1
    n_frames, n_atoms = pos.shape[:2]
    occupied = np.zeros((n_types, nz), dtype=bool)
    if n_atoms == 0:
        return occupied.ravel(), 0
    thresholds = _float32_thresholds(edges)
    bounds = np.sort(np.concatenate([edges, thresholds]))
    n_cells = len(bounds) + 1
    # The least coordinate of each cell (-inf below the first bound) gives
    # the cell's slice in each cast (-1 and nz lie outside the slab); the
    # slices climb with the cells, so slice s is the run of cells
    # [first[s], last[s]) in each cast.
    least = np.concatenate([[-np.inf], bounds])
    first, last = [], []
    for b in (edges, thresholds):
        slices = np.searchsorted(b, least, side="right") - 1
        first.append(np.searchsorted(slices, np.arange(nz), side="left"))
        last.append(np.searchsorted(slices, np.arange(nz), side="right"))
    first, last = np.concatenate(first), np.concatenate(last)
    per_chunk = max(1, PLAN_CHUNK_ATOMS // n_atoms)
    base = ((np.arange(min(per_chunk, n_frames))[:, None] * n_types
             + type_ids) * n_cells)
    max_count = 0
    for f0 in range(0, n_frames, per_chunk):
        z = np.ascontiguousarray(pos[f0:f0 + per_chunk, :, slice_axis])
        cells = _cells(z, bounds, base[:len(z)])
        counts = np.bincount(cells.ravel(),
                             minlength=len(z) * n_types * n_cells)
        running = np.zeros((len(z) * n_types, n_cells + 1), dtype=np.int64)
        np.cumsum(counts.reshape(-1, n_cells), axis=1, out=running[:, 1:])
        per_slice = running[:, last] - running[:, first]      # (., 2 nz)
        max_count = max(max_count, int(per_slice.max()))
        occupied |= (per_slice.reshape(len(z), n_types, 2, nz) > 0).any(
            axis=(0, 2))
    return occupied.ravel(), max_count


@dataclasses.dataclass(frozen=True, eq=False)
class RasterizerPlan:
    """Host description of one rasterization config (the JAX plan's
    fields, one for one; ``interop.plan_from_numpy`` builds it from them)."""

    nx: int
    ny: int
    nz: int
    dx: float
    dy: float
    slice_axis: int
    inplane_axis1: int
    inplane_axis2: int
    kxs: np.ndarray               # (nx,) fftfreq, actual pitch
    kys: np.ndarray               # (ny,)
    edges: np.ndarray             # (nz+1,) slice bin edges
    type_ids: np.ndarray          # (n_atoms,) int in [0, n_types)
    unique_z: np.ndarray          # (n_types,) atomic numbers
    bucket_types: np.ndarray      # (n_buckets,) type id of each occupied bucket
    bucket_slices: np.ndarray     # (n_buckets,) slice id of each occupied bucket
    a_max: int                    # padded atom capacity per bucket
    kind: str                     # "kirkland" | "gauss"
    # Oblique in-plane cells: frac2d = inv(cell2d) maps Cartesian in-plane
    # coordinates to fractional ones, kxs/kys then hold INTEGER
    # frequencies, qsq2d the oblique |k|^2 and px_area the area per sample.
    frac2d: np.ndarray = None
    qsq2d: np.ndarray = None
    px_area: float = None         # defaults to dx*dy
    # Optional per-type Debye-Waller B factors (A^2).
    dwf_b: np.ndarray = None

    @property
    def n_types(self) -> int:
        return len(self.unique_z)

    @property
    def n_buckets(self) -> int:
        return len(self.bucket_types)


def _normalize_types(atom_types) -> Tuple[np.ndarray, np.ndarray]:
    """atom_types (ints or element names) -> (type_ids, unique Z)."""
    atom_types = np.asarray(atom_types)
    if atom_types.dtype.kind in ("U", "S", "O"):
        zs = np.array([kirkland.element_to_z(str(t)) for t in atom_types],
                      dtype=np.int64)
    else:
        zs = atom_types.astype(np.int64)
    unique_z, type_ids = np.unique(zs, return_inverse=True)
    return type_ids.astype(np.int32), unique_z


def make_plan(xs, ys, zs, positions_all_frames, atom_types,
              kind: str = "kirkland", slice_axis: int = 2,
              pad_fraction: float = 0.0, cell2d=None,
              debye_waller=None) -> RasterizerPlan:
    """Build the host rasterization plan.

    Args:
        positions_all_frames: (n_frames, n_atoms, 3) or (n_atoms, 3). Sets
            bucket occupancy and capacity only.
        pad_fraction: extra fractional headroom on a_max.
        cell2d: optional (2, 2) in-plane cell vectors (columns) for oblique
            cells (slice_axis must be 2).
        debye_waller: optional {Z or element name: B} factors (A^2).
    """
    with span("setup.plan"):
        if cell2d is not None and slice_axis != 2:
            raise ValueError("oblique cells require slice_axis=2")
        xs = np.asarray(xs, dtype=np.float64)
        ys = np.asarray(ys, dtype=np.float64)
        zs = np.asarray(zs, dtype=np.float64)
        pos = np.asarray(positions_all_frames, dtype=np.float64)
        if pos.ndim == 2:
            pos = pos[None]

        all_axes = [0, 1, 2]
        all_axes.remove(slice_axis)
        ax1, ax2 = all_axes

        slice_coords = [xs, ys, zs][slice_axis]
        spacings = [
            xs[1] - xs[0] if len(xs) > 1 else 0.5,
            ys[1] - ys[0] if len(ys) > 1 else 0.5,
            zs[1] - zs[0] if len(zs) > 1 else 0.5,
        ]
        spacing = float(spacings[slice_axis])
        nz = len(slice_coords)
        edges = slice_edges(slice_coords, spacing)

        type_ids, unique_z = _normalize_types(atom_types)
        n_types = len(unique_z)
        dwf_b = None
        if debye_waller:
            bz = {}
            for key, b in debye_waller.items():
                z = kirkland.element_to_z(str(key)) if isinstance(key, str) \
                    else int(key)
                if b < 0:
                    raise ValueError(f"Debye-Waller B must be >= 0, got {b} "
                                     f"for {key}")
                bz[z] = float(b)
            unknown = set(bz) - set(int(z) for z in unique_z)
            if unknown:
                raise ValueError(
                    f"debye_waller lists elements not in the structure: "
                    f"{sorted(unknown)} (present: "
                    f"{[int(z) for z in unique_z]})")
            dwf_b = np.array([bz.get(int(z), 0.0) for z in unique_z],
                             dtype=np.float64)

        occupied, max_count = _occupancy(pos, slice_axis, edges, type_ids,
                                         n_types)
        if max_count == 0:
            # No atoms in the box: one empty bucket keeps shapes valid.
            occupied[0] = True
            max_count = 1

        # a_max climbs the JAX plan's ~1.25x ladder of multiples of 8, so
        # both packages pick the same capacity.
        a_max = _round_up(
            max(1, int(np.ceil(max_count * (1.0 + pad_fraction)))), 8)
        step = 8
        while step < a_max:
            step = _round_up(int(step * 1.25) + 1, 8)
        a_max = step
        occ_bins = np.nonzero(occupied)[0].astype(np.int32)

        nx_, ny_ = len(xs), len(ys)
        if cell2d is not None:
            A = np.asarray(cell2d, dtype=np.float64)
            frac2d = np.linalg.inv(A)
            kxs_plan = np.rint(np.fft.fftfreq(nx_) * nx_)
            kys_plan = np.rint(np.fft.fftfreq(ny_) * ny_)
            B = np.linalg.inv(A).T
            g11 = float(B[:, 0] @ B[:, 0])
            g22 = float(B[:, 1] @ B[:, 1])
            g12 = float(B[:, 0] @ B[:, 1])
            qsq2d = (g11 * kxs_plan[:, None] ** 2
                     + g22 * kys_plan[None, :] ** 2
                     + 2.0 * g12 * kxs_plan[:, None] * kys_plan[None, :])
            px_area = abs(float(np.linalg.det(A))) / (nx_ * ny_)
        else:
            frac2d = None
            kxs_plan = np.fft.fftfreq(nx_, d=float(xs[1] - xs[0]))
            kys_plan = np.fft.fftfreq(ny_, d=float(ys[1] - ys[0]))
            qsq2d = None
            px_area = float(xs[1] - xs[0]) * float(ys[1] - ys[0])

        return RasterizerPlan(
            nx=nx_, ny=ny_, nz=nz,
            dx=float(xs[1] - xs[0]), dy=float(ys[1] - ys[0]),
            slice_axis=slice_axis, inplane_axis1=ax1, inplane_axis2=ax2,
            kxs=kxs_plan, kys=kys_plan,
            edges=edges, type_ids=type_ids, unique_z=unique_z,
            bucket_types=_pad_buckets((occ_bins // nz).astype(np.int32)),
            bucket_slices=_pad_buckets((occ_bins % nz).astype(np.int32)),
            a_max=int(a_max), kind=kind,
            frac2d=frac2d, qsq2d=qsq2d, px_area=px_area, dwf_b=dwf_b,
        )


def form_factors(plan: RasterizerPlan, precision: Precision,
                 device) -> torch.Tensor:
    """(n_types, nx, ny) real form-factor tables on the physical k grid,
    Debye-Waller damped when the plan carries B factors. |k|^2 is formed
    in float64 on ``device`` and then cast, as the JAX package casts its
    float64 host grid."""
    if plan.qsq2d is not None:
        qsq64 = torch.as_tensor(plan.qsq2d, dtype=torch.float64,
                                device=device)
    else:
        kx = torch.as_tensor(plan.kxs, dtype=torch.float64, device=device)
        ky = torch.as_tensor(plan.kys, dtype=torch.float64, device=device)
        qsq64 = kx[:, None] ** 2 + ky[None, :] ** 2
    qsq = qsq64.to(precision.real)
    if plan.kind == "kirkland":
        ffs = kirkland.form_factor(qsq, plan.unique_z, dtype=precision.real)
    elif plan.kind == "gauss":
        # Reference debug potential: exp(-qsq/2) for every type.
        ffs = torch.exp(-qsq / 2.0).expand((plan.n_types,) + qsq.shape)
    else:
        raise ValueError(f"Unknown potential kind {plan.kind!r}")
    if plan.dwf_b is not None:
        b = torch.as_tensor(plan.dwf_b, dtype=precision.real, device=device)
        ffs = ffs * torch.exp(-0.25 * b[:, None, None] * qsq)
    return ffs


@functools.lru_cache(maxsize=8)
def plan_tensors(plan: RasterizerPlan, precision: Precision,
                 device: torch.device) -> dict:
    """The plan's per-frame constants as tensors on ``device``, made once
    per (plan, precision, device): slice edges and type ids in the run
    precision, the k axes in float64 (``kxs``/``kys``; callers cast), the
    occupied buckets' bins, and the form-factor tables. Uploading them for
    every frame would put a host-to-device copy, and with it a wait for the
    device, in front of every frame's kernels."""
    real = plan.bucket_types >= 0
    bt = plan.bucket_types[real].astype(np.int64)
    bs = plan.bucket_slices[real].astype(np.int64)
    as_dev = functools.partial(torch.as_tensor, device=device)
    return dict(
        edges=as_dev(plan.edges, dtype=precision.real),
        type_ids=as_dev(plan.type_ids, dtype=torch.int64),
        kxs=as_dev(plan.kxs, dtype=torch.float64),
        kys=as_dev(plan.kys, dtype=torch.float64),
        frac2d=(None if plan.frac2d is None
                else as_dev(plan.frac2d, dtype=precision.real)),
        buckets=list(zip(bt.tolist(), bs.tolist())),
        bucket_bins=as_dev(bt * plan.nz + bs),
        ffs=form_factors(plan, precision, device),
    )


def rasterize(positions, plan: RasterizerPlan, precision=None,
              device=None) -> torch.Tensor:
    """One frame's projected potential, (nz, nx, ny) real, slice-major.

    ``positions``: (n_atoms, 3) Angstrom, a tensor (its device is used) or
    an array placed on ``device``.
    """
    prec = get_precision(precision)
    with span("rasterize"):
        if not isinstance(positions, torch.Tensor):
            if device is None:
                raise ValueError("rasterize() of a host array needs a "
                                 "device")
            positions = torch.as_tensor(np.asarray(positions), device=device)
        return _rasterize_from(positions, plan, prec)


def _rasterize_from(positions: torch.Tensor, plan: RasterizerPlan,
                    prec: Precision) -> torch.Tensor:
    """Rasterizer body. Sentinel buckets (type < 0) are skipped; they add
    exactly zero in the JAX package too."""
    dev = positions.device
    c = plan_tensors(plan, prec, dev)
    positions = positions.to(prec.real)
    n_atoms = positions.shape[0]

    if plan.frac2d is not None:
        frac = positions[:, :2] @ c["frac2d"].T
        x, y = frac[:, 0], frac[:, 1]
    else:
        x = positions[:, plan.inplane_axis1]
        y = positions[:, plan.inplane_axis2]
    zc = positions[:, plan.slice_axis].contiguous()

    # Bucket assignment on the device, in the run precision.
    sl = torch.searchsorted(c["edges"], zc, right=True) - 1
    valid = (sl >= 0) & (sl < plan.nz)
    n_bins = plan.n_types * plan.nz
    bin_id = torch.where(valid,
                         c["type_ids"] * plan.nz + sl.clamp(0, plan.nz - 1),
                         n_bins)                        # overflow bin last
    order = torch.argsort(bin_id, stable=True)
    sx = x[order]
    sy = y[order]
    # bin n_bins counts invalid atoms, bin n_bins + 1 is always empty.
    # (index_add_ rather than bincount, which waits for the device to size
    # its output)
    counts = torch.zeros(n_bins + 2, dtype=torch.int64, device=dev)
    counts.index_add_(0, bin_id, torch.ones_like(bin_id))
    starts = torch.cumsum(counts, 0) - counts

    # Coverage guard: a frame the plan does not cover (a bucket over a_max,
    # or atoms in a (type, slice) bin the plan never saw) would drop atoms
    # silently. Poison the output with NaN instead; validate_frame() gives
    # the host-side diagnosis.
    planned_counts = counts[c["bucket_bins"]]
    planned_starts = starts[c["bucket_bins"]]
    covered = ((planned_counts.max() <= plan.a_max)
               & (planned_counts.sum() == counts[:n_bins].sum()))
    poison = torch.where(covered, 0.0, float("nan")).to(prec.real)

    ffs = c["ffs"]
    kxs = c["kxs"].to(prec.real)
    kys = c["kys"].to(prec.real)
    lane = torch.arange(plan.a_max, device=dev)
    recip = torch.zeros((plan.nz, plan.nx, plan.ny), dtype=prec.complex,
                        device=dev)
    for i, (t, s) in enumerate(c["buckets"]):
        idx = (planned_starts[i] + lane).clamp(0, n_atoms - 1)
        w = (lane < planned_counts[i]).to(prec.real)    # zero padded lanes
        px = (-2.0 * np.pi) * (sx[idx][:, None] * kxs[None, :])  # (a, nx)
        py = (-2.0 * np.pi) * (sy[idx][:, None] * kys[None, :])  # (a, ny)
        ex = torch.complex(torch.cos(px) * w[:, None], torch.sin(px) * w[:, None])
        ey = torch.complex(torch.cos(py), torch.sin(py))
        recip[s] += torch.matmul(ex.T, ey) * ffs[t]
    pot = torch.fft.ifft2(recip).real
    px_area = plan.px_area if plan.px_area is not None else plan.dx * plan.dy
    return pot * (1.0 / px_area ** 2) + poison


def validate_frame(positions, plan: RasterizerPlan) -> None:
    """Host-side check that a frame is covered by ``plan``. rasterize()
    NaN-poisons uncovered frames; this gives the actionable message."""
    pos = np.asarray(positions, dtype=np.float64)
    sl, valid = bin_atoms_np(pos[:, plan.slice_axis], plan.edges)
    bins = plan.type_ids[valid] * plan.nz + sl[valid]
    n_bins = plan.n_types * plan.nz
    counts = np.bincount(bins, minlength=n_bins)
    planned = np.zeros(n_bins, dtype=bool)
    real = plan.bucket_types >= 0
    planned[plan.bucket_types[real].astype(np.int64) * plan.nz
            + plan.bucket_slices[real].astype(np.int64)] = True
    unplanned = np.nonzero((counts > 0) & ~planned)[0]
    if unplanned.size:
        b = int(unplanned[0])
        raise ValueError(
            f"frame not covered by the rasterizer plan: {counts[b]} atom(s) "
            f"of type Z={plan.unique_z[b // plan.nz]} fall in slice "
            f"{b % plan.nz}, which held no atoms in any planning frame. "
            "Rebuild the plan including this frame "
            "(make_plan(positions_all_frames=...)) or add headroom via "
            "pad_fraction.")
    over = np.nonzero(counts > plan.a_max)[0]
    if over.size:
        b = int(over[0])
        raise ValueError(
            f"frame overflows the rasterizer plan: {counts[b]} atom(s) of "
            f"type Z={plan.unique_z[b // plan.nz]} in slice {b % plan.nz} "
            f"exceed the planned per-bucket capacity a_max={plan.a_max}. "
            "Rebuild the plan including this frame or increase pad_fraction.")


class Potential:
    """Reference-compatible facade (reference potentials.py:187-386), the
    JAX package's ``Potential``. The frame's potential is rasterized on
    ``device`` (the card unless ``device="cpu"``): ``array_szy`` is the
    slice-major (nz, nx, ny) tensor the propagation takes, ``array`` the
    reference layout (nx, ny, n_slices).
    """

    def __init__(self, xs, ys, zs, positions, atomTypes, kind: str = "kirkland",
                 device="cuda", slice_axis: int = 2, precision=None,
                 plan: RasterizerPlan = None, debye_waller=None):
        self.precision = get_precision(precision)
        self.device = torch.device(device)
        self.xs = np.asarray(xs, dtype=np.float64)
        self.ys = np.asarray(ys, dtype=np.float64)
        self.zs = np.asarray(zs, dtype=np.float64)
        self.slice_axis = slice_axis
        all_axes = [0, 1, 2]
        all_axes.remove(slice_axis)
        self.inplane_axis1, self.inplane_axis2 = all_axes
        self.slice_coords = [self.xs, self.ys, self.zs][slice_axis]
        self.n_slices = len(self.slice_coords)
        self.kxs = np.fft.fftfreq(len(self.xs), d=self.xs[1] - self.xs[0])
        self.kys = np.fft.fftfreq(len(self.ys), d=self.ys[1] - self.ys[0])
        if plan is None:
            plan = make_plan(self.xs, self.ys, self.zs, positions, atomTypes,
                             kind=kind, slice_axis=slice_axis,
                             debye_waller=debye_waller)
        elif debye_waller is not None:
            raise ValueError("pass debye_waller to make_plan when "
                             "supplying a prebuilt plan")
        self.plan = plan
        self.array_szy = rasterize(np.asarray(positions), plan,
                                   self.precision, device=self.device)

    @property
    def array(self) -> torch.Tensor:
        """(nx, ny, n_slices), the reference's layout (potentials.py:348)."""
        return self.array_szy.permute(1, 2, 0)

    def to_cpu(self) -> np.ndarray:
        return self.array.cpu().numpy()

    def plot(self):
        """Draw the projected potential (the sum of |V| over slices)."""
        plt = pyplot("Potential.plot")
        fig, ax = plt.subplots()
        arr = self.array_szy.abs().sum(dim=0).cpu().numpy().T
        extent = (self.xs.min(), self.xs.max(), self.ys.min(), self.ys.max())
        ax.imshow(arr, cmap="inferno", extent=extent)
        plt.show()
