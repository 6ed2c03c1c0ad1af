"""Experimental 4D-STEM ingest (HDF5 / EMD datacubes).

Counterpart of ``pyslice_tpu/io/data4d.py``. The analysis and inverse
families (``analysis.ptychography``, ``analysis.calibration``,
``engine.inverse``) consume ``(npos, nkx, nky)`` detector intensities plus
``(npos, 2)`` scan coordinates: what this module extracts from measured
datacubes, so measured data drops into the same tools the simulation
pipeline feeds.

Supported: any HDF5 file holding a 4-D dataset (scan_y, scan_x, k_y, k_x —
the datacube convention EMD 1.0 / Berkeley / py4DSTEM files use).
``dataset`` selects the HDF5 path explicitly; auto-discovery prefers groups
tagged with the EMD 1.0 ``emd_group_type == 1`` attribute and falls back to
the first 4-D dataset in the file. Reads go one scan row at a time, each
cropped and binned row straight into a tensor preallocated on ``device``,
so no whole-cube host array is ever made. ``h5py`` is imported only by the
functions that read or write a file.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _discover_dataset(f):
    """First EMD-tagged 4-D dataset, else the first 4-D dataset."""
    import h5py

    emd_hit, any_hit = [], []

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset) and obj.ndim == 4:
            parent = obj.parent
            if int(parent.attrs.get("emd_group_type", 0)) == 1:
                emd_hit.append(name)
            any_hit.append(name)

    f.visititems(visit)
    if emd_hit:
        return emd_hit[0]
    if any_hit:
        return any_hit[0]
    raise ValueError(
        f"{f.filename}: no 4-D dataset found (pass dataset='/path/to/data')")


def scan_positions(scan_shape: Tuple[int, int], step: float,
                   step_y: Optional[float] = None) -> np.ndarray:
    """(n_sx * n_sy, 2) scan coordinates in Angstrom for a raster scan of
    ``scan_shape = (n_sx, n_sy)`` with pitch ``step`` (x) / ``step_y``
    (defaults to ``step``) — first scan axis slow, second axis fast,
    matching ``load_4dstem``'s flattened position axis."""
    n_sx, n_sy = int(scan_shape[0]), int(scan_shape[1])
    sy = float(step if step_y is None else step_y)
    return np.array([(i * float(step), j * sy)
                     for i in range(n_sx) for j in range(n_sy)])


def load_4dstem(path, dataset: Optional[str] = None,
                scan_step: Optional[float] = None,
                crop_k: Optional[int] = None,
                bin_k: int = 1,
                dtype: torch.dtype = torch.float64,
                device="cuda") -> dict:
    """Load a 4-D STEM datacube from an HDF5/EMD file onto ``device``.

    Args:
        path: the .h5/.emd file.
        dataset: explicit HDF5 dataset path (default: auto-discover; EMD
            1.0 ``emd_group_type == 1`` groups win).
        scan_step: optional scan pitch in Angstrom — when given, the
            result carries ready-made ``positions`` for the
            reconstruction tools.
        crop_k: optional centered crop of the detector axes to
            (crop_k, crop_k) BEFORE binning.
        bin_k: integer detector binning factor (sums counts in float64,
            preserving Poisson statistics).
        dtype: the torch dtype of the returned tensor.
        device: where the cube is assembled, one scan row at a time.

    Returns dict with ``data`` ((npos, nkx, nky) tensor on ``device`` —
    scan flattened row-major, first scan axis slow), ``scan_shape``
    ((n_sx, n_sy)), ``positions`` ((npos, 2) Angstrom array, only when
    ``scan_step`` given), and ``dataset`` (the HDF5 path read). The
    detector layout is passed through unchanged — callers treating it as
    the fftshifted WFData convention should verify the central beam sits
    at the array center (``center_datacube``).
    """
    import h5py

    if bin_k < 1:
        raise ValueError(f"bin_k must be >= 1, got {bin_k}")
    with h5py.File(path, "r") as f:
        name = dataset or _discover_dataset(f)
        try:
            dset = f[name]
        except KeyError:
            raise ValueError(f"{path}: no dataset {name!r}") from None
        if dset.ndim != 4:
            raise ValueError(f"{path}:{name} is {dset.ndim}-D, expected a "
                             "4-D datacube (scan_y, scan_x, k_y, k_x)")
        n_sx, n_sy, nkx, nky = dset.shape
        if crop_k is not None:
            if not 0 < crop_k <= min(nkx, nky):
                raise ValueError(f"crop_k {crop_k} outside the "
                                 f"({nkx}, {nky}) detector")
            x0, y0 = (nkx - crop_k) // 2, (nky - crop_k) // 2
            kx_sl = slice(x0, x0 + crop_k)
            ky_sl = slice(y0, y0 + crop_k)
            nkx = nky = crop_k
        else:
            kx_sl = ky_sl = slice(None)
        if nkx % bin_k or nky % bin_k:
            raise ValueError(f"bin_k {bin_k} does not divide the "
                             f"({nkx}, {nky}) detector (crop_k first)")
        out = torch.empty((n_sx * n_sy, nkx // bin_k, nky // bin_k),
                          dtype=dtype, device=device)
        # one scan row per read: bounded host memory for out-of-core cubes
        for i in range(n_sx):
            row = torch.as_tensor(np.asarray(dset[i, :, kx_sl, ky_sl]),
                                  device=device).to(torch.float64)
            if bin_k > 1:
                row = row.reshape(n_sy, nkx // bin_k, bin_k,
                                  nky // bin_k, bin_k).sum(dim=(2, 4))
            out[i * n_sy:(i + 1) * n_sy] = row
    result = dict(data=out, scan_shape=(n_sx, n_sy), dataset=name)
    if scan_step is not None:
        result["positions"] = scan_positions((n_sx, n_sy), scan_step)
    return result


def center_datacube(data, return_shift: bool = False, device="cuda"):
    """Roll every pattern so the unscattered beam sits at the array
    center — the first preprocessing step for measured data (descan error
    and detector mounting offset the zero beam; the reconstruction tools
    assume the fftshifted layout with DC at (nkx//2, nky//2)).

    The shift is ONE integer (dx, dy) offset from the center of mass of
    the MEAN pattern (per-pattern shifts would absorb the DPC signal the
    iCoM/SSB tools measure), rounded half to even as Python's ``round``.
    A tensor stays on its device; an array goes to ``device``. Returns the
    rolled copy; with ``return_shift`` also the (dx, dy) applied.
    """
    if not isinstance(data, torch.Tensor):
        data = torch.as_tensor(np.asarray(data), device=device)
    mean = data.reshape(-1, *data.shape[-2:]).mean(dim=0,
                                                   dtype=torch.float64)
    total = float(mean.sum())
    if total <= 0:
        raise ValueError("cannot center an empty datacube")
    gx = torch.arange(mean.shape[0], dtype=torch.float64, device=mean.device)
    gy = torch.arange(mean.shape[1], dtype=torch.float64, device=mean.device)
    cx = float((mean.sum(dim=1) * gx).sum()) / total
    cy = float((mean.sum(dim=0) * gy).sum()) / total
    dx = mean.shape[0] // 2 - int(round(cx))
    dy = mean.shape[1] // 2 - int(round(cy))
    rolled = torch.roll(data, (dx, dy), dims=(-2, -1))
    return (rolled, (dx, dy)) if return_shift else rolled


def k_sampling_from_disk(pattern, mrad: float, eV: float,
                         threshold: float = 0.5) -> float:
    """Detector k-sampling (1/Angstrom per pixel) calibrated from the
    bright-field disk: the disk's radius in PIXELS corresponds to the
    known aperture half-angle, r_pix * dk = mrad*1e-3 / lambda. The disk
    is segmented at ``threshold`` of the pattern's max (robust for a
    centered, far-field CBED of a thin region); pass the MEAN pattern of
    a centered datacube (an array, or a tensor on any device).
    """
    from ..core.constants import wavelength

    pat = torch.as_tensor(pattern).to(torch.float64)
    area = float((pat >= threshold * pat.max()).sum())
    if area < 4:
        raise ValueError("bright-field disk not found (threshold too "
                         "high, or the pattern is not a CBED)")
    r_pix = np.sqrt(area / np.pi)
    k_ap = (mrad * 1e-3) / wavelength(eV)
    return float(k_ap / r_pix)


def save_4dstem(path, data, scan_shape: Optional[Tuple[int, int]] = None,
                dataset: str = "4dstem/datacube",
                dtype=np.float32) -> None:
    """Write a datacube (a tensor on any device, or an array) as an EMD
    1.0 HDF5 file, one scan row at a time (round-trips through
    ``load_4dstem``; py4DSTEM/HyperSpy readers accept the layout).

    ``data``: (n_sx, n_sy, nkx, nky), or flattened (npos, nkx, nky) with
    ``scan_shape`` supplied. The dataset group is tagged with the EMD
    ``emd_group_type = 1`` attribute so auto-discovery prefers it.
    """
    import h5py

    if not isinstance(data, torch.Tensor):
        data = torch.as_tensor(np.asarray(data))
    if data.ndim == 3:
        if scan_shape is None:
            raise ValueError("flattened (npos, nkx, nky) data needs "
                             "scan_shape=(n_sx, n_sy)")
        n_sx, n_sy = int(scan_shape[0]), int(scan_shape[1])
        if n_sx * n_sy != data.shape[0]:
            raise ValueError(f"scan_shape {scan_shape} does not match "
                             f"{data.shape[0]} positions")
        data = data.reshape(n_sx, n_sy, *data.shape[-2:])
    elif data.ndim != 4:
        raise ValueError(f"data must be 3-D or 4-D, got {data.ndim}-D")

    group_name, _, dset_name = dataset.rpartition("/")
    with h5py.File(path, "w") as f:
        f.attrs["version_major"] = 0
        f.attrs["version_minor"] = 2
        g = f.require_group(group_name or "/")
        g.attrs["emd_group_type"] = 1
        dset = g.create_dataset(dset_name or "datacube",
                                shape=tuple(data.shape), dtype=dtype,
                                chunks=(1, *data.shape[1:]))
        for i in range(data.shape[0]):
            dset[i] = data[i].cpu().numpy().astype(dtype)
        for i, nm in enumerate(["dim1", "dim2", "dim3", "dim4"]):
            d = g.create_dataset(nm, data=np.arange(data.shape[i]))
            d.attrs["name"] = np.bytes_(
                ["scan_x", "scan_y", "k_x", "k_y"][i])
