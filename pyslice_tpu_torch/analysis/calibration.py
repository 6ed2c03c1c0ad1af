"""Measured-data calibration for 4D-STEM datacubes, on the card.

Counterpart of ``pyslice_tpu/analysis/calibration.py`` (the same fifteen
functions, the same solves and report lines; see its module docstring for
the physics). Measured data carries instrument artifacts that must be
solved from the data itself before the reconstruction tools
(``analysis.ptychography``, ``engine.inverse``) can be trusted on it: the
scan <-> detector rotation and transpose, linear descan, hot and dead
pixels behind a dark frame and a gain map, the dose, an elliptic detector
distortion and an affine scan distortion. ``calibrate_datacube`` chains
them with a report.

Here every per-pattern step is one vectorised pass over the whole cube on
the cube's device, never a Python loop over patterns: the descan's integer
roll is a gather along each detector axis with indices
``(arange - shift) mod n`` and its Fourier shift one batched FFT; the
elliptic and the affine resampling are bilinear gathers whose four
neighbour indices and weights are computed once (every pattern, or every
detector pixel, shares the coordinates);
``fix_pixels`` loops over the few bad pixels only, each one operation on
all patterns.

Dtypes: a cube keeps its dtype (float32 or float64) through the pattern
operations; every statistic is float64 whatever the cube's dtype — the
per-pixel scan mean and variance of ``find_bad_pixels`` (a float32 mean
turns a stuck pixel at a count such as 50.3 into rounding noise), the CoM
moments of ``com_field``, the least squares of ``fit_descan`` and the
moments and eigen-decomposition of ``fit_bf_disk_ellipse``.

Where SciPy/NumPy's rule is kept by hand:

* ``median_filter(size=3, mode="nearest")``: a replicate pad, a 3 x 3
  ``unfold`` and the median of the 9 values;
* every median over an even count (the MAD of ``find_bad_pixels``, the
  peak-disc median of ``fit_affine_scan``, the neighbour median of
  ``fix_pixels``) averages the two middle values, as ``np.median`` does
  (``torch.median`` returns the lower one);
* ``map_coordinates(order=1, mode="nearest")``: bilinear weights from
  coordinates clamped into the field, which is what SciPy's edge
  replication gives past the last sample;
* integer shifts round half to even, as Python's ``round``.

Inputs: a tensor stays on its device; an array goes to ``device``.
Returned arrays are tensors on that device; scalars are Python floats.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "com_field", "solve_rotation", "apply_rotation",
    "fit_descan", "apply_descan",
    "fit_bf_disk_ellipse", "apply_elliptic_correction", "correct_com_ellipse",
    "fit_affine_scan", "apply_affine_scan",
    "find_bad_pixels", "fix_pixels", "apply_dark_gain",
    "estimate_dose", "calibrate_datacube",
]

F64 = torch.float64


def _tensor(x, device, dtype=None) -> torch.Tensor:
    """A tensor stays on its device; anything else goes to ``device``.
    Integer data becomes float64 (the JAX package's working dtype)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x), device=device)
    if dtype is not None:
        return x.to(dtype)
    return x if x.is_floating_point() else x.to(F64)


def _on(x, device, dtype=F64) -> torch.Tensor:
    """An auxiliary input (an axis, a dark frame, a fitted matrix) as a
    ``dtype`` tensor on ``device``, the device of the data it acts on."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _median(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """np.median along ``dim``: the mean of the two middle values of an
    even count."""
    s = x.sort(dim=dim).values
    n = s.shape[dim]
    hi = s.narrow(dim, n // 2, 1).squeeze(dim)
    if n % 2:
        return hi
    return (s.narrow(dim, n // 2 - 1, 1).squeeze(dim) + hi) / 2


def _median3(img: torch.Tensor) -> torch.Tensor:
    """scipy.ndimage.median_filter(img, size=3, mode="nearest") of a 2-D
    tensor: a replicate pad, a 3 x 3 unfold, the median of 9."""
    nx, ny = img.shape
    padded = F.pad(img[None, None], (1, 1, 1, 1), mode="replicate")
    cols = F.unfold(padded, kernel_size=3)[0]            # (9, nx*ny)
    return cols.median(dim=0).values.reshape(nx, ny)


def _bilinear(coords: torch.Tensor, shape):
    """The four neighbour flat indices and float64 weights of
    map_coordinates(order=1, mode="nearest") at ``coords`` (2, M) into a
    field of ``shape`` (nx, ny): the coordinates are clamped into the
    field first, which is SciPy's edge replication."""
    nx, ny = shape
    x = coords[0].clamp(0, nx - 1)
    y = coords[1].clamp(0, ny - 1)
    x0, y0 = x.floor(), y.floor()
    wx, wy = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(max=nx - 1), (y0 + 1).clamp(max=ny - 1)
    idx = [x0 * ny + y0, x0 * ny + y1, x1 * ny + y0, x1 * ny + y1]
    w = [(1 - wx) * (1 - wy), (1 - wx) * wy, wx * (1 - wy), wx * wy]
    return idx, w


def _resample(flat: torch.Tensor, idx, w, dim: int) -> torch.Tensor:
    """sum_k w[k] * flat.index_select(dim, idx[k]): one gather per
    neighbour over the whole tensor, weights in the tensor's dtype."""
    shape = [1] * flat.ndim
    shape[dim] = -1
    out = None
    for i, wk in zip(idx, w):
        wk = wk.to(flat.dtype).reshape(shape)
        term = flat.index_select(dim, i)
        out = term.mul_(wk) if out is None else out.addcmul_(term, wk)
    return out


def com_field(data4d, kxs=None, kys=None, device="cuda") -> torch.Tensor:
    """(2, n_sx, n_sy) float64 center-of-mass field of a scan-grid
    datacube (n_sx, n_sy, nkx, nky), the moments summed in float64.

    With ``kxs``/``kys`` (fftshifted detector axes, 1/Angstrom) the
    moments are physical; without, they are in PIXELS relative to the
    array center.
    """
    data = _tensor(data4d, device)
    dev = data.device
    nkx, nky = data.shape[-2:]
    kx = (_on(kxs, dev) if kxs is not None
          else torch.arange(nkx, dtype=F64, device=dev) - nkx // 2)
    ky = (_on(kys, dev) if kys is not None
          else torch.arange(nky, dtype=F64, device=dev) - nky // 2)
    d = data.to(F64)
    total = d.sum(dim=(-2, -1))
    mx = d.sum(dim=-1) @ kx
    my = d.sum(dim=-2) @ ky
    del d
    pos = total > 0
    safe = torch.where(pos, total, torch.ones_like(total))
    zero = torch.zeros_like(total)
    return torch.stack([torch.where(pos, mx / safe, zero),
                        torch.where(pos, my / safe, zero)])


def _curl_div_parts(com, dx, dy):
    """Central-difference gradient components of a (2, nx, ny) field
    (np.gradient's rule: first order at the edges)."""
    gxx, gxy = torch.gradient(com[0], spacing=(float(dx), float(dy)),
                              edge_order=1)
    gyx, gyy = torch.gradient(com[1], spacing=(float(dx), float(dy)),
                              edge_order=1)
    return gxx, gxy, gyx, gyy


def _integrate_field(com, dx, dy) -> torch.Tensor:
    """Fourier integration of a (2, nx, ny) vector field into the scalar
    field it is (approximately) the gradient of (DC set to 0)."""
    n_sx, n_sy = com.shape[1:]
    dev = com.device
    qx = torch.fft.fftfreq(n_sx, d=dx, dtype=F64, device=dev)[:, None]
    qy = torch.fft.fftfreq(n_sy, d=dy, dtype=F64, device=dev)[None, :]
    q2 = qx ** 2 + qy ** 2
    q2[0, 0] = 1.0
    mx, my = torch.fft.fft2(com[0]), torch.fft.fft2(com[1])
    h_hat = (qx * mx + qy * my) / (2j * math.pi * q2)
    h_hat[0, 0] = 0.0
    return torch.fft.ifft2(h_hat).real


def _swap(com: torch.Tensor) -> torch.Tensor:
    return torch.stack([com[1], com[0]])


def solve_rotation(com, dx: float = 1.0, dy: float = 1.0,
                   assume_attractive: bool = True, device="cuda") -> dict:
    """Solve the scan<->detector rotation (and transpose) from the CoM
    field's conservativeness, in closed form (see the JAX package's
    docstring). The theta / theta+pi branch is chosen so the Fourier-
    integrated scalar field has NEGATIVE skewness
    (``assume_attractive=True``); False gives the raw curl-minimizing
    branch in [0, pi).

    Returns dict with ``theta`` (radians), ``transpose`` (bool),
    ``curl_rms`` (at the optimum, over the gradient RMS),
    ``curl_rms_raw``, ``skewness`` (None without the prior) and
    ``candidates`` (all four (theta, transpose, curl_rms)).
    """
    com = _tensor(com, device, F64)
    results = []
    for transpose in (False, True):
        m = _swap(com) if transpose else com
        gxx, gxy, gyx, gyy = _curl_div_parts(m, dx, dy)
        c = gyx - gxy                       # curl of the raw field
        d = gxx + gyy                       # divergence
        a, b, cc = (float((c * c).mean()), float((c * d).mean()),
                    float((d * d).mean()))
        # f(theta) = (a+cc)/2 + (a-cc)/2 cos 2theta + b sin 2theta
        th0 = 0.5 * math.atan2(2 * b, a - cc)
        for th in (th0, th0 + math.pi / 2):
            rms2 = ((a + cc) / 2 + (a - cc) / 2 * math.cos(2 * th)
                    + b * math.sin(2 * th))
            results.append((float(th % math.pi), transpose,
                            float(max(rms2, 0.0))))
    results.sort(key=lambda r: r[2])
    theta, transpose, rms2 = results[0]

    m = _swap(com) if transpose else com
    parts = _curl_div_parts(m, dx, dy)
    grad_rms = float(torch.stack(parts).square().mean().sqrt())
    gxx, gxy, gyx, gyy = parts
    raw_curl_rms = float((gyx - gxy).square().mean().sqrt()) \
        / (grad_rms + 1e-30)

    if assume_attractive:
        best = apply_rotation(com, theta, transpose)
        h = _integrate_field(best, dx, dy)
        hc = h - h.mean()
        skew = float((hc ** 3).mean()) \
            / (float(hc.abs().pow(3).mean()) + 1e-300)
        # psi = -h must be negative-skewed (the attractive-potential sign
        # in the measured convention); |skew| << 1 leaves the branch
        # undetermined by the data.
        if skew > 0:
            theta = float((theta + math.pi) % (2 * math.pi))
    else:
        skew = None

    return dict(theta=theta, transpose=transpose, skewness=skew,
                curl_rms=float(math.sqrt(rms2) / (grad_rms + 1e-30)),
                curl_rms_raw=raw_curl_rms,
                candidates=[dict(theta=t, transpose=tr,
                                 curl_rms=float(math.sqrt(r)
                                                / (grad_rms + 1e-30)))
                            for t, tr, r in results])


def apply_rotation(com, theta: float, transpose: bool = False,
                   device="cuda") -> torch.Tensor:
    """Rotate (and optionally de-transpose) a CoM field into scan
    coordinates: the inverse of the instrument's mounting transform, as
    solved by ``solve_rotation``."""
    com = _tensor(com, device, F64)
    if transpose:
        com = _swap(com)
    ct, st = math.cos(theta), math.sin(theta)
    return torch.stack([ct * com[0] - st * com[1],
                        st * com[0] + ct * com[1]])


def _scan_design(scan_xs, scan_ys, device) -> torch.Tensor:
    """(n_sx * n_sy, 3) least-squares design [1, sx, sy], row-major."""
    sx, sy = _on(scan_xs, device), _on(scan_ys, device)
    gx, gy = torch.meshgrid(sx, sy, indexing="ij")
    return torch.stack([torch.ones_like(gx).ravel(), gx.ravel(),
                        gy.ravel()], dim=1)


def fit_descan(com, scan_xs, scan_ys, device="cuda") -> dict:
    """Least-squares linear-in-scan drift of the CoM field (float64).

    Fits ``com[i](sx, sy) ~ c0 + cx*sx + cy*sy`` per component and
    returns ``coeffs`` ((2, 3): [offset, d/dsx, d/dsy] for comx and comy),
    ``corrected`` (the field with ONLY the fitted linear part removed) and
    ``drift_rms`` (how much was removed).
    """
    com = _tensor(com, device, F64)
    A = _scan_design(scan_xs, scan_ys, com.device)
    rhs = com.reshape(2, -1).T                           # (N, 2)
    sol = torch.linalg.lstsq(A, rhs).solution            # (3, 2)
    coeffs = sol.T.contiguous()
    drift = (A @ sol).T.reshape(com.shape)
    corrected = com - drift
    return dict(coeffs=coeffs, corrected=corrected,
                drift_rms=float(drift.square().mean().sqrt()))


def _drift_pixels(coeffs, scan_xs, scan_ys, k_per_pixel, device):
    """(shift_x, shift_y): minus the fitted drift at every scan position,
    in detector pixels, float64 (n_sx, n_sy)."""
    c = _tensor(coeffs, device, F64)
    sx, sy = _on(scan_xs, c.device), _on(scan_ys, c.device)
    gx, gy = torch.meshgrid(sx, sy, indexing="ij")
    kpp = np.broadcast_to(np.asarray(k_per_pixel, np.float64), (2,))
    shift_x = -(c[0, 0] + c[0, 1] * gx + c[0, 2] * gy) / float(kpp[0])
    shift_y = -(c[1, 0] + c[1, 1] * gx + c[1, 2] * gy) / float(kpp[1])
    return shift_x, shift_y


def apply_descan(data4d, coeffs, scan_xs, scan_ys, k_per_pixel,
                 subpixel: bool = True, device="cuda") -> torch.Tensor:
    """Shift every pattern by MINUS the fitted linear descan drift.

    ``coeffs``: the (2, 3) fit from ``fit_descan`` in the same k units as
    the CoM field it was fitted on; ``k_per_pixel`` converts them to
    detector pixels (a scalar, or a (kx, ky) pair). ``subpixel=True``
    shifts the whole cube through one batched Fourier phase ramp (the
    ramp's phases in float64), clipped at 0; False rolls every pattern by
    its nearest integer shift (half to even): a gather along each detector
    axis with indices ``(arange - shift) mod n``.
    """
    data = _tensor(data4d, device)
    n_sx, n_sy, nkx, nky = data.shape
    shift_x, shift_y = _drift_pixels(coeffs, scan_xs, scan_ys, k_per_pixel,
                                     data.device)
    dev = data.device
    if subpixel:
        ctype = torch.complex128 if data.dtype == F64 else torch.complex64
        fx = torch.fft.fftfreq(nkx, dtype=F64, device=dev)
        fy = torch.fft.fftfreq(nky, dtype=F64, device=dev)
        ax = -2 * math.pi * shift_x[..., None] * fx
        ay = -2 * math.pi * shift_y[..., None] * fy
        ex = torch.polar(torch.ones_like(ax), ax).to(ctype)
        ey = torch.polar(torch.ones_like(ay), ay).to(ctype)
        spec = torch.fft.fft2(data)
        spec.mul_(ex[..., :, None]).mul_(ey[..., None, :])
        out = torch.fft.ifft2(spec).real
        del spec
        return out.clamp(min=0.0)
    # np.roll per pattern: out[..., i, j] = data[..., (i - sx) % nkx,
    # (j - sy) % nky], as a gather along each detector axis whose index is
    # a broadcast view (a (patterns, n) table), never a cube of indices
    shape = data.shape
    ix = torch.round(shift_x).long()[..., None]
    iy = torch.round(shift_y).long()[..., None]
    rows = torch.remainder(torch.arange(nkx, device=dev) - ix, nkx)
    cols = torch.remainder(torch.arange(nky, device=dev) - iy, nky)
    out = data.gather(2, rows[..., :, None].expand(shape))
    return out.gather(3, cols[..., None, :].expand(shape))


def fit_bf_disk_ellipse(pattern, threshold: float = 0.5,
                        device="cuda") -> dict:
    """Elliptic distortion of the bright-field disk from one (typically
    scan-mean) diffraction pattern, by second moments (the py4DSTEM-
    standard elliptic calibration; see the JAX package's docstring).

    The 3 x 3 median smoothing, the moments and the correction are tensor
    operations on the pattern's device. The segmentation's connected
    component (``scipy.ndimage.label``, 4-connected) and its 3-step
    dilation (``binary_dilation``) act on the one (nkx, nky) boolean mask
    with SciPy on the host: one small array, one copy each way. The 2 x 2
    eigen-decomposition is float64 on the host.

    Returns dict with ``center`` (pixels, tensor), ``semi_axes`` (a >= b,
    pixels), ``angle`` (radians mod pi, major axis vs +x),
    ``ellipticity`` (a/b >= 1), ``correction`` (the area-preserving
    symmetric 2x2 float64 tensor C with C @ (k - center) circular) and
    ``n_pixels``.
    """
    from scipy.ndimage import binary_dilation, label

    p = _tensor(pattern, device, F64)
    dev = p.device
    smooth = _median3(p)
    smax = float(smooth.max())
    if not smax > 0:
        raise ValueError(
            "bright-field disk segmentation found fewer than 9 pixels — "
            "the pattern has no positive intensity")
    mask = (smooth >= threshold * smax).cpu().numpy()
    # keep only the component containing the brightest pixel (stray Bragg
    # spots above threshold must not skew the moments)
    lab, _ = label(mask)
    peak = np.unravel_index(int(smooth.argmax()), smooth.shape)
    mask = lab == lab[peak]
    n_pixels = int(mask.sum())
    if n_pixels < 9:
        raise ValueError(
            "bright-field disk segmentation found fewer than 9 pixels — "
            f"threshold {threshold} is likely wrong for this pattern")
    # intensity-weighted moments over the disk + its soft edge
    soft = torch.as_tensor(binary_dilation(mask, iterations=3), device=dev)
    w = torch.where(soft, smooth, torch.zeros_like(smooth))
    gx, gy = torch.meshgrid(torch.arange(p.shape[0], dtype=F64, device=dev),
                            torch.arange(p.shape[1], dtype=F64, device=dev),
                            indexing="ij")
    wsum = w.sum()
    center = torch.stack([(gx * w).sum(), (gy * w).sum()]) / wsum
    dxc, dyc = gx - center[0], gy - center[1]
    cov = (torch.stack([(dxc * dxc * w).sum(), (dxc * dyc * w).sum(),
                        (dyc * dyc * w).sum()]) / wsum).cpu().numpy()
    cov = np.array([[cov[0], cov[1]], [cov[1], cov[2]]])
    evals, evecs = np.linalg.eigh(cov)       # ascending
    ratio = float(np.sqrt(evals[1] / evals[0]))     # a/b
    r0 = float(np.sqrt(n_pixels / np.pi))           # sqrt(a*b)
    a = r0 * np.sqrt(ratio)
    b = r0 / np.sqrt(ratio)
    major = evecs[:, 1]
    # the eigenvector's sign is free: the angle is taken mod pi
    angle = float(np.arctan2(major[1], major[0]) % np.pi)
    R = np.array([[np.cos(angle), -np.sin(angle)],
                  [np.sin(angle), np.cos(angle)]])
    C = R @ np.diag([r0 / a, r0 / b]) @ R.T
    return dict(center=center, semi_axes=(float(a), float(b)),
                angle=angle, ellipticity=float(a / b),
                correction=torch.as_tensor(C, device=dev),
                n_pixels=n_pixels)


def apply_elliptic_correction(data4d, ellipse: dict, order: int = 1,
                              device="cuda") -> torch.Tensor:
    """Resample every pattern so the fitted ellipse becomes a circle:
    P'(k) = P(Cinv @ (k - c) + c) with C = ``ellipse['correction']``,
    bilinear with SciPy's nearest-edge rule (``order=1``, the only order
    ported). One gather per neighbour over the whole cube."""
    if order != 1:
        raise ValueError(f"order {order}: only bilinear (order=1) resampling "
                         "is ported")
    data = _tensor(data4d, device)
    shape = data.shape
    nkx, nky = shape[-2:]
    dev = data.device
    c = _on(ellipse["center"], dev)
    Cinv = torch.linalg.inv(_on(ellipse["correction"], dev))
    gx, gy = torch.meshgrid(torch.arange(nkx, dtype=F64, device=dev),
                            torch.arange(nky, dtype=F64, device=dev),
                            indexing="ij")
    out_k = torch.stack([gx.ravel() - c[0], gy.ravel() - c[1]])
    src = Cinv @ out_k + c[:, None]
    idx, w = _bilinear(src, (nkx, nky))
    flat = data.reshape(-1, nkx * nky)
    return _resample(flat, idx, w, dim=1).reshape(shape)


def correct_com_ellipse(com, ellipse: dict, device="cuda") -> torch.Tensor:
    """Exact (algebraic) elliptic correction of a CoM field: com' = C @ com
    (first moments transform linearly under the area-preserving change of
    detector coordinates k -> C k)."""
    com = _tensor(com, device, F64)
    C = _on(ellipse["correction"], com.device)
    return torch.einsum("ij,j...->i...", C, com)


def fit_affine_scan(image, scan_xs, scan_ys, g_expected,
                    search_frac: float = 0.2, device="cuda") -> dict:
    """Affine scan distortion from a known lattice (see the JAX package's
    docstring): the measured Fourier peaks of a lattice image sit at
    g_m = A^T @ g, so two measured/expected pairs give A exactly.

    Returns dict with ``A`` (2x2 float64 tensor; ``apply_affine_scan``
    resamples with its inverse), ``g_measured`` ((2, 2) tensor),
    ``peak_snr`` (per peak: peak power over the median power of its
    search disc, np.median's rule) and ``determinant``.
    """
    img = _tensor(image, device, F64)
    dev = img.device
    sx = np.asarray(scan_xs, np.float64)
    sy = np.asarray(scan_ys, np.float64)
    dx = float(sx[1] - sx[0])
    dy = float(sy[1] - sy[0])
    n0, n1 = img.shape
    # Hann window (np.hanning): the scan field is not periodic, and the
    # window's smooth ~2-bin peaks make the 3x3 power centroid an accurate
    # sub-bin estimator.
    wx = torch.hann_window(n0, periodic=False, dtype=F64, device=dev)
    wy = torch.hann_window(n1, periodic=False, dtype=F64, device=dev)
    Fp = torch.fft.fft2((img - img.mean()) * wx[:, None] * wy[None, :]) \
        .abs() ** 2
    qx = np.fft.fftfreq(n0, d=dx)
    qy = np.fft.fftfreq(n1, d=dy)
    qxt = torch.as_tensor(qx, device=dev)
    qyt = torch.as_tensor(qy, device=dev)

    g_exp = np.asarray(g_expected, np.float64).reshape(2, 2)
    g_meas = np.empty((2, 2))
    snrs = []
    steps = torch.arange(-1, 2, device=dev)
    for i, g in enumerate(g_exp):
        r = search_frac * float(np.linalg.norm(g))
        near = ((qxt[:, None] - g[0]) ** 2
                + (qyt[None, :] - g[1]) ** 2) <= r * r
        if not bool(near.any()):
            raise ValueError(
                f"expected peak {g} has no Fourier samples within "
                f"{search_frac:.0%} of |g| — scan field of view too small "
                "or wrong lattice vectors")
        Fm = torch.where(near, Fp, torch.zeros_like(Fp))
        px, py = np.unravel_index(int(Fm.argmax()), Fp.shape)
        snrs.append(float(Fp[px, py] / (_median(Fp[near]) + 1e-300)))
        # subpixel: power-weighted centroid over the 3x3 neighbourhood
        # (wrapping at the FFT edges)
        ix = (int(px) + steps) % n0
        iy = (int(py) + steps) % n1
        w = Fp[ix[:, None], iy[None, :]]
        wsum = float(w.sum())
        cx = float((w.sum(dim=1) * steps).sum()) / wsum
        cy = float((w.sum(dim=0) * steps).sum()) / wsum
        g_meas[i] = (qx[px] + cx * (qx[1] - qx[0]),
                     qy[py] + cy * (qy[1] - qy[0]))

    A = (g_meas.T @ np.linalg.inv(g_exp.T)).T
    return dict(A=torch.as_tensor(A, device=dev),
                g_measured=torch.as_tensor(g_meas, device=dev),
                peak_snr=snrs, determinant=float(np.linalg.det(A)))


def apply_affine_scan(data, A, scan_xs, scan_ys, order: int = 1,
                      device="cuda") -> torch.Tensor:
    """Resample the scan axes to undo a fitted affine distortion:
    out(r) = in(A^-1 @ r) relative to the scan origin, on a (n_sx, n_sy)
    image or a (n_sx, n_sy, nkx, nky) datacube (patterns move rigidly;
    out-of-field samples clamp to the edge). Bilinear (``order=1``, the
    only order ported): one gather per neighbour over the whole cube,
    every detector pixel sharing the four indices and weights."""
    if order != 1:
        raise ValueError(f"order {order}: only bilinear (order=1) resampling "
                         "is ported")
    arr = _tensor(data, device)
    dev = arr.device
    n_sx, n_sy = arr.shape[:2]
    sx = np.asarray(scan_xs, np.float64)
    sy = np.asarray(scan_ys, np.float64)
    dx = float(sx[1] - sx[0])
    dy = float(sy[1] - sy[0])
    Ainv = torch.linalg.inv(_on(A, dev))
    gx, gy = torch.meshgrid(torch.arange(n_sx, dtype=F64, device=dev) * dx,
                            torch.arange(n_sy, dtype=F64, device=dev) * dy,
                            indexing="ij")
    src = Ainv @ torch.stack([gx.ravel(), gy.ravel()])
    idx, w = _bilinear(torch.stack([src[0] / dx, src[1] / dy]), (n_sx, n_sy))
    flat = arr.reshape(n_sx * n_sy, -1)
    return _resample(flat, idx, w, dim=0).reshape(arr.shape)


def find_bad_pixels(data4d, n_sigma: float = 8.0,
                    device="cuda") -> torch.Tensor:
    """(nkx, nky) bool mask of hot/dead detector pixels.

    Statistics across ALL scan positions, in float64 whatever the cube's
    dtype. A pixel is flagged when its scan-variation is below 1e-6
    relative AND its scan-mean deviates from the 3x3 local median of the
    mean pattern by more than ``n_sigma`` robust (MAD) sigmas, or when it
    never varies at all while its neighbourhood does (see the JAX
    package's docstring for why a defect is what does not follow the
    scan).
    """
    stuck_tol = 1e-6
    data = _tensor(data4d, device)
    d = data.reshape(-1, *data.shape[-2:]).to(F64)
    var, mean = torch.var_mean(d, dim=0, correction=0)
    del d
    local = _median3(mean)
    resid = mean - local
    mad = _median((resid - _median(resid.ravel())).abs().ravel())
    sigma = 1.4826 * mad + 1e-12
    suspicious = resid.abs() > n_sigma * sigma
    stuck_ish = var.sqrt() <= stuck_tol * (mean.abs() + 1e-12)
    local_var = _median3(var)
    return (suspicious & stuck_ish & (local_var > 0)) \
        | ((var == 0) & (local_var > 0))


def fix_pixels(data4d, bad_mask, device="cuda") -> torch.Tensor:
    """Replace bad pixels with the per-pattern median (np.median's rule)
    of their good 3x3 neighbours (edge pixels use their in-bounds
    neighbours): one operation on all patterns for each bad pixel."""
    data = _tensor(data4d, device)
    shape = data.shape
    flat = data.reshape(-1, *shape[-2:]).clone()
    bad = torch.as_tensor(bad_mask).cpu().numpy().astype(bool)
    nkx, nky = bad.shape
    for x, y in zip(*np.nonzero(bad)):
        xs = np.arange(max(x - 1, 0), min(x + 2, nkx))
        ys = np.arange(max(y - 1, 0), min(y + 2, nky))
        gx, gy = np.meshgrid(xs, ys, indexing="ij")
        good = ~bad[gx, gy]
        if good.any():
            idx = torch.as_tensor((gx * nky + gy)[good], device=flat.device)
            nb = flat.reshape(flat.shape[0], -1).index_select(1, idx)
        else:     # isolated in a bad cluster: global median
            nb = flat.reshape(flat.shape[0], -1)
        flat[:, x, y] = _median(nb, dim=1)
    return flat.reshape(shape)


def apply_dark_gain(data4d, dark=None, gain=None,
                    device="cuda") -> torch.Tensor:
    """Counts -> electrons: (data - dark) / gain per detector pixel,
    clipped at 0, in the cube's dtype. ``gain`` pixels <= 0 are treated as
    dead (output 0); flag them via ``find_bad_pixels``/``fix_pixels``
    afterwards."""
    data = _tensor(data4d, device)
    out = data
    if dark is not None:
        out = out - _on(dark, data.device, data.dtype)
    if gain is not None:
        g = _on(gain, data.device, data.dtype)
        live = g > 0
        out = torch.where(live, out / torch.where(live, g, 1.0),
                          torch.zeros((), dtype=out.dtype,
                                      device=out.device))
    return out.clamp(min=0.0)


def estimate_dose(data4d, scan_step: float,
                  scan_step_y: Optional[float] = None,
                  device="cuda") -> dict:
    """Dose statistics assuming calibrated electron counts: ``dose``
    (mean electrons per Angstrom^2), ``electrons_per_position`` (scan-
    shaped float64 tensor) and ``total``."""
    data = _tensor(data4d, device)
    per_pos = data.sum(dim=(-2, -1), dtype=F64)
    area = float(scan_step) * float(scan_step_y if scan_step_y is not None
                                    else scan_step)
    return dict(dose=float(per_pos.mean()) / area,
                electrons_per_position=per_pos,
                total=float(per_pos.sum()))


def calibrate_datacube(data4d, scan_xs, scan_ys, dark=None, gain=None,
                       n_sigma: float = 8.0, k_per_pixel=1.0,
                       kxs=None, kys=None,
                       assume_attractive: bool = True,
                       subpixel_descan: bool = False,
                       fit_ellipse: bool = True,
                       apply_ellipse: bool = False,
                       g_expected=None,
                       apply_affine: bool = False,
                       device="cuda") -> dict:
    """One-shot calibration chain for a measured scan-grid datacube:

        dark/gain -> bad pixels -> beam centering -> elliptic-distortion
        fit [-> correction] -> descan fit+removal -> rotation/transpose
        solve [-> affine scan-distortion fit/correction]

    The arguments and the returned dict are the JAX package's (see its
    docstring): ``data`` (the calibrated cube, the input's dtype, on its
    device), ``com`` (the calibrated float64 CoM field in scan
    coordinates — feed it to ``icom_reconstruct(com=...)``),
    ``rotation``, ``transpose``, ``rotation_diag``, ``bad_pixels``,
    ``beam_center_shift``, ``descan``, ``ellipse``, ``affine``, ``dose``
    and ``report`` (one line per step, the JAX package's strings).
    """
    from ..io.data4d import center_datacube

    report = []
    data = _tensor(data4d, device)
    if dark is not None or gain is not None:
        data = apply_dark_gain(data, dark, gain)
        report.append("dark/gain applied")
    bad = find_bad_pixels(data, n_sigma=n_sigma)
    n_bad = int(bad.sum())
    if n_bad:
        data = fix_pixels(data, bad)
    report.append(f"bad pixels fixed: {n_bad}")

    data, (cdx, cdy) = center_datacube(data, return_shift=True)
    report.append(f"beam centered: rolled ({cdx}, {cdy}) px")

    ellipse = None
    data_pre_ellipse = None
    if fit_ellipse:
        try:
            ellipse = fit_bf_disk_ellipse(
                data.mean(dim=(0, 1), dtype=F64))
            report.append(
                f"BF disk ellipticity {ellipse['ellipticity']:.4f} "
                f"(major axis {np.degrees(ellipse['angle']):.1f} deg)"
                + (", corrected" if apply_ellipse else ""))
            if apply_ellipse:
                data_pre_ellipse = data        # exact CoM source
                data = apply_elliptic_correction(data, ellipse)
        except ValueError as e:
            report.append(f"ellipse fit skipped: {e}")

    # CoM from the pre-resampling cube (interpolation-free); the elliptic
    # correction is then applied to it algebraically (exact), conjugated
    # into physical k units when the detector pixels are anisotropic.
    com_src = data if data_pre_ellipse is None else data_pre_ellipse
    if kxs is not None and kys is not None:
        com = com_field(com_src, kxs, kys)
        kpp = np.array([float(np.asarray(kxs)[1] - np.asarray(kxs)[0]),
                        float(np.asarray(kys)[1] - np.asarray(kys)[0])])
    else:
        kpp = np.array(np.broadcast_to(
            np.asarray(k_per_pixel, np.float64), (2,)))
        com = com_field(com_src) * torch.as_tensor(
            kpp, device=data.device)[:, None, None]
    del com_src, data_pre_ellipse
    if ellipse is not None and apply_ellipse:
        S = np.diag(kpp)
        C_phys = torch.as_tensor(S, device=data.device) @ \
            ellipse["correction"] @ \
            torch.as_tensor(np.linalg.inv(S), device=data.device)
        com = torch.einsum("ij,j...->i...", C_phys, com)
    descan = fit_descan(com, scan_xs, scan_ys)
    data = apply_descan(data, descan["coeffs"], scan_xs, scan_ys,
                        kpp, subpixel=subpixel_descan)
    com = descan["corrected"]
    report.append(f"descan removed: drift RMS {descan['drift_rms']:.3g}")

    dx = float(scan_xs[1] - scan_xs[0]) if len(scan_xs) > 1 else 1.0
    dy = float(scan_ys[1] - scan_ys[0]) if len(scan_ys) > 1 else 1.0
    rot = solve_rotation(com, dx, dy, assume_attractive=assume_attractive)
    com = apply_rotation(com, rot["theta"], rot["transpose"])
    report.append(
        f"rotation {np.degrees(rot['theta']):.2f} deg, transpose "
        f"{rot['transpose']} (curl RMS {rot['curl_rms_raw']:.3g} -> "
        f"{rot['curl_rms']:.3g})")

    affine = None
    if g_expected is not None:
        try:
            affine = fit_affine_scan(
                data.sum(dim=(-2, -1), dtype=F64), scan_xs, scan_ys,
                g_expected)
            off = float((affine["A"] - torch.eye(
                2, dtype=F64, device=affine["A"].device)).abs().max())
            report.append(
                f"affine scan distortion: max|A - I| = {off:.3g}, "
                f"det {affine['determinant']:.4f}"
                + (", corrected" if apply_affine else ""))
            if apply_affine:
                data = apply_affine_scan(data, affine["A"],
                                         scan_xs, scan_ys)
                com = torch.stack([
                    apply_affine_scan(com[0], affine["A"],
                                      scan_xs, scan_ys),
                    apply_affine_scan(com[1], affine["A"],
                                      scan_xs, scan_ys)])
        except ValueError as e:
            report.append(f"affine scan fit skipped: {e}")

    dose = estimate_dose(data, dx, dy)
    report.append(f"dose ~ {dose['dose']:.3g} e/A^2")
    return dict(data=data, com=com, rotation=rot["theta"],
                transpose=rot["transpose"], rotation_diag=rot,
                bad_pixels=bad, beam_center_shift=(cdx, cdy),
                descan=descan, ellipse=ellipse, affine=affine,
                dose=dose, report=report)
