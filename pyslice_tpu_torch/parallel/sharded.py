"""Sharded execution of the TACAW pipeline over a (frame, probe) mesh.

Counterpart of ``pyslice_tpu/parallel/sharded.py``. Propagation is
embarrassingly parallel over (frame, probe): each rank runs the whole
multislice loop for its frames x probes with no communication (the
reference's serial frame loop, calculators.py:172, becomes the mesh's frame
axis). The cross-frame dependency appears only at the TACAW time FFT: every
(probe, kx, ky) pixel needs all frames. ``tacaw_intensity_sharded`` trades
the frame shards for kx stripes with ``all_to_all_single`` on the frame
group, then transforms along the now-complete time axis locally, one probe
chunk at a time (``analysis.tacaw.time_fft_chunks``, the unsharded path's
loop), so that a rank holds its waves, the intensity and one chunk's
temporaries rather than copies of the whole block.
Reductions finish with ``all_reduce`` over the axis they sum. The wave
reductions (detector sums, frame-mean intensity) are
``analysis.detectors``' own, one code for a card and a mesh; here
``frame_total`` adds their collectives.

JAX's ``shard_map`` blocks become plain functions of the rank's local
tensor with explicit collectives on the group of one mesh axis:

    psum(x, axis)            -> all_reduce on mesh.get_group(axis)
    all_to_all(tiled=True)   -> all_to_all_single on the frame group
    _replicate_over_probe    -> all_gather_into_tensor on the probe group

Sharded arrays are ``DTensor``s (``torch.distributed.tensor``) built with
``DTensor.from_local(..., run_check=False)``; their global shape is the
JAX array's and their placements name its PartitionSpec. The functions
here read ``to_local()`` and never go through DTensor's operator dispatch.
Replicated results are plain tensors, the same on every rank.

Collectives run on contiguous real views of complex tensors, the same
calls on NCCL and on Gloo (whose all_reduce, all_gather_into_tensor and
all_to_all_single take CUDA tensors as they are).

Tracing (``utils.profiling``): each collective runs in a span of its own
(``collective.all_to_all``, ``.all_reduce``, ``.all_gather``), and the
frame -> kx trade with its time FFT in ``analysis.time_fft``. While a
profiler records, ``STATS["all_to_all_s"]`` also adds each all_to_all's
seconds between two synchronizes; an untraced run neither synchronizes
there nor counts. ``STATS["all_to_all_calls"]`` and
``["all_to_all_bytes"]`` count every exchange and the bytes this rank
hands to it, traced or not (they need no synchronize).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..engine.pipeline import SimSpec, simulate_frames_into
from ..utils.profiling import span
from .mesh import FRAME_AXIS, PROBE_AXIS, coord, extent

# Seconds in the frame -> kx all_to_alls, between two synchronizes on
# CUDA, counted only while a profiler records; the exchanges and the bytes
# this rank sent, counted always (see above).
STATS = {"all_to_all_s": 0.0, "all_to_all_calls": 0, "all_to_all_bytes": 0}


def is_sharded(x) -> bool:
    """Is ``x`` a DTensor (on a mesh of any size)?"""
    return isinstance(x, DTensor)


def local_of(x):
    """The rank's local tensor of a DTensor; anything else as it is."""
    return x.to_local() if is_sharded(x) else x


def _wrap(local: torch.Tensor, mesh, frame_dim, probe_dim: int,
          shape=None):
    """DTensor over the (frame, probe) mesh: the frame axis shards tensor
    dimension ``frame_dim`` (None: replicated over frames), the probe axis
    ``probe_dim``. ``shape``: the global shape (needed when the shards are
    uneven, as a cropped kx stripe)."""
    kw = {}
    if shape is not None:
        shape = torch.Size(shape)
        stride, acc = [], 1
        for n in reversed(shape):
            stride.insert(0, acc)
            acc *= n
        kw = {"shape": shape, "stride": tuple(stride)}
    frame = Replicate() if frame_dim is None else Shard(frame_dim)
    return DTensor.from_local(local, mesh, [frame, Shard(probe_dim)],
                              run_check=False, **kw)


# --- collectives ----------------------------------------------------------

def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``: in place where ``t`` is contiguous
    (NCCL takes no other), else in a contiguous copy; returns the sum."""
    with span("collective.all_reduce"):
        t = t.contiguous()
        dist.all_reduce(_real(t), group=group)
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The group's blocks of ``t`` concatenated along dim 0, in the order
    of the group's ranks (the mesh coordinate)."""
    with span("collective.all_gather"):
        t = t.contiguous()
        n = dist.get_world_size(group)
        out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(_real(out), _real(t), group=group)
    return out


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single``: block j of dim 0 goes to group rank j, and
    block j of the result came from group rank j."""
    with span("collective.all_to_all"):
        t = t.contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(_real(out), _real(t), group=group)
    STATS["all_to_all_calls"] += 1
    STATS["all_to_all_bytes"] += t.numel() * t.element_size()
    return out


def gather_full(x) -> torch.Tensor:
    """The global tensor of an evenly sharded DTensor on every rank (two
    all-gathers); a plain tensor as it is."""
    if not is_sharded(x):
        return x
    mesh = x.device_mesh
    out = x.to_local()
    for axis, place in zip(mesh.mesh_dim_names, x.placements):
        if place.is_replicate():
            continue
        d = place.dim
        blk = all_gather(out.movedim(d, 0), mesh.get_group(axis))
        out = blk.movedim(0, d)
    return out.contiguous()


# --- the JAX package's functions -------------------------------------------

def _check_divisible(mesh, n_frames=None, n_probes=None):
    """Clear errors for shapes that do not split evenly over the mesh."""
    if n_frames is not None:
        f = extent(mesh, FRAME_AXIS)
        if n_frames % f:
            raise ValueError(
                f"n_frames={n_frames} must be divisible by the mesh frame "
                f"extent {f}")
    if n_probes is not None:
        p = extent(mesh, PROBE_AXIS)
        if n_probes % p:
            raise ValueError(
                f"n_probes={n_probes} must be divisible by the mesh probe "
                f"extent {p}")


def block_of(n: int, mesh, axis: str) -> slice:
    """This rank's block of ``n`` items sharded over ``axis``."""
    m = n // extent(mesh, axis)
    c = coord(mesh, axis)
    return slice(c * m, (c + 1) * m)


def run_sharded(positions_frames, probes: torch.Tensor, spec: SimSpec, mesh):
    """Propagate all (frame, probe) pairs over the mesh.

    Args:
        positions_frames: (n_frames, n_atoms, 3), n_frames divisible by the
            mesh's frame extent (the same on every rank).
        probes: (n_probes, nx, ny) complex on the rank's device, n_probes
            divisible by the probe extent (the same on every rank).
        spec: the SimSpec.
        mesh: DeviceMesh with ('frame', 'probe') dimensions.

    Returns:
        (n_probes, n_frames, nx, ny, n_layers) complex DTensor, the frame
        axis sharding dim 1 and the probe axis dim 0 (JAX's
        P('probe', 'frame')). Each rank runs its frames one at a time
        through ``simulate_frames_into`` on its probe block, so the slice
        kernels run inside every rank; the kernel family follows the
        rank's probe count (``physics.propagate.fused_family``).
    """
    n_frames = int(positions_frames.shape[0])
    n_probes = int(probes.shape[0])
    _check_divisible(mesh, n_frames=n_frames, n_probes=n_probes)
    fs, ps = block_of(n_frames, mesh, FRAME_AXIS), block_of(n_probes, mesh,
                                                          PROBE_AXIS)
    pos = positions_frames[fs]
    pos = (pos if isinstance(pos, torch.Tensor)
           else torch.as_tensor(np.asarray(pos))).to(probes.device)
    probes_l = probes[ps]
    n_layers = len(spec.record_layers) if spec.record_layers else 1
    out = torch.zeros((probes_l.shape[0], pos.shape[0]) + tuple(
        probes.shape[1:]) + (n_layers,), dtype=probes.dtype,
        device=probes.device)
    simulate_frames_into(out, 0, pos, probes_l, spec)
    return _wrap(out, mesh, 1, 0,
                 shape=(n_probes, n_frames) + tuple(out.shape[2:]))


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def tacaw_intensity_sharded(wf, mesh, layer_index: int = -1,
                            crop: bool = True,
                            chunk_elems: Optional[int] = None):
    """Frame-sharded exit waves -> frequency intensity, k-sharded.

    Args:
        wf: (n_probes, n_frames, nx, ny, n_layers) DTensor from
            ``run_sharded``.
        mesh: the same mesh.
        chunk_elems: elements of a probe chunk's received block
            (``analysis.tacaw.probe_chunk``; None: the unsharded path's
            ``CHUNK_ELEMS``).

    Returns:
        (n_probes, n_freq, nx_pad, ny) real DTensor, the probe axis
        sharding dim 0 and the frame axis dim 2 (JAX's P('probe', None,
        'frame')): the all_to_all trades frame locality for kx locality so
        the time FFT is local. kx is zero-padded to a multiple of the frame
        extent (odd grids, int(l/s)+1); ``crop`` drops the pad, leaving
        stripes of torch.chunk's uneven sizes. Keep crop=False for further
        sharded reductions: the pad rows are exact zeros.

    The rank's probes go through ``analysis.tacaw.time_fft_chunks`` in
    chunks of ``probe_chunk`` probes, one all_to_all each: this function
    hands it a chunk padded, exchanged and laid out (probes, time, stripe,
    ky), so no temporary is larger than a chunk's block.
    """
    from ..analysis.tacaw import probe_chunk, time_fft_chunks
    n_layers = wf.shape[-1]
    layer_index = layer_index % n_layers
    _check_divisible(mesh, n_frames=wf.shape[1], n_probes=wf.shape[0])
    nx = wf.shape[2]
    f_ext = extent(mesh, FRAME_AXIS)
    pad = (-nx) % f_ext
    stripe = (nx + pad) // f_ext
    group = mesh.get_group(FRAME_AXIS)
    with span("analysis.time_fft") as traced:
        x = local_of(wf)[..., layer_index]        # (p_loc, f_loc, nx, ny)
        p_loc, f_loc, _, ny = x.shape
        n_t = f_ext * f_loc

        def exchanged(lo: int, hi: int) -> torch.Tensor:
            blk = x[lo:hi]
            if pad:
                blk = torch.nn.functional.pad(blk, (0, 0, 0, pad))
            # kx stripes to dim 0; block j goes to frame rank j, and block
            # j of the result holds frame rank j's frames of this stripe.
            send = blk.reshape(hi - lo, f_loc, f_ext, stripe, ny)
            send = send.permute(2, 0, 1, 3, 4)
            if traced is not None:
                _sync(x)
                t0 = time.perf_counter()
            recv = all_to_all(send, group)
            if traced is not None:
                _sync(recv)
                STATS["all_to_all_s"] += time.perf_counter() - t0
            return recv.transpose(0, 1).reshape(hi - lo, n_t, stripe, ny)

        out = time_fft_chunks(p_loc, probe_chunk(n_t * stripe * ny,
                                                 chunk_elems), exchanged)
        out = _wrap(out, mesh, 2, 0,
                    shape=(wf.shape[0], wf.shape[1], nx + pad, ny))
    return crop_kx(out, mesh, nx) if pad and crop else out


def crop_kx(intensity, mesh, nx: int):
    """A k-sharded intensity with its kx pad dropped: each rank keeps its
    stripe's rows below ``nx``, torch.chunk's uneven shard sizes."""
    p, f, nx_pad, ny = intensity.shape
    stripe = nx_pad // extent(mesh, FRAME_AXIS)
    keep = max(0, min(stripe, nx - coord(mesh, FRAME_AXIS) * stripe))
    return _wrap(local_of(intensity)[:, :, :keep], mesh, 2, 0,
                 shape=(p, f, nx, ny))


def _check_stripes(intensity, mesh) -> int:
    f_ext = extent(mesh, FRAME_AXIS)
    if intensity.shape[2] % f_ext:
        raise ValueError(
            f"kx extent {intensity.shape[2]} must be divisible by the mesh "
            f"frame extent {f_ext} (use "
            f"tacaw_intensity_sharded(crop=False) output)")
    return intensity.shape[2] // f_ext


def tacaw_spectrum_sharded(intensity, mesh) -> torch.Tensor:
    """Probe-averaged spectrum (n_freq,), replicated: the mean over probes
    of the k-space sum of ``tacaw_intensity_sharded(crop=False)``."""
    _check_divisible(mesh, n_probes=intensity.shape[0])
    _check_stripes(intensity, mesh)
    local = local_of(intensity)
    full_k = all_reduce(local.sum(dim=(2, 3)), mesh.get_group(FRAME_AXIS))
    probe_sum = all_reduce(full_k.sum(dim=0), mesh.get_group(PROBE_AXIS))
    return probe_sum / intensity.shape[0]


def sharded_mesh_of(x):
    """The ('frame', 'probe') mesh a DTensor is sharded over, or None for a
    plain tensor, an array, a mesh of size 1 or a mesh without both axes.
    ``frame_total`` adds the collectives when it is not None."""
    if not is_sharded(x):
        return None
    m = x.device_mesh
    names = set(m.mesh_dim_names or ())
    if m.size() > 1 and {FRAME_AXIS, PROBE_AXIS} <= names:
        return m
    return None


def _replicate_over_probe(s_local: torch.Tensor, mesh) -> torch.Tensor:
    """(p_loc, ...) probe-sharded values -> (n_probes, ...) replicated: one
    all-gather on the probe group."""
    return all_gather(s_local, mesh.get_group(PROBE_AXIS))


def frame_total(s_local: torch.Tensor, wf) -> torch.Tensor:
    """A (p_loc, ...) sum over this rank's frames of the exit-wave stack
    ``wf`` -> the sum over all its frames, (n_probes, ...) on every rank:
    an all_reduce on the frame group, then an all-gather on the probe
    group. Off a mesh (``sharded_mesh_of(wf)`` None) ``s_local`` is that
    sum already and is returned as it is."""
    mesh = sharded_mesh_of(wf)
    if mesh is None:
        return s_local
    _check_divisible(mesh, n_frames=wf.shape[1], n_probes=wf.shape[0])
    s = all_reduce(s_local, mesh.get_group(FRAME_AXIS))
    return _replicate_over_probe(s, mesh)


def collected_sharded(wf, mesh, masks, layer_index: int = -1,
                      intensity: bool = False) -> torch.Tensor:
    """``analysis.detectors.detector_sums`` of a sharded exit-wave stack
    on its mesh ``mesh``: (n_probes, n_masks) mean-over-frames masked k
    sums, replicated."""
    from ..analysis.detectors import detector_sums
    return detector_sums(wf, masks, intensity=intensity,
                         layer_index=layer_index)


def frame_mean_intensity_sharded(wf, mesh,
                                 layer_index: int = -1) -> torch.Tensor:
    """``analysis.detectors.frame_mean_intensity`` of a sharded exit-wave
    stack on its mesh ``mesh``: (n_probes, nx, ny), replicated."""
    from ..analysis.detectors import frame_mean_intensity
    return frame_mean_intensity(wf, layer_index=layer_index)


def _local_stripe(full_plane: torch.Tensor, stripe: int,
                  mesh) -> torch.Tensor:
    """This rank's kx stripe of a replicated (nx_pad, ...) plane (the frame
    axis's shard of the k-sharded intensity)."""
    start = coord(mesh, FRAME_AXIS) * stripe
    return full_plane[start:start + stripe]


def _plane(a, local: torch.Tensor) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else \
        torch.as_tensor(np.asarray(a, np.float64))
    return t.to(device=local.device, dtype=local.dtype)


def tacaw_probe_spectra_sharded(intensity, mesh, mask=None) -> torch.Tensor:
    """Per-probe spectra (n_probes, n_freq), replicated, from
    ``tacaw_intensity_sharded(crop=False)``; ``mask`` an optional (nx_pad,
    ny) detector mask, zero-padded to nx_pad. The core of
    TACAWData.spectrum / spectrum_image / masked_spectrum."""
    _check_divisible(mesh, n_probes=intensity.shape[0])
    f_ext = extent(mesh, FRAME_AXIS)
    if intensity.shape[2] % f_ext:
        raise ValueError(f"kx extent {intensity.shape[2]} not divisible by "
                         f"the mesh frame extent {f_ext} (pass the "
                         "crop=False intensity)")
    stripe = intensity.shape[2] // f_ext
    x = local_of(intensity)
    if mask is not None:
        x = x * _local_stripe(_plane(mask, x), stripe, mesh)[None, None]
    s = all_reduce(x.sum(dim=(2, 3)), mesh.get_group(FRAME_AXIS))
    return _replicate_over_probe(s, mesh)


def _probe_block(weights, local: torch.Tensor, mesh) -> torch.Tensor:
    w = _plane(weights, local)
    p_loc = local.shape[0]
    c = coord(mesh, PROBE_AXIS)
    return w[c * p_loc:(c + 1) * p_loc]


def tacaw_kplane_sharded(intensity, mesh, probe_weights,
                         freq_index=None) -> torch.Tensor:
    """Probe-weighted k plane (nx_pad, ny), replicated (crop the pad rows
    after). ``probe_weights``: (n_probes,), 1/n_probes for the probe
    average or a one-hot for one probe; ``freq_index``: None sums over
    frequency (TACAWData.diffraction), an int picks one
    (spectral_diffraction)."""
    _check_divisible(mesh, n_probes=intensity.shape[0])
    local = local_of(intensity)
    x = local.sum(dim=1) if freq_index is None else local[:, freq_index]
    s = torch.einsum("pxy,p->xy", x, _probe_block(probe_weights, local,
                                                  mesh))
    s = all_reduce(s, mesh.get_group(PROBE_AXIS))
    # the kx stripes in frame-rank order: one all-gather on the frame group
    return all_gather(s, mesh.get_group(FRAME_AXIS))


def tacaw_dispersion_sharded(intensity, mesh, probe_weights, kx_idx,
                             ky_idx) -> torch.Tensor:
    """Probe-weighted dispersion (n_freq, n_k) along a k path, replicated.
    The nearest-pixel lookup across the sharded kx axis runs as two
    one-hot contractions (each rank contracts its stripe's rows of the
    selection matrix; nothing is gathered across shards)."""
    _check_divisible(mesh, n_probes=intensity.shape[0])
    stripe = _check_stripes(intensity, mesh)
    nx_pad, ny = intensity.shape[2], intensity.shape[3]
    n_k = len(kx_idx)
    sx = np.zeros((nx_pad, n_k))
    sx[np.asarray(kx_idx), np.arange(n_k)] = 1.0
    sy = np.zeros((ny, n_k))
    sy[np.asarray(ky_idx), np.arange(n_k)] = 1.0
    local = local_of(intensity)
    t = torch.einsum("pfxy,yj->pfxj", local, _plane(sy, local))
    picked = torch.einsum("pfxj,xj->pfj", t,
                          _local_stripe(_plane(sx, local), stripe, mesh))
    picked = all_reduce(picked, mesh.get_group(FRAME_AXIS))
    out = torch.einsum("pfj,p->fj", picked,
                       _probe_block(probe_weights, local, mesh))
    return all_reduce(out, mesh.get_group(PROBE_AXIS))
