"""Port parity for the streaming engines (engine/streaming.py):
StreamingTACAW and StreamingHAADF of pyslice_tpu_torch against
pyslice_tpu's on the same hBN thermal frames (float64 to 1e-10, one
complex64 case per engine to the 1e-6 residual), the single-device tests
of tests/test_streaming.py mirrored on the port, and the port's own pins:
block feeding and resume bit-identical, one rasterization a frame, mesh=
raising."""

import json

import numpy as np
import pytest
import torch

from pyslice_tpu.core.dtypes import DOUBLE as J_DOUBLE, SINGLE as J_SINGLE
from pyslice_tpu.core.grids import grid_from_trajectory as j_grid
from pyslice_tpu.engine.pipeline import SimSpec as JSpec
from pyslice_tpu.engine.streaming import (StreamingHAADF as JHAADF,
                                          StreamingTACAW as JTACAW)
from pyslice_tpu.physics.potential import make_plan as j_make_plan
from pyslice_tpu.physics.probe import (Probe as JProbe,
                                       create_batched_probes as j_batch)

import pyslice_tpu_torch as tt
from pyslice_tpu_torch import interop
from pyslice_tpu_torch.engine import streaming as ts
from pyslice_tpu_torch.engine.pipeline import SimSpec as TSpec

from fixtures import hbn_thermal
from oracle import residual

torch.set_num_threads(2)

SAMPLING = 0.25
SLICE_T = 0.8
EV = 100e3


def _port_traj(j):
    return tt.Trajectory(atom_types=j.atom_types, positions=j.positions,
                         velocities=j.velocities, box_matrix=j.box_matrix,
                         timestep=j.timestep)


class Pair:
    """One problem in both packages: the JAX spec and the port's (carrying
    the JAX plan), and probe batches built by each package."""

    def __init__(self, jtraj, precision):
        self.jtraj = jtraj
        self.traj = _port_traj(jtraj)
        self.positions = jtraj.positions
        self.n_frames = jtraj.n_frames
        self.timestep = jtraj.timestep
        jprec = J_DOUBLE if precision == "double" else J_SINGLE
        g = j_grid(jtraj, sampling=SAMPLING, slice_thickness=SLICE_T)
        plan = j_make_plan(g.xs, g.ys, g.zs, jtraj.positions,
                           jtraj.atom_types)
        self.jg, self.jspec = g, JSpec.create(g, plan, EV, precision=jprec)
        tg = tt.grid_from_trajectory(self.traj, sampling=SAMPLING,
                                     slice_thickness=SLICE_T)
        fields = {k: getattr(plan, k) for k in plan.__dataclass_fields__}
        self.tg = tg
        self.tspec = interop.spec_with_plan(
            TSpec.create(tg, tt.make_plan(tg.xs, tg.ys, tg.zs,
                                          self.traj.positions,
                                          self.traj.atom_types),
                         EV, precision=precision), fields)
        self.precision = precision
        self.lx, self.ly = g.lx, g.ly

    def probes(self, mrad, positions):
        jprec = self.jspec.precision
        jp = j_batch(JProbe(self.jg.xs, self.jg.ys, mrad, EV,
                            precision=jprec), positions).array
        tp = tt.create_batched_probes(
            tt.Probe(self.tg.xs, self.tg.ys, mrad, EV,
                     precision=self.precision, device="cpu"),
            positions).array
        return jp, tp


@pytest.fixture(scope="module")
def pair():
    return Pair(hbn_thermal(n_frames=6, sigma=0.05, seed=11), "double")


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tacaw_both(pair, mrad, positions, order=None, **kw):
    jp, tp = pair.probes(mrad, positions)
    js = JTACAW(pair.jspec, jp, pair.n_frames, pair.timestep, **kw)
    ts_ = tt.StreamingTACAW(pair.tspec, tp, pair.n_frames, pair.timestep,
                            **kw)
    for f in (order or range(pair.n_frames)):
        js.add_frame(f, pair.positions[f])
        ts_.add_frame(f, pair.positions[f])
    return ts_, js


def test_streaming_tacaw_matches_jax_and_batch(pair):
    """Out-of-order frames at three bins (f=0 included) against the JAX
    stream and the port's batch path (TACAWData.spectral_diffraction)."""
    calc = tt.MultisliceCalculator(device="cpu", precision="double")
    calc.setup(pair.traj, aperture=0, voltage_eV=EV, sampling=SAMPLING,
               slice_thickness=SLICE_T, use_cache=False)
    tac = tt.TACAWData(calc.run(progress=False))
    targets = [float(tac.frequencies[1]), float(tac.frequencies[4]), 0.0]
    st, js = _tacaw_both(pair, 0, [(pair.lx / 2, pair.ly / 2)],
                         order=[3, 0, 5, 1, 4, 2], frequencies=targets)
    got, want = _np(st.intensity()), _np(js.intensity())
    assert got.shape == want.shape == (3, 1, pair.tg.nx, pair.tg.ny)
    assert _rel(got, want) <= 1e-10
    for i, f_thz in enumerate(targets):
        np.testing.assert_allclose(
            got[i, 0], tac.spectral_diffraction(f_thz, probe_index=0),
            rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(st.spectrum(probe_index=0),
                               np.asarray(js.spectrum(probe_index=0)),
                               rtol=1e-10)
    np.testing.assert_allclose(st.spectrum(), np.asarray(js.spectrum()),
                               rtol=1e-10)
    np.testing.assert_array_equal(st.bins, js.bins)
    np.testing.assert_array_equal(st.frequencies, js.frequencies)


def test_streaming_tacaw_incomplete_raises(pair):
    _, tp = pair.probes(0, [(1.0, 1.0)])
    st = tt.StreamingTACAW(pair.tspec, tp, pair.n_frames, pair.timestep,
                           frequencies=[0.0])
    st.add_frame(0, pair.positions[0])
    with pytest.raises(ValueError, match="streamed 1 of"):
        st.intensity()


def _haadf_both(pair, mrad, pg, n_frames, chunk=None, **kw):
    jp, tp = pair.probes(mrad, pg)
    js = JHAADF(pair.jspec, jp, pg, probe_chunk=chunk, **kw)
    st = tt.StreamingHAADF(pair.tspec, tp, pg, probe_chunk=chunk, **kw)
    for f in range(n_frames):
        js.add_frame(pair.positions[f])
        st.add_frame(pair.positions[f])
    return st, js


def test_streaming_haadf_matches_jax_and_batch(pair):
    pg = tt.probe_grid([1, 3], [1, 3], 3, 3)
    st, js = _haadf_both(pair, 30, pg, 3, collection_angle=45)
    got = st.image()
    assert got.shape == (3, 3) and st.n_streamed == 3
    assert _rel(got, js.image()) <= 1e-10
    calc = tt.MultisliceCalculator(device="cpu", precision="double")
    calc.setup(pair.traj.slice_timesteps([0, 1, 2]), aperture=30,
               voltage_eV=EV, sampling=SAMPLING, slice_thickness=SLICE_T,
               probe_positions=pg, use_cache=False)
    want = tt.HAADFData(calc.run(progress=False)).calculateADF(45)
    np.testing.assert_allclose(got, want, rtol=1e-9)


@pytest.mark.parametrize("intensity", [False, True])
def test_streaming_haadf_intensity_and_chunks_match_jax(pair, intensity):
    """Amplitude (quirk 11) and |psi|^2 detectors, probe-chunked."""
    pg = tt.probe_grid([1, 3], [1, 3], 3, 3)
    st, js = _haadf_both(pair, 30, pg, 2, chunk=4, collection_angle=45,
                         intensity=intensity)
    assert _rel(st.image(), js.image()) <= 1e-10


def test_streaming_probe_chunks_and_no_zero_bin(pair):
    """Chunked accumulation and the dropped mean tracker match JAX."""
    pg = tt.probe_grid([1, 3], [1, 3], 2, 2)
    st, js = _tacaw_both(pair, 0, pg, frequencies=[33.0, -66.0],
                         probe_chunk=3)
    assert not st._track_mean
    assert [s.stop - s.start for s in st._chunk_slices] == [3, 1]
    got = _np(st.intensity())
    assert got.shape[1] == 4
    assert _rel(got, _np(js.intensity())) <= 1e-10


def _stream(pair, probes, **kw):
    return tt.StreamingTACAW(pair.tspec, probes, pair.n_frames,
                             pair.timestep, **kw)


def test_streaming_checkpoint_resume(pair, tmp_path):
    """Kill and resume (probe chunks, mean tracked): bit-identical to the
    uninterrupted stream; out of order, equal to the last bits' noise."""
    _, tp = pair.probes(0, tt.probe_grid([1, 3], [1, 3], 2, 2))
    kw = dict(frequencies=[20.0, 0.0], probe_chunk=3)
    st0 = _stream(pair, tp, **kw)
    for f in range(pair.n_frames):
        st0.add_frame(f, pair.positions[f])
    want = _np(st0.intensity())

    st1 = _stream(pair, tp, **kw)
    for f in (0, 1, 2):
        st1.add_frame(f, pair.positions[f])
    st1.save_checkpoint(tmp_path / "c")
    st2 = _stream(pair, tp, **kw)
    seen = st2.restore(tmp_path / "c")
    assert seen == {0, 1, 2}
    for f in range(pair.n_frames):
        if f not in seen:
            st2.add_frame(f, pair.positions[f])
    np.testing.assert_array_equal(_np(st2.intensity()), want)

    st3 = _stream(pair, tp, **kw)
    for f in (5, 2, 0):
        st3.add_frame(f, pair.positions[f])
    st3.save_checkpoint(tmp_path / "c2")
    st4 = _stream(pair, tp, **kw)
    st4.restore(tmp_path / "c2")
    for f in (4, 1, 3):
        st4.add_frame(f, pair.positions[f])
    np.testing.assert_allclose(_np(st4.intensity()), want, rtol=1e-12,
                               atol=1e-14)
    # another configuration is refused
    with pytest.raises(ValueError, match="mismatch"):
        _stream(pair, tp, frequencies=[10.0, 0.0],
                probe_chunk=3).restore(tmp_path / "c")


def test_streaming_checkpoint_layout(pair, tmp_path):
    """One file per accumulator and the manifest written last: without
    its manifest a checkpoint does not restore."""
    _, tp = pair.probes(0, tt.probe_grid([1, 3], [1, 3], 2, 2))
    st = _stream(pair, tp, frequencies=[20.0, 0.0], probe_chunk=3)
    for f in (0, 1):
        st.add_frame(f, pair.positions[f])
    d = tmp_path / "k"
    st.save_checkpoint(d)
    names = sorted(p.name for p in d.iterdir())
    assert names == ["acc_0.npy", "acc_1.npy", "manifest.json",
                     "mean_0.npy", "mean_1.npy"]
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest == {"key": st.checkpoint_key(), "seen": [0, 1],
                        "n_frames": pair.n_frames}
    (d / "manifest.json").unlink()
    with pytest.raises(FileNotFoundError):
        _stream(pair, tp, frequencies=[20.0, 0.0],
                probe_chunk=3).restore(d)


def test_streaming_duplicate_frame_rejected(pair):
    _, tp = pair.probes(0, [(1.0, 1.0)])
    st = _stream(pair, tp, frequencies=[20.0])
    st.add_frame(0, pair.positions[0])
    with pytest.raises(ValueError, match="already streamed"):
        st.add_frame(0, pair.positions[0])


def test_streaming_haadf_checkpoint_resume(pair, tmp_path):
    """StreamingHAADF kill and resume: bit-identical; a mismatch raises."""
    pg = tt.probe_grid([1, 3], [1, 3], 2, 2)
    _, tp = pair.probes(30, pg)

    def new_stream():
        return tt.StreamingHAADF(pair.tspec, tp, pg, collection_angle=45)

    st0 = new_stream()
    for f in range(pair.n_frames):
        st0.add_frame(pair.positions[f], frame_index=f)
    want = st0.image()
    st1 = new_stream()
    for f in (0, 1, 2):
        st1.add_frame(pair.positions[f], frame_index=f)
    st1.save_checkpoint(tmp_path / "h")
    st2 = new_stream()
    seen = st2.restore(tmp_path / "h")
    assert seen == {0, 1, 2} and st2.n_streamed == 3
    for f in range(pair.n_frames):
        if f not in seen:
            st2.add_frame(pair.positions[f], frame_index=f)
    np.testing.assert_array_equal(st2.image(), want)
    st3 = tt.StreamingHAADF(pair.tspec, tp, pg, collection_angle=60)
    with pytest.raises(ValueError, match="mismatch"):
        st3.restore(tmp_path / "h")


def test_duplicate_haadf_frame_index_rejected(pair):
    _, tp = pair.probes(30, [(1.0, 1.0)])
    st = tt.StreamingHAADF(pair.tspec, tp, [(1.0, 1.0)])
    st.add_frame(pair.positions[0], frame_index=0)
    with pytest.raises(ValueError, match="more than once"):
        st.add_frame(pair.positions[1], frame_index=0)


def test_streaming_haadf_probe_chunking(pair):
    """probe_chunk bounds the working set without changing the image."""
    pg = tt.probe_grid([1, 3], [1, 3], 3, 3)
    _, tp = pair.probes(30, pg)
    imgs = {}
    for chunk in (None, 4):
        st = tt.StreamingHAADF(pair.tspec, tp, pg, collection_angle=45,
                               probe_chunk=chunk)
        for f in range(2):
            st.add_frame(pair.positions[f])
        imgs[chunk] = st.image()
    np.testing.assert_allclose(imgs[4], imgs[None], rtol=1e-12)


def _feed_tacaw(pair, probes, block, **kw):
    st = _stream(pair, probes, **kw)
    if block is None:
        for f in range(pair.n_frames):
            st.add_frame(f, pair.positions[f])
    else:
        for i0 in range(0, pair.n_frames, block):
            idx = list(range(i0, min(i0 + block, pair.n_frames)))
            st.add_frame_block(idx, pair.positions[np.asarray(idx)])
    return _np(st.intensity())


@pytest.mark.parametrize("chunk", [None, 3])
def test_streaming_tacaw_block_feed_matches_per_frame(pair, chunk):
    """add_frame_block equals per-frame feeding bit for bit (ragged last
    block, f=0 mean correction, probe chunks), and equals JAX's."""
    pg = tt.probe_grid([1, 3], [1, 3], 2, 2)
    jp, tp = pair.probes(0, pg)
    kw = dict(frequencies=[0.0, 33.0], probe_chunk=chunk)
    ref = _feed_tacaw(pair, tp, None, **kw)
    np.testing.assert_array_equal(_feed_tacaw(pair, tp, 4, **kw), ref)
    np.testing.assert_array_equal(_feed_tacaw(pair, tp, 6, **kw), ref)
    js = JTACAW(pair.jspec, jp, pair.n_frames, pair.timestep, **kw)
    for i0 in range(0, pair.n_frames, 4):
        idx = list(range(i0, min(i0 + 4, pair.n_frames)))
        js.add_frame_block(idx, pair.positions[np.asarray(idx)])
    assert _rel(ref, _np(js.intensity())) <= 1e-10
    # duplicates are caught through the block path, before any state moves
    st = _stream(pair, tp, **kw)
    st.add_frame_block([0, 1, 2], pair.positions[:3])
    before = [a.clone() for a in st._acc_chunks]
    with pytest.raises(ValueError, match="more than once"):
        st.add_frame_block([3, 2], pair.positions[2:4])
    with pytest.raises(ValueError, match="more than once"):
        st.add_frame_block([4, 4], pair.positions[3:5])
    assert st._seen == {0, 1, 2}
    for a, b in zip(st._acc_chunks, before):
        assert torch.equal(a, b)


def _feed_haadf(pair, probes, pg, block, chunk=None):
    st = tt.StreamingHAADF(pair.tspec, probes, pg, collection_angle=45,
                           eV=EV, probe_chunk=chunk)
    if block is None:
        for f in range(pair.n_frames):
            st.add_frame(pair.positions[f], f)
    else:
        for i0 in range(0, pair.n_frames, block):
            idx = list(range(i0, min(i0 + block, pair.n_frames)))
            st.add_frame_block(pair.positions[np.asarray(idx)], idx)
    return st.image()


@pytest.mark.parametrize("chunk", [None, 3])
def test_streaming_haadf_block_feed_matches_per_frame(pair, chunk):
    pg = tt.probe_grid([1.0, pair.lx - 1.0], [1.0, pair.ly - 1.0], 2, 2)
    _, tp = pair.probes(25, pg)
    ref = _feed_haadf(pair, tp, pg, None, chunk)
    np.testing.assert_array_equal(_feed_haadf(pair, tp, pg, 4, chunk), ref)
    np.testing.assert_array_equal(_feed_haadf(pair, tp, pg, 6, chunk), ref)


def test_streaming_block_feed_with_probe_chunks(pair):
    """Blocks x probe chunks against the port's batch analysis: TACAW
    (ragged 3 + 1 chunks, mean tracked) and HAADF (9 probes, chunks of 4)."""
    pg = tt.probe_grid([1, 3], [1, 3], 2, 2)
    calc = tt.MultisliceCalculator(device="cpu", precision="double")
    calc.setup(pair.traj, aperture=0, voltage_eV=EV, sampling=SAMPLING,
               slice_thickness=SLICE_T, probe_positions=pg, use_cache=False)
    tac = tt.TACAWData(calc.run(progress=False))
    _, tp = pair.probes(0, pg)
    inten = _feed_tacaw(pair, tp, 4, frequencies=[20.0, 0.0], probe_chunk=3)
    for i, f_thz in enumerate([20.0, 0.0]):
        for p in range(4):
            np.testing.assert_allclose(
                inten[i, p], tac.spectral_diffraction(f_thz, probe_index=p),
                rtol=1e-8, atol=1e-12)
    pg9 = tt.probe_grid([1, 3], [1, 3], 3, 3)
    _, tp9 = pair.probes(30, pg9)
    np.testing.assert_allclose(_feed_haadf(pair, tp9, pg9, 4, 4),
                               _feed_haadf(pair, tp9, pg9, None, None),
                               rtol=1e-12)


def test_streaming_chunk_layouts_agree(pair):
    """Every probe-chunk layout gives the same intensity (the port's
    counterpart of the JAX package's chunk-group sizes, which are TPU
    machinery and not ported)."""
    _, tp = pair.probes(0, tt.probe_grid([1, 3], [1, 3], 2, 2))
    ref = _feed_tacaw(pair, tp, 3, frequencies=[20.0])
    for chunk in (1, 2, 3):
        np.testing.assert_allclose(
            _feed_tacaw(pair, tp, 3, frequencies=[20.0], probe_chunk=chunk),
            ref, rtol=1e-12)


def test_streaming_haadf_block_duplicate_is_atomic(pair):
    """A duplicate anywhere in a block rejects the whole block before any
    state moves; its other indices can be fed afterwards."""
    pg = tt.probe_grid([1.0, pair.lx - 1.0], [1.0, pair.ly - 1.0], 2, 2)
    _, tp = pair.probes(25, pg)
    st = tt.StreamingHAADF(pair.tspec, tp, pg, collection_angle=45, eV=EV)
    st.add_frame_block(pair.positions[:3], [0, 1, 2])
    with pytest.raises(ValueError, match="more than once"):
        st.add_frame_block(pair.positions[2:5], [4, 5, 2])
    st.add_frame_block(pair.positions[3:6], [3, 4, 5])
    assert st.n_streamed == 6 and np.all(np.isfinite(st.image()))
    with pytest.raises(ValueError, match="entries"):
        st.add_frame_block(pair.positions[:3], [7, 8])


def test_streaming_one_rasterization_per_frame(pair, monkeypatch):
    """Every probe chunk of a frame reuses the frame's one potential, in
    both engines and through ragged blocks."""
    calls = []
    real = ts.rasterize

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(ts, "rasterize", counted)
    pg = tt.probe_grid([1, 3], [1, 3], 3, 3)
    _, tp = pair.probes(25, pg)
    _feed_tacaw(pair, tp, 4, frequencies=[20.0, 0.0], probe_chunk=2)
    assert len(calls) == pair.n_frames
    _feed_haadf(pair, tp, pg, 4, chunk=2)
    assert len(calls) == 2 * pair.n_frames


def test_fold_is_in_place():
    """fold adds phase * psi into each bin and psi into the mean, in place,
    exactly as the broadcast product would."""
    g = torch.Generator().manual_seed(0)
    acc = torch.randn((3, 2, 4, 5), dtype=torch.complex128, generator=g)
    mean = torch.randn((2, 4, 5), dtype=torch.complex128, generator=g)
    psi = torch.randn((2, 4, 5), dtype=torch.complex128, generator=g)
    ph = ts.phase_factors([3], [0, 1, 2], 6, np.float64)[0]
    want_acc = acc + torch.as_tensor(ph)[:, None, None, None] * psi[None]
    want_mean = mean + psi
    ptrs = (acc.data_ptr(), mean.data_ptr())
    ts.fold(acc, mean, psi, ph)
    assert (acc.data_ptr(), mean.data_ptr()) == ptrs
    torch.testing.assert_close(acc, want_acc, rtol=1e-15, atol=1e-15)
    assert torch.equal(mean, want_mean)


def test_phase_factors_rounded_once():
    """The angle in float64, then cos and sin rounded to the real type:
    the factors of frame t are the same whatever block it came in."""
    bins = [0, 1, 5]
    block = ts.phase_factors([0, 3, 5], bins, 8, np.float32)
    for k, t in enumerate([0, 3, 5]):
        np.testing.assert_array_equal(
            ts.phase_factors([t], bins, 8, np.float32)[0], block[k])
    assert np.all(block.real.astype(np.float32) == block.real)
    np.testing.assert_allclose(block, np.exp(-2j * np.pi * np.outer(
        [0, 3, 5], bins) / 8), atol=1e-7)


def test_mesh_raises(pair):
    _, tp = pair.probes(25, [(1.0, 1.0)])
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        tt.StreamingTACAW(pair.tspec, tp, 6, 0.005, mesh=object())
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        tt.StreamingHAADF(pair.tspec, tp, [(1.0, 1.0)], mesh=object())


def test_complex64_streams_match_jax():
    """Single precision, both engines: residual <= 1e-6 against JAX."""
    pair = Pair(hbn_thermal(n_frames=4, sigma=0.05, seed=3), "single")
    pg = tt.probe_grid([1, 3], [1, 3], 2, 2)
    st, js = _tacaw_both(pair, 25, pg, frequencies=[0.0, 50.0],
                         probe_chunk=3)
    got = _np(st.intensity())
    assert got.dtype == np.float32
    assert residual(got, _np(js.intensity())) <= 1e-6
    sh, jh = _haadf_both(pair, 25, pg, 4, collection_angle=45)
    assert residual(sh.image(), jh.image()) <= 1e-6
