"""The port's visualization helpers and NumPy oracles against the JAX
package's, on the same NumPy inputs in float64.

With the Agg backend and ``plt.show`` replaced, each plot hands ``imshow``
an array, an ``extent`` and a ``cmap``: the port's ``Probe.plot``,
``Potential.plot``, ``HAADFData.plot`` and ``calculateADF(preview=True)``
must give the JAX package's, arrays to 1e-10. ``Grid.sample_points_2d``
and ``form_factor_np`` must equal the JAX package's exactly. Without
matplotlib a plot raises ImportError naming itself. matplotlib is checked
on the CPU only: the card's machine has none.
"""

import sys

import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.axes import Axes  # noqa: E402

import pyslice_tpu as jpt  # noqa: E402
import pyslice_tpu_torch as tpt  # noqa: E402
from pyslice_tpu.analysis.haadf import HAADFData as JHAADF  # noqa: E402
from pyslice_tpu.analysis.wf_data import WFData as JWF  # noqa: E402
from pyslice_tpu_torch.analysis.haadf import HAADFData as THAADF  # noqa: E402
from pyslice_tpu_torch.analysis.wf_data import WFData as TWF  # noqa: E402

TOL = 1e-10


@pytest.fixture
def drawn(monkeypatch):
    """The (array, extent, cmap) of every imshow call, in order."""
    calls = []
    imshow = Axes.imshow

    def record(self, X, *args, **kw):
        calls.append((np.array(X, dtype=np.float64), kw.get("extent"),
                      kw.get("cmap")))
        return imshow(self, X, *args, **kw)

    monkeypatch.setattr(Axes, "imshow", record)
    monkeypatch.setattr(plt, "show", lambda *a, **k: None)
    yield calls
    plt.close("all")


def same_draw(jax_call, port_call):
    (ja, je, jc), (ta, te, tc) = jax_call, port_call
    assert ja.shape == ta.shape
    scale = max(np.abs(ja).max(), 1e-300)
    assert np.abs(ja - ta).max() <= TOL * scale
    assert (je is None and te is None) or np.allclose(je, te, rtol=0,
                                                      atol=0)
    assert jc == tc


def grid():
    return jpt.grid_from_box(6.0, 5.0, 3.0, 0.25, 1.0), \
        tpt.grid_from_box(6.0, 5.0, 3.0, 0.25, 1.0)


@pytest.mark.parametrize("batch", [False, True], ids=["one", "batch"])
def test_torch_probe_plot_matches_jax(drawn, batch):
    jg, tg = grid()
    jp = jpt.Probe(jg.xs, jg.ys, 20.0, 100e3, precision="double")
    if batch:
        jp = jpt.create_batched_probes(jp, [(1.0, 1.5), (3.2, 2.1)])
    # the same array (|probe|^0.25 amplifies roundoff at dark pixels)
    tp = tpt.Probe(tg.xs, tg.ys, 20.0, 100e3, array=np.asarray(jp.array),
                   precision="double", device="cpu")
    jp.plot()
    tp.plot()
    assert len(drawn) == 2
    same_draw(*drawn)


def test_torch_potential_plot_matches_jax(drawn):
    jg, tg = grid()
    rng = np.random.default_rng(2)
    pos = rng.random((6, 3)) * np.array([6.0, 5.0, 3.0])
    types = np.array([5, 7, 6, 8, 14, 5])
    jpt.Potential(jg.xs, jg.ys, jg.zs, pos, types, precision="double").plot()
    tpt.Potential(tg.xs, tg.ys, tg.zs, pos, types, precision="double",
                  device="cpu").plot()
    assert len(drawn) == 2
    same_draw(*drawn)


def wf_pair(as_tensor=False):
    """The same 3 x 3-probe, 2-frame WFData in both packages."""
    import torch
    rng = np.random.default_rng(5)
    nx, ny = 16, 12
    w = (rng.normal(size=(9, 2, nx, ny, 1))
         + 1j * rng.normal(size=(9, 2, nx, ny, 1)))
    pp = jpt.probe_grid([0.0, 2.0], [0.0, 1.5], 3, 3)
    kxs = np.fft.fftshift(np.fft.fftfreq(nx, 0.1))
    kys = np.fft.fftshift(np.fft.fftfreq(ny, 0.1))
    xs, ys = np.arange(nx) * 0.1, np.arange(ny) * 0.1
    jp = jpt.Probe(xs, ys, 20.0, 100e3, precision="double")
    tp = tpt.Probe(xs, ys, 20.0, 100e3, precision="double", device="cpu")
    common = dict(probe_positions=pp, time=np.arange(2) * 0.005, kxs=kxs,
                  kys=kys, layer=np.array([0]))
    return (JWF(wavefunction_data=w, probe=jp, **common),
            TWF(wavefunction_data=torch.as_tensor(w) if as_tensor else w,
                probe=tp, **common))


@pytest.mark.parametrize("as_tensor", [False, True],
                         ids=["array", "tensor"])
def test_torch_haadf_preview_and_plot_match_jax(drawn, as_tensor):
    jwf, twf = wf_pair(as_tensor)
    jh, th = JHAADF(jwf), THAADF(twf)
    ja = jh.calculateADF(45, preview=True)
    ta = th.calculateADF(45, preview=True)
    assert np.abs(ja - ta).max() <= TOL * np.abs(ja).max()
    assert len(drawn) == 2
    same_draw(drawn[0], drawn[1])
    jh.plot()
    th.plot()
    assert len(drawn) == 4
    same_draw(drawn[2], drawn[3])


@pytest.mark.parametrize("plot", ["probe", "potential", "haadf",
                                  "preview"])
def test_torch_plots_without_matplotlib_raise(monkeypatch, plot):
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    _, tg = grid()
    if plot == "probe":
        fn = tpt.Probe(tg.xs, tg.ys, 20.0, 100e3, device="cpu").plot
    elif plot == "potential":
        fn = tpt.Potential(tg.xs, tg.ys, tg.zs, np.array([[1.0, 1.0, 0.5]]),
                           np.array([6]), device="cpu").plot
    else:
        h = THAADF(wf_pair()[1])
        h.calculateADF(45)
        fn = h.plot if plot == "haadf" else \
            (lambda: h.calculateADF(45, preview=True))
    with pytest.raises(ImportError, match="matplotlib, which is not "
                       "installed"):
        fn()


@pytest.mark.parametrize("oblique", [False, True],
                         ids=["orthogonal", "oblique"])
def test_torch_sample_points_2d_equals_jax(oblique):
    if oblique:
        box = np.array([[6.0, 1.5, 0.0], [0.0, 5.0, 0.0], [0.0, 0.0, 3.0]])
        jg = jpt.core.grids.grid_from_box_matrix(box, 0.25, 1.0)
        tg = tpt.grid_from_box_matrix(box, 0.25, 1.0)
        assert jg.cell2d is not None
    else:
        jg, tg = grid()
    assert np.array_equal(jg.sample_points_2d(), tg.sample_points_2d())
    assert tg.sample_points_2d().dtype == np.float64


@pytest.mark.parametrize("z", [1, 5, 14, 79, 103])
def test_torch_form_factor_np_equals_jax(z):
    from pyslice_tpu.physics.kirkland import form_factor_np as jff
    from pyslice_tpu_torch.physics.kirkland import form_factor_np as tff
    qsq = np.random.default_rng(z).random((7, 5)) * 9.0
    assert np.array_equal(jff(qsq, z), tff(qsq, z))
    assert np.array_equal(jff(2.5, z), tff(2.5, z))
