"""Port parity for the crystal builders (data/crystals.py): every
prototype, zone-axis supercell and point defect bit for bit against
pyslice_tpu's (positions, types, box), plus tests/test_crystals.py's
behaviour tests mirrored on the port."""

import numpy as np
import pytest
import torch

from pyslice_tpu.data import crystals as jcr

import pyslice_tpu_torch as tt
from pyslice_tpu_torch.data import crystals as tcr
from pyslice_tpu_torch.data.trajectory import Trajectory

torch.set_num_threads(2)

KINDS = [("sc", "Po"), ("fcc", "Au"), ("bcc", "Fe"), ("diamond", "Si"),
         ("zincblende", ("Ga", "As")), ("rocksalt", ("Na", "Cl")),
         ("cscl", ("Cs", "Cl")), ("fluorite", ("Ca", "F")), ("hcp", "Mg"),
         ("wurtzite", ("Ga", "N")), ("graphene", "C"), ("hbn", ("B", "N"))]


def _same(t, j):
    assert isinstance(t, Trajectory)
    for name in ("atom_types", "positions", "velocities", "box_matrix"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert t.timestep == j.timestep


def _min_pair_distance(pos):
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    d[np.diag_indices(len(pos))] = np.inf
    return d.min()


@pytest.mark.parametrize("kind,elements", KINDS)
def test_crystal_bit_identical(kind, elements):
    size = (2, 3, 1) if kind in ("graphene", "hbn") else (2, 3, 2)
    _same(tt.crystal(elements, kind, a=3.7, size=size, vacuum=4.0),
          jcr.crystal(elements, kind, a=3.7, size=size, vacuum=4.0))


@pytest.mark.parametrize("zone,min_size", [
    ((1, 1, 0), (0, 0, 0)), ((1, 1, 0), (20.0, 20.0, 10.0)),
    ((1, 1, 1), (0, 0, 0)), ((2, 1, 1), (0, 0, 0)), ((3, 1, 0), (0, 0, 0))])
def test_orthogonal_supercell_bit_identical(zone, min_size):
    si_t = tt.crystal("Si", "diamond", a=5.431)
    si_j = jcr.crystal("Si", "diamond", a=5.431)
    _same(tt.orthogonal_supercell(si_t, zone, min_size=min_size),
          jcr.orthogonal_supercell(si_j, zone, min_size=min_size))


@pytest.mark.parametrize("which", ["substitute", "vacancies"])
def test_defects_bit_identical(which):
    t = tt.crystal(("Ga", "As"), "zincblende", a=5.65, size=(3, 3, 2))
    j = jcr.crystal(("Ga", "As"), "zincblende", a=5.65, size=(3, 3, 2))
    extra = ("In",) if which == "substitute" else ()
    for kw in (dict(fraction=0.3, of_element="Ga", seed=4),
               dict(fraction=0.1, seed=9), dict(indices=[0, 7, 11])):
        _same(getattr(tcr, which)(t, *extra, **kw),
              getattr(jcr, which)(j, *extra, **kw))


class TestPrototypes:
    @pytest.mark.parametrize("kind,elements,n_per_cell", [
        ("sc", "Po", 1), ("fcc", "Au", 4), ("bcc", "Fe", 2),
        ("diamond", "Si", 8), ("zincblende", ("Ga", "As"), 8),
        ("rocksalt", ("Na", "Cl"), 8), ("cscl", ("Cs", "Cl"), 2),
        ("fluorite", ("Ca", "F"), 12), ("hcp", "Mg", 4),
        ("wurtzite", ("Ga", "N"), 8),
    ])
    def test_counts_and_tiling(self, kind, elements, n_per_cell):
        t = tt.crystal(elements, kind, a=4.0, size=(2, 3, 1))
        assert t.n_atoms == n_per_cell * 6
        assert t.n_frames == 1
        assert np.all(t.positions[0] >= -1e-9)
        assert np.all(t.positions[0] <= np.diag(t.box_matrix) + 1e-9)

    def test_diamond_bond_length(self):
        a = 5.431
        t = tt.crystal("Si", "diamond", a=a)
        assert _min_pair_distance(t.positions[0]) == pytest.approx(
            a * np.sqrt(3) / 4, rel=1e-9)

    def test_rocksalt_bond_length(self):
        t = tt.crystal(("Na", "Cl"), "rocksalt", a=5.64)
        assert _min_pair_distance(t.positions[0]) == pytest.approx(
            5.64 / 2, rel=1e-9)

    def test_hcp_ideal_nn(self):
        a = 3.21
        t = tt.crystal("Mg", "hcp", a=a, size=(2, 2, 2))
        assert _min_pair_distance(t.positions[0]) == pytest.approx(
            a, rel=1e-9)

    def test_graphene_bond_length_and_vacuum(self):
        a = 2.46
        t = tt.crystal("C", "graphene", a=a, size=(3, 2, 1), vacuum=5.0)
        assert _min_pair_distance(t.positions[0]) == pytest.approx(
            a / np.sqrt(3), rel=1e-9)
        assert np.all(t.positions[0][:, 2] == 5.0)
        assert t.box_matrix[2, 2] == 10.0

    def test_hbn_stoichiometry(self):
        t = tt.crystal(("B", "N"), "hbn", a=2.504, size=(4, 4, 1))
        assert (t.atom_types == 5).sum() == (t.atom_types == 7).sum()

    def test_wurtzite_bond_ideal(self):
        a = 3.19
        t = tt.crystal(("Ga", "N"), "wurtzite", a=a)
        c = a * np.sqrt(8.0 / 3.0)
        assert _min_pair_distance(t.positions[0]) == pytest.approx(
            0.375 * c, rel=1e-9)

    def test_errors(self):
        with pytest.raises(ValueError, match="unknown crystal kind"):
            tt.crystal("Si", "nope", a=4.0)
        with pytest.raises(ValueError, match="element"):
            tt.crystal("Si", "zincblende", a=4.0)
        with pytest.raises(ValueError, match="in-plane"):
            tt.crystal("C", "graphene", a=2.46, size=(2, 2, 2))
        with pytest.raises(ValueError, match="positive"):
            tt.crystal("Si", "diamond", a=4.0, size=(0, 1, 1))


class TestZoneAxis:
    def test_si_110_dumbbells(self):
        a = 5.431
        t = tt.orthogonal_supercell(tt.crystal("Si", "diamond", a=a),
                                    (1, 1, 0))
        np.testing.assert_allclose(
            np.sort(np.diag(t.box_matrix)),
            np.sort([a, a * np.sqrt(2), a * np.sqrt(2)]), rtol=1e-9)
        assert t.n_atoms == 16
        # the projected image shows dumbbells split by a/4
        xy = t.positions[0][:, :2]
        d = np.linalg.norm(xy[:, None] - xy[None], axis=-1)
        assert d[d > 1e-6].min() == pytest.approx(a / 4, rel=1e-6)

    @pytest.mark.parametrize("zone", [(1, 0, 0), (1, 1, 1), (2, 1, 1),
                                      (3, 1, 0)])
    def test_arbitrary_cubic_zones_volume_checked(self, zone):
        au = tt.crystal("Au", "fcc", a=4.08)
        t = tt.orthogonal_supercell(au, zone)
        rho0 = au.n_atoms / np.linalg.det(au.box_matrix)
        rho = t.n_atoms / np.linalg.det(t.box_matrix)
        assert rho == pytest.approx(rho0, rel=1e-9)
        assert _min_pair_distance(t.positions[0]) == pytest.approx(
            4.08 / np.sqrt(2), rel=1e-6)

    def test_min_size_tiling(self):
        si = tt.crystal("Si", "diamond", a=5.431)
        t = tt.orthogonal_supercell(si, (1, 1, 0),
                                    min_size=(20.0, 20.0, 10.0))
        assert np.all(np.diag(t.box_matrix)
                      >= np.array([20, 20, 10]) - 1e-9)

    def test_non_cubic_rejected(self):
        with pytest.raises(ValueError, match="CUBIC"):
            tt.orthogonal_supercell(tt.crystal("Mg", "hcp", a=3.2),
                                    (1, 1, 0))


class TestDefects:
    def test_substitute_fraction_of_element(self):
        t = tt.crystal(("Ga", "As"), "zincblende", a=5.65, size=(3, 3, 3))
        n_ga = (t.atom_types == 31).sum()
        d = tt.substitute(t, "In", fraction=0.25, of_element="Ga", seed=1)
        assert (d.atom_types == 49).sum() == round(0.25 * n_ga)
        assert (d.atom_types == 33).sum() == (t.atom_types == 33).sum()

    def test_vacancies_indices(self):
        t = tt.crystal("Au", "fcc", a=4.08, size=(2, 2, 2))
        assert tt.vacancies(t, indices=[0, 5]).n_atoms == t.n_atoms - 2

    def test_pick_validation(self):
        t = tt.crystal("Au", "fcc", a=4.08)
        with pytest.raises(ValueError, match="exactly one"):
            tt.vacancies(t)
        with pytest.raises(ValueError, match="exactly one"):
            tt.substitute(t, "Ag", indices=[0], fraction=0.1)
        with pytest.raises(ValueError, match="out of range"):
            tt.vacancies(t, indices=[99])
        with pytest.raises(ValueError, match=r"fraction must be in \[0, 1\]"):
            tt.vacancies(t, fraction=1.5)
        with pytest.raises(ValueError, match=r"fraction must be in \[0, 1\]"):
            tt.substitute(t, "Ag", fraction=-0.1)

    def test_defect_trajectory_feeds_pipeline(self):
        t = tt.crystal(("B", "N"), "hbn", a=2.504, size=(3, 3, 1),
                       vacuum=3.0)
        t = t.generate_random_displacements(
            2, 0.03, generator=torch.Generator().manual_seed(0))
        calc = tt.MultisliceCalculator(device="cpu")
        calc.setup(t, aperture=0, voltage_eV=100e3, sampling=0.4,
                   slice_thickness=2.0, use_cache=False)
        wf = calc.run(progress=False)
        assert np.all(np.isfinite(np.abs(np.asarray(
            wf.wavefunction_data))))
