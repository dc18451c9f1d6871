"""The port's RDKit-gated data modules (`data/mol.py`, `phorefp.py`,
`ligphore.py`, `surface.py`) against the JAX package's on the same fake
molecules. RDKit is not among the repository's dependencies, so both
packages' modules run against `tests/fake_rdkit.py`, installed and
reloaded as tests/test_rdkit_gated.py does and restored afterwards.
Substructure matches are programmed per molecule (the fake does not parse
SMARTS). Outputs are equal; LigPhore positions and norms within 1e-6."""
import dataclasses
import importlib
import sys

import numpy as np
import pytest

import tests.fake_rdkit as fake

JAX_MODS = ("phoregen_tpu.data.mol", "phoregen_tpu.data.phorefp",
            "phoregen_tpu.data.ligphore")
PORT_MODS = ("phoregen_tpu_torch.data.mol", "phoregen_tpu_torch.data.phorefp",
             "phoregen_tpu_torch.data.ligphore")


def _reload(names):
    return [importlib.reload(importlib.import_module(n)) for n in names]


@pytest.fixture()
def gated(monkeypatch):
    """Both packages' gated modules reloaded against the fake toolkit:
    {"jax": (mol, phorefp, ligphore, surface), "port": (...)}; the real
    state (no RDKit) is restored after."""
    fake.install(monkeypatch)
    out = {}
    for key, names in (("jax", JAX_MODS), ("port", PORT_MODS)):
        mods = _reload(names)
        pkg = names[0].rsplit(".", 1)[0]
        out[key] = tuple(mods) + (importlib.import_module(pkg + ".surface"),)
    yield out
    monkeypatch.undo()
    _reload(JAX_MODS + PORT_MODS)


def _rich():
    """An aromatic ring with an amide, a CH2 next to a charged NH3+, a
    thioether-like S and a chlorine: every element class and bond type
    the featurizers branch on, and hydrogens only as counts."""
    theta = np.linspace(0, 2 * np.pi, 6, endpoint=False)
    ring = np.stack([1.4 * np.cos(theta), 1.4 * np.sin(theta),
                     np.zeros(6)], axis=1)
    out = lambda i, r: ring[i] * r / 1.4
    pos = np.concatenate([ring, [out(0, 2.9), out(0, 2.9) + [0.6, 1.1, 0.1],
                                 out(0, 2.9) + [0.7, -1.1, -0.1],
                                 out(3, 2.9), out(3, 2.9) + [-0.8, 1.2, 0.3],
                                 out(4, 3.2), out(2, 3.1)]])
    H = fake.HybridizationType
    atoms = [fake.FakeAtom(i, 6, H.SP2, valence=4, in_ring=True,
                           aromatic=True, num_hs=1) for i in range(6)]
    atoms += [fake.FakeAtom(6, 6, H.SP2, valence=4),            # C=O carbon
              fake.FakeAtom(7, 8, H.SP2, valence=2),            # =O
              fake.FakeAtom(8, 7, H.SP2, valence=3, num_hs=2),  # amide NH2
              fake.FakeAtom(9, 6, H.SP3, valence=4, num_hs=2),  # CH2
              fake.FakeAtom(10, 7, H.SP3, valence=4, num_hs=3,
                            formal_charge=1),                  # NH3+
              fake.FakeAtom(11, 16, H.SP3, valence=2, num_hs=1),  # SH
              fake.FakeAtom(12, 17, H.UNSPECIFIED, valence=1)]   # Cl
    B = fake.BondType
    bonds = [fake.FakeBond(i, (i + 1) % 6, B.AROMATIC) for i in range(6)]
    bonds += [fake.FakeBond(0, 6, B.SINGLE), fake.FakeBond(6, 7, B.DOUBLE),
              fake.FakeBond(6, 8, B.SINGLE), fake.FakeBond(3, 9, B.SINGLE),
              fake.FakeBond(9, 10, B.SINGLE), fake.FakeBond(4, 11, B.SINGLE),
              fake.FakeBond(2, 12, B.SINGLE)]
    return fake.FakeMol(atoms, bonds, pos, rings=[tuple(range(6))])


def _with_h():
    """Explicit hydrogens (the AncPhore rules' O-H and S-H branches): an
    ethyl chain with an O-H, a C=S and an S-H, then a carbon chain that
    ends in a tertiary amine."""
    pos = np.asarray([[0, 0, 0], [1.5, 0, 0], [2.2, 1.2, 0], [3.1, 1.1, 0],
                      [-0.8, 1.4, 0], [-0.9, -1.5, 0.2], [-2.2, -1.4, 0.3],
                      [2.2, -1.3, 0.1], [3.7, -1.3, 0.2], [4.4, -2.6, 0.3],
                      [5.9, -2.6, 0.4], [6.6, -3.9, 0.5], [8.0, -3.9, 0.6]],
                     np.float64)
    H = fake.HybridizationType
    atoms = [fake.FakeAtom(0, 6, H.SP2, num_hs=0),
             fake.FakeAtom(1, 6, H.SP3, num_hs=1),
             fake.FakeAtom(2, 8, H.SP3, valence=2, num_hs=1),
             fake.FakeAtom(3, 1, H.UNSPECIFIED, valence=1),
             fake.FakeAtom(4, 16, H.SP2, valence=2),
             fake.FakeAtom(5, 16, H.SP3, valence=2, num_hs=1),
             fake.FakeAtom(6, 1, H.UNSPECIFIED, valence=1)]
    atoms += [fake.FakeAtom(i, 6, H.SP3, num_hs=2) for i in range(7, 12)]
    atoms.append(fake.FakeAtom(12, 7, H.SP3, valence=3))
    B = fake.BondType
    bonds = [fake.FakeBond(0, 1, B.SINGLE), fake.FakeBond(1, 2, B.SINGLE),
             fake.FakeBond(2, 3, B.SINGLE), fake.FakeBond(0, 4, B.DOUBLE),
             fake.FakeBond(0, 5, B.SINGLE), fake.FakeBond(5, 6, B.SINGLE)]
    bonds += [fake.FakeBond(i, i + 1, B.SINGLE) for i in range(7, 12)]
    bonds.append(fake.FakeBond(1, 7, B.SINGLE))
    return fake.FakeMol(atoms, bonds, pos)


def _cyclohexane():
    n = 6
    ang = np.arange(n) * np.pi / 3
    r = 1.54 / (2 * np.sin(np.pi / n))
    pos = np.stack([r * np.cos(ang), r * np.sin(ang), np.zeros(n)], -1)
    atoms = [fake.FakeAtom(i, 6, in_ring=True, num_hs=2) for i in range(n)]
    bonds = [fake.FakeBond(i, (i + 1) % n, fake.BondType.SINGLE)
             for i in range(n)]
    return fake.FakeMol(atoms, bonds, pos=pos, rings=[tuple(range(n))])


MOLS = {"benzene_with_tail": fake.benzene_with_tail, "rich": _rich,
        "cyclohexane": _cyclohexane}


def _program(m, patterns):
    """Program the fake's matches: pattern p of type t matches atom
    (t_index + p) mod n, spread over the index slots the pattern reads."""
    n = m.GetNumAtoms()
    for ti, (t, pats) in enumerate(sorted(patterns.items())):
        for pi, (smarts, idxs) in enumerate(pats):
            if (ti + pi) % 3 == 0:
                continue                          # some patterns match nothing
            width = max(idxs) + 1
            m.set_matches(smarts, [tuple((ti + pi + k) % n
                                         for k in range(width))])
    return m


def _eq(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_gated_modules_follow_the_toolkit_in_place(gated):
    """Reloading switches the port's modules to the installed toolkit; the
    SMARTS table is the JAX package's and the pattern cache is rebuilt
    against the fake."""
    jmol, jfp, _, _ = gated["jax"]
    pmol, pfp, plig, _ = gated["port"]
    assert pmol.HAVE_RDKIT and pfp.HAVE_RDKIT and plig.HAVE_RDKIT
    assert pfp.PHORE_PATTERNS == jfp.PHORE_PATTERNS
    assert pfp._COMPILED is None
    comp = pfp._compiled()
    assert all(isinstance(p, fake.FakePattern) and p.smarts == s
               for t, pats in pfp.PHORE_PATTERNS.items()
               for (p, _), (s, _) in zip(comp[t], pats))


@pytest.fixture()
def no_toolkit(monkeypatch):
    """Both packages' gated modules reloaded with RDKit unimportable;
    the real state is restored after."""
    for name in ("rdkit", "rdkit.Chem"):
        monkeypatch.setitem(sys.modules, name, None)
    yield _reload(JAX_MODS), _reload(PORT_MODS)
    monkeypatch.undo()
    _reload(JAX_MODS + PORT_MODS)


def test_without_the_toolkit_load_mol_raises(tmp_path, no_toolkit):
    """Without RDKit the port's `load_mol` and featurizers raise
    `MolParseError`, as the JAX package's do: no toolkit-free path."""
    (jmol, _, _), (pmol, pfp, _) = no_toolkit
    assert not pmol.HAVE_RDKIT and not pfp.HAVE_RDKIT
    path = str(tmp_path / "m.sdf")
    for mod in (pmol, jmol):
        with pytest.raises(mod.MolParseError, match="RDKit"):
            mod.load_mol(path)
        with pytest.raises(mod.MolParseError, match="RDKit"):
            mod.featurize_mol(fake.benzene_with_tail())
    with pytest.raises(ImportError, match="RDKit"):
        pfp.generate_ligand_phore_feat(fake.benzene_with_tail())


@pytest.mark.parametrize("name", sorted(MOLS))
def test_featurize_mol_equals_jax(gated, name):
    jmol, pmol = gated["jax"][0], gated["port"][0]
    for remove_h in (True, False):
        ours = pmol.featurize_mol(MOLS[name](), remove_h=remove_h)
        ref = jmol.featurize_mol(MOLS[name](), remove_h=remove_h)
        for a, b in zip(ours, ref):
            _eq(a, b)
    m = MOLS[name]()
    m._atoms[1]._z = 34                    # Se: outside the vocabulary
    with pytest.raises(pmol.MolParseError, match="vocabulary"):
        pmol.featurize_mol(m)


@pytest.mark.parametrize("flags", [
    dict(include_hybrid=True, hybrid_one_hot=True, include_valencies=True,
         include_ring=True, include_aromatic=True),
    dict(include_hybrid=True),
    dict(include_valencies=True, include_aromatic=True),
    dict()])
def test_extra_atom_features_equal_jax(gated, flags):
    jmol, pmol = gated["jax"][0], gated["port"][0]
    for make in MOLS.values():
        _eq(pmol.extra_atom_features(make(), **flags),
            jmol.extra_atom_features(make(), **flags))


@pytest.mark.parametrize("name", sorted(MOLS))
def test_phore_fingerprint_and_ring_centers_equal_jax(gated, name):
    jfp, pfp = gated["jax"][1], gated["port"][1]
    ours = pfp.generate_ligand_phore_feat(
        _program(MOLS[name](), pfp.PHORE_PATTERNS))
    ref = jfp.generate_ligand_phore_feat(
        _program(MOLS[name](), jfp.PHORE_PATTERNS))
    assert ours.sum() > 0
    _eq(ours, ref)
    for a, b in zip(pfp.aromatic_ring_centers(MOLS[name]()),
                    jfp.aromatic_ring_centers(MOLS[name]())):
        _eq(a, b)


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("name", ["benzene_with_tail", "rich"])
def test_ligand_to_phore_equals_jax(gated, name, seed):
    """Same molecule, same `np.random.default_rng` seed: the same features
    in the same order, positions and norms within 1e-6."""
    jfp, jlig = gated["jax"][1:3]
    pfp, plig = gated["port"][1:3]
    ours = plig.ligand_to_phore(_program(MOLS[name](), pfp.PHORE_PATTERNS),
                                np.random.default_rng(seed), name="x")
    ref = jlig.ligand_to_phore(_program(MOLS[name](), jfp.PHORE_PATTERNS),
                               np.random.default_rng(seed), name="x")
    assert ours.name == ref.name == "x"
    assert len(ours.features) == len(ref.features) > 0
    assert "EX" in [f.type for f in ours.features]
    for a, b in zip(ours.features, ref.features):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        for k in ("pos", "norm"):
            np.testing.assert_allclose(da.pop(k), db.pop(k), atol=1e-6,
                                       rtol=0)
        assert da == db


@pytest.mark.parametrize("name", sorted(MOLS) + ["with_h"])
def test_surface_and_lipophilicity_equal_jax(gated, name):
    js, ps = gated["jax"][3], gated["port"][3]
    make = _with_h if name == "with_h" else MOLS[name]
    _eq(ps.label_lipo_atoms(make()), js.label_lipo_atoms(make()))
    m = make()
    pos = np.asarray(m.GetConformer().GetPositions(), np.float32)
    radii = ps.atom_radii([a.GetAtomicNum() for a in m.GetAtoms()])
    _eq(radii, js.atom_radii([a.GetAtomicNum() for a in m.GetAtoms()]))
    for i in range(len(pos)):
        assert ps.accessible_surface_fraction(pos, radii, i) == \
            js.accessible_surface_fraction(pos, radii, i)
    _eq(ps.fibonacci_sphere(37), js.fibonacci_sphere(37))
    if name == "with_h":
        return      # explicit H is outside the featurizers' vocabulary
    _eq(ps.lipo_contributions(make()), js.lipo_contributions(make()))
    for thr in (0.5, ps.LIPO_THRESHOLD):
        for fn in ("hydrophobic_groups", "ancphore_hy_groups"):
            ours = getattr(ps, fn)(make(), threshold=thr)
            ref = getattr(js, fn)(make(), threshold=thr)
            assert len(ours) == len(ref), fn
            for a, b in zip(ours, ref):
                _eq(a, b)
    if name == "cyclohexane":
        assert len(ps.ancphore_hy_groups(make())) == 1
