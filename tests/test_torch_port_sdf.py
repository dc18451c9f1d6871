"""The port's toolkit-free SDF reader (`phoregen_tpu_torch/data/sdf.py`)
on tests/test_sdf.py's cases: files written by the port's own writer,
multi-record files, legacy and `M  CHG` charges, H removal, `check_mol`'s
paths and malformed blocks. Every parse equals the JAX package's parse of
the same text exactly."""
import os

import numpy as np
import pytest

from phoregen_tpu.data import sdf as jsdf

from phoregen_tpu_torch.data import sdf as psdf
from phoregen_tpu_torch.sample.chem import SimpleMol
from phoregen_tpu_torch.sample.writers import sdf_block, write_sdf


def _same(ours, ref):
    """Two parsed molecules, field for field, exactly."""
    assert ours.elements == ref.elements
    for f in ("pos", "bond_index", "bond_type", "charges"):
        a, b = getattr(ours, f, None), getattr(ref, f, None)
        if b is None:
            assert a is None, f
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _ethanol_like() -> SimpleMol:
    return SimpleMol(
        elements=[6, 6, 8],
        pos=np.array([[0.0, 0.0, 0.0], [1.5, 0.0, 0.0], [2.2, 1.1, 0.0]]),
        bond_index=np.array([[0, 1, 1, 2], [1, 0, 2, 1]]),
        bond_type=np.array([1, 1, 2, 2]))


ION = "\n".join([
    "ion", "  test", "",
    "  2  1  0  0  0  0  0  0  0  0999 V2000",
    "    0.0000    0.0000    0.0000 N   0  3  0  0  0  0  0  0  0  0  0  0",
    "    1.2000    0.0000    0.0000 O   0  0  0  0  0  0  0  0  0  0  0  0",
    "  1  2  1  0  0  0  0",
    "M  END"])

METHANOL = "\n".join([
    "methanol", "  test", "",
    "  3  2  0  0  0  0  0  0  0  0999 V2000",
    "    0.0000    0.0000    0.0000 C   0  0  0  0  0  0  0  0  0  0  0  0",
    "    1.4000    0.0000    0.0000 O   0  0  0  0  0  0  0  0  0  0  0  0",
    "    2.0000    0.8000    0.0000 H   0  0  0  0  0  0  0  0  0  0  0  0",
    "  1  2  1  0  0  0  0",
    "  2  3  1  0  0  0  0",
    "M  END"])


def test_roundtrip_through_the_port_writer(tmp_path):
    mol = _ethanol_like()
    path = os.path.join(tmp_path, "m.sdf")
    write_sdf(mol, path, name="m")
    back = psdf.read_sdf(path)
    assert len(back) == 1
    b = back[0]
    assert b.elements == mol.elements
    np.testing.assert_allclose(b.pos, mol.pos, atol=1e-4)
    assert b.undirected_bonds() == mol.undirected_bonds()
    ref = jsdf.read_sdf(path)
    assert len(ref) == 1
    _same(b, ref[0])


def test_multi_record_and_aromatic(tmp_path):
    blocks = (sdf_block([6, 6], np.zeros((2, 3)), [(0, 1, 4)], "a")
              + "$$$$\n"
              + sdf_block([7], np.ones((1, 3)), [], "b") + "$$$$\n")
    path = os.path.join(tmp_path, "two.sdf")
    with open(path, "w") as f:
        f.write(blocks)
    mols = psdf.read_sdf(path)
    assert len(mols) == 2
    assert mols[0].undirected_bonds() == [(0, 1, 4)]
    assert mols[1].elements == [7] and mols[1].bond_index.shape == (2, 0)
    ref = jsdf.read_sdf(path)
    assert len(ref) == 2
    for a, b in zip(mols, ref):
        _same(a, b)


def test_legacy_and_property_charges():
    m = psdf.parse_molblock(ION)
    assert m.charges.tolist() == [1, 0]
    _same(m, jsdf.parse_molblock(ION))
    block2 = ION.replace("M  END", "M  CHG  1   2  -1\nM  END")
    m2 = psdf.parse_molblock(block2)
    assert m2.charges.tolist() == [0, -1]     # M CHG resets the legacy +1
    _same(m2, jsdf.parse_molblock(block2))


def test_hydrogen_parsing_and_removal():
    m = psdf.parse_molblock(METHANOL)
    assert m.elements == [6, 8, 1]
    heavy = psdf.remove_hydrogens(m)
    assert heavy.elements == [6, 8]
    assert heavy.undirected_bonds() == [(0, 1, 1)]
    np.testing.assert_allclose(heavy.pos, m.pos[:2])
    _same(m, jsdf.parse_molblock(METHANOL))
    _same(heavy, jsdf.remove_hydrogens(jsdf.parse_molblock(METHANOL)))


def test_loose_whitespace_lines_parse_as_in_jax():
    """Atom and bond lines off the fixed columns fall back to a
    whitespace split in both readers."""
    block = "\n".join([
        "loose", "", "",
        "  2  1  0  0  0  0  0  0  0  0999 V2000",
        "0.5 -1.25 2.0 Cl 0 5",
        "1.5 -1.25 2.0 C",
        "1 2 1",
        "M  END"])
    m = psdf.parse_molblock(block)
    assert m.elements == [17, 6] and m.charges.tolist() == [-1, 0]
    _same(m, jsdf.parse_molblock(block))


def test_check_mol_paths(tmp_path):
    mol = _ethanol_like()
    sdf_path = os.path.join(tmp_path, "m.sdf")
    write_sdf(mol, sdf_path)
    loaded = psdf.check_mol(sdf_path, use_rdkit=False)
    assert loaded.elements == mol.elements
    _same(loaded, jsdf.check_mol(sdf_path, use_rdkit=False))
    mol_path = os.path.join(tmp_path, "m.mol")
    with open(mol_path, "w") as f:
        f.write(sdf_block(mol.elements, mol.pos, mol.undirected_bonds()))
    loaded2 = psdf.check_mol(mol_path, use_rdkit=False)
    assert loaded2.undirected_bonds() == mol.undirected_bonds()
    _same(loaded2, jsdf.check_mol(mol_path, use_rdkit=False))
    # passthrough + unsupported
    assert psdf.check_mol(mol, use_rdkit=False) is mol
    with pytest.raises(NotImplementedError):
        psdf.check_mol(os.path.join(tmp_path, "nope.xyz2"), use_rdkit=False)
    with pytest.raises(NotImplementedError):
        psdf.check_mol(12345, use_rdkit=False)
    empty = os.path.join(tmp_path, "empty.sdf")
    with open(empty, "w") as f:
        f.write("\n$$$$\n")
    with pytest.raises(psdf.SdfParseError, match="no records"):
        psdf.check_mol(empty, use_rdkit=False)


@pytest.mark.parametrize("block,match", [
    ("too\nshort", "too short"),
    ("\n".join(["x", "", "", "  1  0  0  0  0  0  0  0  0  0999 V3000"]),
     "V3000"),
    ("\n".join(["x", "", "", "  a  0"]), "bad counts"),
    ("\n".join(["x", "", "", "  2  0  0  0  0  0  0  0  0  0999 V2000",
                "    0.0000    0.0000    0.0000 C   0  0"]), "truncated"),
    ("\n".join(["x", "", "", "  1  0  0  0  0  0  0  0  0  0999 V2000",
                "    0.0000    0.0000    0.0000 Xq  0  0"]), "unknown element"),
    ("\n".join(["x", "", "", "  1  1  0  0  0  0  0  0  0  0999 V2000",
                "    0.0000    0.0000    0.0000 C   0  0",
                "  1  5  1  0"]), "out of range"),
])
def test_malformed_blocks_raise_as_in_jax(block, match):
    with pytest.raises(psdf.SdfParseError, match=match):
        psdf.parse_molblock(block)
    with pytest.raises(jsdf.SdfParseError, match=match):
        jsdf.parse_molblock(block)
