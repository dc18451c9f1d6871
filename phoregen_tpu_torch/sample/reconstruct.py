"""Molecule reconstruction from generated atoms/coords/bonds.

Parity target: `reconstruct_from_generated_with_edges` + repair loops
(reference `utils/sample_utils.py:421-507,772-848`):
- 'predicted' mode: build from model-predicted bonds; sanitize; on failure
  run the kekulize-driven `fix_aromatic` (charge/H enumeration over N/S ring
  atoms), `fix_valence` (N+ fix loop), then a strict retry.
- 'distance' mode: EDM bond-length lookup (see `predict_bonds`).
- 'openbabel' mode: liGAN-style connect-the-dots perception (only when
  openbabel is importable).

Backends: RDKit when available (full parity); otherwise the pure-Python
`SimpleMol` valence-table sanitizer so the pipeline stays runnable.
"""
from __future__ import annotations

import copy
import itertools
import re
from typing import Dict, List

import numpy as np

from .chem import (HAVE_OPENBABEL, HAVE_RDKIT, MolReconsError, SimpleMol,
                   is_connected, sanitize_simple)
from .predict_bonds import predict_bonds

if HAVE_RDKIT:
    from rdkit import Chem, Geometry, RDLogger  # type: ignore


# ---------------- RDKit repair loops (parity with the reference) -----------

def _get_ring_sys(mol):
    all_rings = [list(r) for r in mol.GetRingInfo().AtomRings()]
    if not all_rings:
        return []
    ring_sys_list = [all_rings[0]]
    for ring in all_rings[1:]:
        for prev in ring_sys_list:
            if set(ring) & set(prev):
                prev.extend(ring)
                break
        else:
            ring_sys_list.append(ring)
    return [list(set(x)) for x in ring_sys_list]


def _get_all_subsets(lst):
    out = []
    for n in range(len(lst) + 1):
        out.extend(itertools.combinations(lst, n))
    return out


def fix_valence(mol):
    """Iteratively charge N atoms whose explicit valence is 4
    (reference `utils/sample_utils.py:421-441`)."""
    mol = copy.deepcopy(mol)
    fixed = False
    n4 = re.compile(
        r"Explicit valence for atom # ([0-9]+) N, 4, is greater than permitted")
    for _ in range(101):
        try:
            Chem.SanitizeMol(mol)
            fixed = True
            break
        except Chem.rdchem.AtomValenceException as e:
            idx = n4.findall(e.args[0])
            if not idx:
                break
            mol.GetAtomWithIdx(int(idx[0])).SetFormalCharge(1)
        except Exception:
            return mol, False
    return mol, fixed


def fix_aromatic(mol, strict=False):
    """Charge/H enumeration over N/S atoms of aromatic ring systems
    (reference `utils/sample_utils.py:444-507`)."""
    mol_orig = mol
    aromatic = [a.GetIdx() for a in mol.GetAromaticAtoms()]
    N_rings, S_rings = [], []
    for ring_sys in _get_ring_sys(mol):
        if set(ring_sys) & set(aromatic):
            idx_N = [a for a in ring_sys
                     if mol.GetAtomWithIdx(a).GetSymbol() == "N"]
            if idx_N:
                N_rings.append(idx_N + [-1])
            idx_S = [a for a in ring_sys
                     if mol.GetAtomWithIdx(a).GetSymbol() == "S"]
            if idx_S:
                S_rings.append(idx_S + [-1])
    fixed = False
    if strict:
        flat = [s for ring in S_rings for s in ring if s != -1]
        perms = _get_all_subsets(flat)
    else:
        perms = list(itertools.product(*S_rings))
    for perm in perms:
        mol = copy.deepcopy(mol_orig)
        for idx in [x for x in perm if x != -1]:
            mol.GetAtomWithIdx(idx).SetFormalCharge(1)
        try:
            if strict:
                mol, fixed = fix_valence(mol)
            Chem.SanitizeMol(mol)
            fixed = True
            break
        except Exception:
            continue
    if not fixed:
        if strict:
            flat = [s for ring in N_rings for s in ring if s != -1]
            perms = _get_all_subsets(flat)
        else:
            perms = list(itertools.product(*N_rings))
        for perm in perms:
            perm = [x for x in perm if x != -1]
            for action in itertools.product([0, 1], repeat=len(perm)):
                mol = copy.deepcopy(mol_orig)
                for idx, act in zip(perm, action):
                    if act == 0:
                        mol.GetAtomWithIdx(idx).SetNumExplicitHs(1)
                    else:
                        mol.GetAtomWithIdx(idx).SetFormalCharge(1)
                try:
                    if strict:
                        mol, fixed = fix_valence(mol)
                    Chem.SanitizeMol(mol)
                    fixed = True
                    break
                except Exception:
                    continue
            if fixed:
                break
    return mol, fixed


def postprocess_rd_mol_1(mol):
    """Radical repair (reference `utils/sample_utils.py:640-676`): pair up
    radical electrons on bonded atoms by upgrading the bond order; convert
    leftover radicals into explicit hydrogens."""
    upgrade = {Chem.BondType.SINGLE: Chem.BondType.DOUBLE,
               Chem.BondType.DOUBLE: Chem.BondType.TRIPLE}
    mol = Chem.RemoveHs(mol)
    nbh: Dict[int, List[int]] = {}
    for b in mol.GetBonds():
        i, j = b.GetBeginAtomIdx(), b.GetEndAtomIdx()
        nbh.setdefault(i, []).append(j)
        nbh.setdefault(j, []).append(i)
    for atom in mol.GetAtoms():
        idx = atom.GetIdx()
        n_rad = atom.GetNumRadicalElectrons()
        if n_rad > 0:
            for j in nbh.get(idx, []):
                if j <= idx:
                    continue
                nb = mol.GetAtomWithIdx(j)
                nb_rad = nb.GetNumRadicalElectrons()
                if nb_rad > 0:
                    bond = mol.GetBondBetweenAtoms(idx, j)
                    if bond.GetBondType() in upgrade:
                        bond.SetBondType(upgrade[bond.GetBondType()])
                        nb.SetNumRadicalElectrons(nb_rad - 1)
                        n_rad -= 1
            atom.SetNumRadicalElectrons(n_rad)
        n_rad = atom.GetNumRadicalElectrons()
        if n_rad > 0:
            atom.SetNumRadicalElectrons(0)
            atom.SetNumExplicitHs(atom.GetNumExplicitHs() + n_rad)
    return mol


def postprocess_rd_mol_2(mol):
    """3-ring repair + charge neutralization (reference
    `utils/sample_utils.py:679-715`): break the bond between two
    non-carbons in a 3-ring, split O-O 3-rings into diols, clear positive
    formal charges."""
    edit = Chem.RWMol(mol)
    rings = [set(r) for r in mol.GetRingInfo().AtomRings()]
    for ring in rings:
        if len(ring) != 3:
            continue
        non_c = [a for a in ring
                 if mol.GetAtomWithIdx(a).GetSymbol() != "C"]
        oxys = [a for a in ring
                if mol.GetAtomWithIdx(a).GetSymbol() == "O"]
        if len(non_c) == 2:
            edit.RemoveBond(*non_c)
        if len(oxys) == 2:
            edit.RemoveBond(*oxys)
            for o in oxys:
                a = edit.GetAtomWithIdx(o)
                a.SetNumExplicitHs(a.GetNumExplicitHs() + 1)
    mol = edit.GetMol()
    for atom in mol.GetAtoms():
        if atom.GetFormalCharge() > 0:
            atom.SetFormalCharge(0)
    return mol


def _perceive_with_openbabel(atomic_nums, xyz):
    """Bond perception via OpenBabel (gated); returns an RDKit Mol with
    perceived bonds or None. Behavioral stand-in for the reference's liGAN
    connect-the-dots pipeline using OB's native perception."""
    from openbabel import openbabel as ob
    obmol = ob.OBMol()
    obmol.BeginModify()
    for z, p in zip(atomic_nums, np.asarray(xyz)):
        a = obmol.NewAtom()
        a.SetAtomicNum(int(z))
        a.SetVector(float(p[0]), float(p[1]), float(p[2]))
    obmol.ConnectTheDots()
    obmol.PerceiveBondOrders()
    obmol.EndModify()
    conv = ob.OBConversion()
    conv.SetOutFormat("mol")
    block = conv.WriteString(obmol)
    mol = Chem.MolFromMolBlock(block, sanitize=False, removeHs=False)
    return mol


def _reconstruct_rdkit(mol_info: Dict, add_edge: str, check_validity: bool):
    atomic_nums = mol_info["element"]
    xyz = np.asarray(mol_info["atom_pos"])
    if add_edge == "predicted":
        if mol_info.get("bond_index") is None:
            raise ValueError("predicted mode requires bond information")
        bond_index = np.asarray(mol_info["bond_index"])
        bond_type = np.asarray(mol_info["bond_type"])
    elif add_edge == "distance":
        bond_index, bond_type = predict_bonds(atomic_nums, xyz)
        bond_index = np.asarray(bond_index).reshape(2, -1)
        bond_type = np.asarray(bond_type)
    elif add_edge == "openbabel":
        # liGAN-style perception (reference `utils/sample_utils.py:168-769`):
        # OpenBabel's ConnectTheDots + PerceiveBondOrders when OB is
        # importable, otherwise the toolkit-free re-derivation of the same
        # pipeline (`ligan_bonds.perceive`: connect-the-dots pruning,
        # hybridization-aware order perception, aromatic majority rule,
        # hypervalency downgrades).
        if HAVE_OPENBABEL:
            mol_ob = _perceive_with_openbabel(atomic_nums, xyz)
            if mol_ob is None:
                raise MolReconsError("openbabel perception failed")
            bonds = [(b.GetBeginAtomIdx(), b.GetEndAtomIdx(),
                      b.GetBondTypeAsDouble()) for b in mol_ob.GetBonds()]
            bond_index = np.asarray(
                [[i for i, j, _ in bonds] + [j for i, j, _ in bonds],
                 [j for i, j, _ in bonds] + [i for i, j, _ in bonds]],
                np.int64).reshape(2, -1)
            bond_type = np.asarray(
                [4 if o == 1.5 else int(o) for _, _, o in bonds] * 2,
                np.int64)
        else:
            from .ligan_bonds import perceive
            bond_index, bond_type = perceive(atomic_nums, xyz)
    else:
        raise ValueError(f"Invalid add_edge mode: {add_edge}")

    rd_mol = Chem.RWMol()
    conf = Chem.Conformer(len(atomic_nums))
    for i, z in enumerate(atomic_nums):
        rd_mol.AddAtom(Chem.Atom(int(z)))
        conf.SetAtomPosition(i, Geometry.Point3D(*[float(v) for v in xyz[i]]))
    rd_mol.AddConformer(conf)

    order_map = {1: Chem.BondType.SINGLE, 2: Chem.BondType.DOUBLE,
                 3: Chem.BondType.TRIPLE, 4: Chem.BondType.AROMATIC}
    for e in range(bond_index.shape[1]):
        i, j = int(bond_index[0][e]), int(bond_index[1][e])
        if i < j:
            t = int(bond_type[e])
            if t not in order_map:
                raise MolReconsError(f"unknown bond order {t}")
            rd_mol.AddBond(i, j, order_map[t])

    mol = rd_mol.GetMol()
    if add_edge == "openbabel":
        # liGAN conversion details (reference `utils/sample_utils.py:588-591,
        # 636-715`): quaternary N gets +1, then radical/3-ring repair
        for atom in mol.GetAtoms():
            if atom.GetAtomicNum() == 7 and atom.GetDegree() == 4:
                atom.SetFormalCharge(1)
        try:
            mol = postprocess_rd_mol_1(mol)
            mol = postprocess_rd_mol_2(mol)
        except Exception:
            raise MolReconsError("openbabel-mode postprocessing failed")
    if check_validity:
        RDLogger.logger().setLevel(RDLogger.CRITICAL)
        fixed = True
        try:
            Chem.SanitizeMol(mol)
        except Exception:
            fixed = False
        if not fixed:
            try:
                Chem.Kekulize(copy.deepcopy(mol))
            except Chem.rdchem.KekulizeException as e:
                if "Unkekulized" in e.args[0]:
                    mol, fixed = fix_aromatic(mol)
        if not fixed:
            mol, fixed = fix_valence(mol)
        if not fixed:
            mol, fixed = fix_aromatic(mol, True)
        try:
            Chem.SanitizeMol(mol)
        except Exception:
            raise MolReconsError()
    return mol


def _reconstruct_simple(mol_info: Dict, add_edge: str, check_validity: bool):
    atomic_nums = list(mol_info["element"])
    xyz = np.asarray(mol_info["atom_pos"])
    if add_edge == "predicted":
        bond_index = mol_info.get("bond_index")
        bond_type = mol_info.get("bond_type")
        if bond_index is None:
            raise ValueError("predicted mode requires bond information")
        bond_index = np.asarray(bond_index).reshape(2, -1)
        bond_type = np.asarray(bond_type)
    elif add_edge == "distance":
        bi, bt = predict_bonds(atomic_nums, xyz)
        bond_index = np.asarray(bi).reshape(2, -1)
        bond_type = np.asarray(bt)
    elif add_edge == "openbabel":
        from .ligan_bonds import perceive
        bond_index, bond_type = perceive(atomic_nums, xyz)
    else:
        raise MolReconsError(f"backend cannot do add_edge={add_edge}")
    mol = SimpleMol(atomic_nums, xyz, bond_index, bond_type)
    if check_validity and not sanitize_simple(mol):
        raise MolReconsError("valence check failed")
    return mol


def reconstruct_from_generated_with_edges(mol_info: Dict,
                                          add_edge: str = "predicted",
                                          check_validity: bool = True):
    """Reconstruct one molecule; raises MolReconsError on failure."""
    if len(mol_info["element"]) == 0:
        raise MolReconsError("empty molecule")
    if HAVE_RDKIT:
        return _reconstruct_rdkit(mol_info, add_edge, check_validity)
    return _reconstruct_simple(mol_info, add_edge, check_validity)


def mol_is_connected(mol) -> bool:
    if isinstance(mol, SimpleMol):
        return is_connected(mol)
    if HAVE_RDKIT:
        from rdkit import Chem as C
        smiles = C.MolToSmiles(mol)
        return smiles is not None and "." not in smiles
    return False


def recon_task(info: Dict, add_edge: str):
    """Process-pool unit of work: reconstruction + acceptance for one
    decoded molecule — (True, (mol, smiles)) or (False, reason).

    Lives in this jax-free module so spawned reconstruction workers
    (`GenerationPipeline(recon_workers=...)`) never initialize a JAX
    backend; SimpleMol and RDKit Mol both pickle."""
    from .chem import mol_to_smiles
    try:
        mol = reconstruct_from_generated_with_edges(info, add_edge=add_edge)
        smiles = mol_to_smiles(mol)
        if smiles is None or "." in smiles:
            raise MolReconsError("disconnected molecule")
        return True, (mol, smiles)
    except MolReconsError as e:
        return False, str(e)
