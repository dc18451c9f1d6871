"""Per-atom pharmacophore fingerprints from SMARTS matching (RDKit-gated).

Counterpart of `phoregen_tpu/data/phorefp.py` (reference
`datasets/generate_phorefp.py:11-215`): each heavy atom gets a binary
vector over the 13-type vocabulary (MB, HD, AR, PO, HA, HY, NE, CV1-4, XB,
EX) marking which pharmacophore roles it can play; the four
covalent-warhead classes distinguish the nucleophile they react with
(CV1: thiol/SH, CV2: hydroxyl/OH, CV3: amine/NH2, CV4: carboxylate/COOH).
EX (exclusion volume) is never atom-derived.

The SMARTS table is the JAX package's, pattern for pattern. The compiled
patterns are cached on first use (`_compiled`); reloading the module
clears the cache, so it is rebuilt against the toolkit in place.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..constants import PHORETYPES_13

try:
    from rdkit import Chem
    HAVE_RDKIT = True
except Exception:  # pragma: no cover
    Chem = None
    HAVE_RDKIT = False

# type -> list of (SMARTS, indices-into-match that carry the feature)
PHORE_PATTERNS: Dict[str, List] = {
    # hydrogen-bond donor: N/O/S bearing at least one H, not anionic
    "HD": [("[$([N;!H0;v3,v4&+1]),$([O,S;H1;+0]),$([n&H1&+0])]", (0,))],
    # hydrogen-bond acceptor: O/S lone pairs, sp2/sp3 N not amide-like,
    # aromatic n/o/s
    "HA": [
        ("[$([O,S;H1;v2]-[!$(*=[O,N,P,S])])]", (0,)),
        ("[$([O,S;H0;v2]),$([O,S;-])]", (0,)),
        ("[$([N;v3;!$(N-*=[O,N,P,S])]);!$([N;H0;X3](c)(c)c)]", (0,)),
        ("[nH0,o;+0]", (0,)),
    ],
    # aromatic ring atoms (ring centroid features come from grouping)
    "AR": [("[a;r5,r6]", (0,))],
    # hydrophobe: carbons with no polar neighbors, halogens on carbon
    "HY": [
        ("[C;D3,D4;!$(C~[#7,#8,#9,#15,#16])]", (0,)),
        ("[C;D1,D2;$(C(-[C,S])(-[C,S]))]", (0,)),
        ("[CH3]-[C,N,S,O]", (0,)),
        ("[F,Cl,Br,I;$(*-c)]", (0,)),
        ("[S;D2;$(S(C)C)]", (0,)),
    ],
    # cationic / positive ionizable
    "PO": [
        ("[+;!$([N+]~[O-])]", (0,)),
        ("[$(N-C(=N)-N)]", (0,)),   # guanidinium carbon's N
        ("[NX3;H2;$(N-[CX4])]", (0,)),
    ],
    # anionic / negative ionizable
    "NE": [
        ("[CX3](=O)[O;H1,-1]", (1, 2)),
        ("[SX4](=O)(=O)[O;H1,-1]", (1, 2, 3)),
        ("[PX4](=O)([O;H1,-1])[O;H1,-1]", (1, 2, 3)),
        ("[SX3](=O)[O;H1,-1]", (1, 2)),
    ],
    # halogen-bond donor: Cl/Br/I sigma-hole on aromatic or sp3 carbon
    "XB": [("[Cl,Br,I;X1][#6]", (0,))],
    # metal binder: chelating O/N/S motifs
    "MB": [
        ("[O;H1,H0;-0,-1]-[P,S](=O)", (0,)),
        ("[CX3](=O)[O;H1,-1]", (1, 2)),
        ("[SX2;H1,H0]", (0,)),
        ("[N;v3;!$(N-C=[O,N,S])]", (0,)),
        ("[O;H1]-[cX3]", (0,)),
        ("[#34;H1]", (0,)),
    ],
    # covalent warheads by reactive partner (labels 1-4)
    "CV1": [  # thiol-reactive: Michael acceptors, haloacetamides
        ("[CX3]=[CX3]-[CX3]=[O]", (0, 1)),
        ("C(=O)-[CH2]-[Cl,Br,I]", (2,)),
        ("[CX3](=O)-C#N", (2, 3)),
        ("[CX2]#[CX2]-[CX3]=O", (0, 1)),
    ],
    "CV2": [  # hydroxyl-reactive: boronates, sulfonyl fluorides, esters
        ("[BX3](-O)(-O)", (0,)),
        ("[SX4](=O)(=O)F", (0, 3)),
        ("C(=O)-O-[CH3,$([CH2])]", (0,)),
    ],
    "CV3": [  # amine-reactive: aldehydes, epoxides, isocyanates
        ("[CX3H1]=O", (0,)),
        ("C1OC1", (0, 1, 2)),
        ("N=C=O", (1,)),
    ],
    "CV4": [  # carboxylate-reactive: halomethyl ketones, nitriles
        ("[CX3](=O)-[CH2]-F", (2,)),
        ("[CX2]#N", (0,)),
    ],
}


_COMPILED: Optional[Dict[str, List]] = None


def _compiled():
    global _COMPILED
    if _COMPILED is None:
        if not HAVE_RDKIT:
            raise ImportError("RDKit required for phore fingerprints")
        _COMPILED = {
            t: [(Chem.MolFromSmarts(s), idxs) for s, idxs in pats]
            for t, pats in PHORE_PATTERNS.items()}
    return _COMPILED


def generate_ligand_phore_feat(mol, remove_hs: bool = True) -> np.ndarray:
    """Mol -> [n_atoms, 13] binary fingerprint over PHORETYPES_13.

    The EX column (last) is always zero — exclusion volumes are synthesized
    from receptor/solvent context, never from ligand atoms.
    """
    if not HAVE_RDKIT:
        raise ImportError("RDKit required for phore fingerprints")
    if remove_hs:
        mol = Chem.RemoveHs(mol)
    n = mol.GetNumAtoms()
    fp = np.zeros((n, len(PHORETYPES_13)), np.float32)
    col = {t: i for i, t in enumerate(PHORETYPES_13)}
    for ptype, pats in _compiled().items():
        c = col[ptype]
        for patt, idxs in pats:
            if patt is None:
                continue
            for match in mol.GetSubstructMatches(patt):
                for k in idxs:
                    if k < len(match):
                        fp[match[k], c] = 1.0
    return fp


def aromatic_ring_centers(mol) -> List[np.ndarray]:
    """Centroids of aromatic rings (AR feature points)."""
    conf = mol.GetConformer()
    pos = np.asarray(conf.GetPositions())
    out = []
    ri = mol.GetRingInfo()
    for ring in ri.AtomRings():
        if all(mol.GetAtomWithIdx(i).GetIsAromatic() for i in ring):
            out.append(pos[list(ring)].mean(axis=0))
    return out
