"""Global vocabulary and geometry constants.

Parity notes (reference = ppjian19/PhoreGen, mounted read-only):
- Atom-class vocabulary: 11 heavy elements + trailing mask class
  (reference `models/model_utils.py:18`, `models/diffusion.py:24`).
- Bond-class vocabulary: none/single/double/triple/aromatic + trailing mask
  (reference `models/diffusion.py:25`).
- Pharmacophore type vocabularies: 11-type and 13-type (CV split into CV1-4)
  (reference `datasets/get_phore_data.py:8-9`).
- Molecule size bounds 4..78 heavy atoms (reference `models/diffusion.py:30-31`).
"""

# Heavy-atom element vocabulary, index == class id. The trailing class is the
# absorbing "mask" state used by the to-mask categorical diffusion.
ATOMIC_NUMBERS = (5, 6, 7, 8, 9, 14, 15, 16, 17, 35, 53)  # B C N O F Si P S Cl Br I
NUM_ELEMENT_CLASSES = len(ATOMIC_NUMBERS)          # 11 real classes
NUM_ATOM_CLASSES = NUM_ELEMENT_CLASSES + 1         # 12 with mask class (last)
ATOM_MASK_CLASS = NUM_ATOM_CLASSES - 1

ELEMENT_SYMBOLS = {
    5: "B", 6: "C", 7: "N", 8: "O", 9: "F", 14: "Si",
    15: "P", 16: "S", 17: "Cl", 35: "Br", 53: "I",
}
SYMBOL_TO_ATOMIC_NUMBER = {v: k for k, v in ELEMENT_SYMBOLS.items()}

# Bond classes: 0 = no bond (absorbing state for 'absorb' prior), 1..4 =
# single/double/triple/aromatic, 5 = mask.
NUM_BOND_CLASSES = 6
BOND_NONE = 0
BOND_AROMATIC = 4
BOND_MASK_CLASS = NUM_BOND_CLASSES - 1
NUM_REAL_BOND_TYPES = 5  # classes 0..4 are "real" (incl. no-bond)

# Pharmacophore feature-point vocabularies. 'EX' (exclusion volume) is always
# last; 'CR' rows are skipped by the parser.
PHORETYPES = ("MB", "HD", "AR", "PO", "HA", "HY", "NE", "CV", "CR", "XB", "EX")
PHORETYPES_11 = ("MB", "HD", "AR", "PO", "HA", "HY", "NE", "CV", "XB", "EX")  # post-CR-skip classes stay indexed by PHORETYPES
PHORETYPES_13 = ("MB", "HD", "AR", "PO", "HA", "HY", "NE",
                 "CV1", "CV2", "CV3", "CV4", "XB", "EX")

# Datasets that use the 13-type (CV-split) vocabulary; drives the
# `phore_feat_dim += 2` load-time mutation (reference `run/logger.py:96-98`)
# and the EX-column index 12-vs-10 convention
# (reference `models/diffusion.py:152-155`).
CV_SPLIT_DATASETS = ("zinc_300", "pdbbind")

# Molecule size bounds (reference `models/diffusion.py:30-31`).
MIN_ATOMS = 4
MAX_ATOMS = 78

# Fixed non-uniform RBF offset grid used by the bond/triplet distance
# expansion (reference `models/common.py:18`).
FIXED_RBF_OFFSETS = (
    0.0, 1.0, 1.25, 1.5, 1.75, 2.0, 2.25, 2.5, 2.75, 3.0,
    3.5, 4.0, 4.5, 5.0, 5.5, 6.0, 7.0, 8.0, 9.0, 10.0,
)


def phore_type_vocab(data_name: str):
    """Return the phore-type vocabulary tuple for a dataset name."""
    return PHORETYPES_13 if data_name in CV_SPLIT_DATASETS else PHORETYPES


def phore_ex_column(data_name: str) -> int:
    """One-hot column marking an exclusion volume in the phore feature vector.

    Reference hardcodes x[:, 12] for the 13-type vocabulary and x[:, 10] for the
    11-type one (`models/diffusion.py:152-155`, `:493-496`). With the 11-type
    vocabulary the parser emits one-hot over the full PHORETYPES (len 11, CR
    unused), whose last column (index 10) is EX.
    """
    return 12 if data_name in CV_SPLIT_DATASETS else 10


def phore_feat_dim(data_name: str) -> int:
    """Phore feature dim: one-hot(types) + alpha(1) + has_norm(2) + is_EX(2).

    16 for the 11-type vocabulary, 18 for the 13-type one — matching the
    reference's `phore_feat_dim: 16` config plus the `+2` load-time rule
    (`run/logger.py:96-98`).
    """
    n_types = 13 if data_name in CV_SPLIT_DATASETS else 11
    return n_types + 1 + 2 + 2
