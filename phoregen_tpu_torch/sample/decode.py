"""Decode padded sampler outputs into per-molecule atom/bond lists.

Parity target: `unbatch_data` + `decode_data`
(reference `utils/sample_utils.py:57-132`): argmax types, drop mask-class
atoms with bond reindexing, keep bond classes 1..4. The padded layout makes
unbatching a simple mask slice instead of segment bookkeeping.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..constants import (ATOMIC_NUMBERS, NUM_ELEMENT_CLASSES,
                         NUM_REAL_BOND_TYPES)


def decode_batch(pred_node: np.ndarray, pred_pos: np.ndarray,
                 pred_edge: Optional[np.ndarray], lig_mask: np.ndarray,
                 include_bond: bool = True) -> List[Dict]:
    """Split a padded sampling batch into per-molecule dicts.

    Args:
      pred_node: [B, NL, Ka] logits. pred_pos: [B, NL, 3].
      pred_edge: [B, NL, NL, Kb] logits or None. lig_mask: [B, NL] bool.
    Returns list of dicts with 'element', 'atom_pos', 'bond_index' (2 x E,
    directed i<j kept once each way), 'bond_type'.
    """
    pred_node = np.asarray(pred_node)
    pred_pos = np.asarray(pred_pos)
    lig_mask = np.asarray(lig_mask)
    if pred_edge is not None:
        pred_edge = np.asarray(pred_edge)

    out = []
    B = pred_node.shape[0]
    for b in range(B):
        valid = lig_mask[b]
        atom_type = pred_node[b].argmax(-1)
        keep = valid & (atom_type < NUM_ELEMENT_CLASSES)  # drop mask-class
        idx = np.nonzero(keep)[0]
        new_index = -np.ones(pred_node.shape[1], np.int64)
        new_index[idx] = np.arange(len(idx))

        element = [ATOMIC_NUMBERS[t] for t in atom_type[idx]]
        atom_pos = pred_pos[b][idx]

        bond_index, bond_type = None, None
        if include_bond and pred_edge is not None:
            etype = pred_edge[b].argmax(-1)               # [NL, NL]
            src, dst = np.nonzero(
                valid[:, None] & valid[None, :]
                & ~np.eye(len(valid), dtype=bool)
                & (etype > 0) & (etype < NUM_REAL_BOND_TYPES))
            bt = etype[src, dst]
            src, dst = new_index[src], new_index[dst]
            ok = (src >= 0) & (dst >= 0)
            bond_index = np.stack([src[ok], dst[ok]])
            bond_type = bt[ok]
        out.append({
            "element": element,
            "atom_pos": atom_pos,
            "bond_index": bond_index,
            "bond_type": bond_type,
        })
    return out
