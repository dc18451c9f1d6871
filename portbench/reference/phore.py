"""`.phore` file format: parser (both norm conventions) and writer.

Format (reference `datasets/get_phore_data.py:24-73`): a title line, then
TSV rows `type alpha weight factor x y z has_norm nx ny nz label
anchor_weight`, terminated by `$$$$`. 'CR' rows are skipped; 'CV' rows are
split into CV1-4 by the first character of `label` under the 13-type
vocabulary.

Norm conventions:
- new (`PhoreData_New`): unit-normalize the raw norm vector.
- legacy (`PhoreData`): norm = normalize(norm - pos) (treating the stored
  vector as an absolute point), reference `get_phore_data.py:163-168`.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple

import numpy as np

from .constants import phore_type_vocab


@dataclasses.dataclass
class PhoreFeature:
    type: str
    alpha: float
    weight: float
    factor: float
    pos: Tuple[float, float, float]
    has_norm: bool
    norm: Tuple[float, float, float]
    label: str
    anchor_weight: float


@dataclasses.dataclass
class Phore:
    name: str
    features: List[PhoreFeature]


def parse_phore_text(text: str, name: str = "") -> Phore:
    lines = text.strip().splitlines()
    title = lines[0].strip() if lines else name
    feats = []
    for record in lines[1:]:
        record = record.strip()
        if record == "$$$$":
            break
        if not record:
            continue
        try:
            (ptype, alpha, weight, factor, x, y, z, has_norm,
             nx, ny, nz, label, anchor_weight) = record.split("\t")
        except ValueError:
            print(f"[E]: Failed to parse the line:\n {record}")
            continue
        feats.append(PhoreFeature(
            type=ptype, alpha=float(alpha), weight=float(weight),
            factor=float(factor), pos=(float(x), float(y), float(z)),
            has_norm=bool(int(has_norm)),
            norm=(float(nx), float(ny), float(nz)), label=label,
            anchor_weight=float(anchor_weight)))
    return Phore(name=title or name, features=feats)


def parse_phore_file(path: str) -> Phore:
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"The specified pharmacophore file (*.phore) is not found: `{path}`")
    with open(path) as f:
        return parse_phore_text(
            f.read(), os.path.splitext(os.path.basename(path))[0])


def featurize_phore(phore: Phore, data_name: str = "zinc_300",
                    norm_mode: str = "new"):
    """Phore -> (features [n, FP], pos [n, 3], norm [n, 3], center [3]).

    Feature layout: [one-hot type, alpha, one-hot(has_norm, 2),
    one-hot(is_EX, 2)]  => dim = n_types + 5
    (reference `get_phore_data.py:55-68`). CR rows skipped; CV split by label
    under the 13-type vocabulary. Positions are NOT centered here — see
    `center_pair`.
    """
    vocab = phore_type_vocab(data_name)
    tindex = {t: i for i, t in enumerate(vocab)}
    split_cv = "CV1" in vocab

    types, alphas, poss, has_norms, norms = [], [], [], [], []
    for f in phore.features:
        ptype = f.type
        if ptype == "CR":
            continue
        if ptype == "CV" and split_cv:
            ptype = "CV" + f.label[0]
        if ptype not in tindex:
            print(f"[E]: Unknown phore type `{ptype}`")
            continue
        types.append(tindex[ptype])
        alphas.append(f.alpha)
        poss.append(f.pos)
        has_norms.append(int(f.has_norm))
        norms.append(f.norm)

    n = len(types)
    n_types = len(vocab)
    onehot = np.zeros((n, n_types), np.float32)
    onehot[np.arange(n), types] = 1.0
    is_ex = onehot[:, -1].astype(np.int64)  # EX is always the last type
    ex_onehot = np.zeros((n, 2), np.float32)
    ex_onehot[np.arange(n), is_ex] = 1.0
    hn = np.zeros((n, 2), np.float32)
    hn[np.arange(n), np.asarray(has_norms)] = 1.0
    alpha = np.asarray(alphas, np.float32)[:, None]

    pos = np.asarray(poss, np.float32)
    raw_norm = np.asarray(norms, np.float32)
    if norm_mode == "new":
        mag = np.linalg.norm(raw_norm, axis=-1, keepdims=True)
        unit = np.where(mag > 0, raw_norm / np.where(mag == 0, 1, mag), 0.0)
    elif norm_mode == "legacy":
        # treat stored norm as an absolute point; direction = norm - pos,
        # except all-zero norm rows (no-norm features) which stay zero
        # (reference `get_phore_data.py:163-168`) — the row test must be
        # per feature, not per component
        has = ~np.all(raw_norm == 0, axis=-1, keepdims=True)
        direction = np.where(has, raw_norm - pos, 0.0)
        mag = np.linalg.norm(direction, axis=-1, keepdims=True)
        unit = np.where(mag > 0, direction / np.where(mag == 0, 1, mag),
                        direction)
    else:
        raise ValueError(norm_mode)

    feats = np.concatenate([onehot, alpha, hn, ex_onehot], axis=-1)
    center = pos.mean(axis=0) if n else np.zeros(3, np.float32)
    return feats.astype(np.float32), pos, unit.astype(np.float32), \
        center.astype(np.float32)


def write_phore_file(phore: Phore, path: str) -> None:
    """Write the TSV format back (reference `utils/phore_utils.py:659-679`)."""
    with open(path, "w") as f:
        f.write(phore.name + "\n")
        for ft in phore.features:
            row = [ft.type, _fmt(ft.alpha), _fmt(ft.weight), _fmt(ft.factor),
                   _fmt(ft.pos[0]), _fmt(ft.pos[1]), _fmt(ft.pos[2]),
                   str(int(ft.has_norm)),
                   _fmt(ft.norm[0]), _fmt(ft.norm[1]), _fmt(ft.norm[2]),
                   str(ft.label), _fmt(ft.anchor_weight)]
            f.write("\t".join(row) + "\n")
        f.write("$$$$\n")


def _fmt(x: float) -> str:
    # the reference emits "%.3f" for every float field
    # (`utils/phore_utils.py:665`, "{x:.3f}") — byte-identical output
    # matters for AncPhore interop; parity pinned by
    # tests/test_phore_writer_parity.py
    return f"{x:.3f}"
