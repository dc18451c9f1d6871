"""`cap_phore` from `phoregen_tpu/data/realcorpus.py` (the only part of the
hermetic-corpus module that sampling needs)."""
from __future__ import annotations

import numpy as np

from .phore import Phore


def cap_phore(phore: Phore, max_points: int,
              rng: np.random.Generator) -> Phore:
    """Fit a phore into `max_points` slots: keep every typed (non-EX)
    feature, random-subsample EX volumes. EX points are soft repulsion
    markers (the reference itself synthesizes them stochastically,
    `utils/phore_utils.py:455-536`), so dropping a subset preserves the
    conditioning semantics while giving the TPU pipeline a static shape."""
    non_ex = [f for f in phore.features if f.type != "EX"]
    ex = [f for f in phore.features if f.type == "EX"]
    budget = max_points - len(non_ex)
    if budget < 0:  # pathological: more typed features than slots
        keep = rng.choice(len(non_ex), size=max_points, replace=False)
        return Phore(phore.name, [non_ex[i] for i in sorted(keep)])
    if len(ex) > budget:
        keep = rng.choice(len(ex), size=budget, replace=False)
        ex = [ex[i] for i in sorted(keep)]
    return Phore(phore.name, non_ex + ex)
