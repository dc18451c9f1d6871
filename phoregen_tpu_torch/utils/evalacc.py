"""Discriminative per-element eval accuracies for quality artifacts.

Counterpart of `phoregen_tpu/utils/evalacc.py`: the eval-mode metrics of
a network's current parameters over held-out `mixed`-corpus batches (the
reference's train-time accuracies, `models/common.py:284-297`, extended
with per-element means, `models/phoregen.py::element_accuracy`).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

ACC_KEYS = ("loss", "node_acc", "node_elem_acc", "edge_acc",
            "edge_elem_acc", "count_hit")


def eval_accuracies(pg, cfg, seed: int = 9999, n_batches: int = 4,
                    batch_size: int = 16, device=None,
                    draws: Optional[Callable] = None) -> Dict[str, float]:
    """Mean eval-mode metrics of `pg.net`'s parameters over
    `n_batches * batch_size` samples of `mixed_corpus(seed)` (a seed
    stream disjoint from the training streams), each batch's duplicates
    of a cycled tail masked out, rounded to 4 places. `device`: where the
    batches go (None: the network's device). `draws`: batch -> dict of
    `PhoreGen.perturb`'s draws for that batch, injected into the eval
    step in place of its generator's (tests hand the port the JAX
    package's)."""
    import numpy as np
    import torch

    from ..data.loader import PhoreDataLoader
    from ..data.realcorpus import mixed_corpus
    from ..train.step import make_eval_step

    if device is None:
        device = next(pg.net.parameters()).device
    eval_fn = make_eval_step(pg, cfg)
    data = mixed_corpus(seed, n_batches * batch_size)
    loader = PhoreDataLoader(data, cfg, batch_size, shuffle=False)
    tot: Dict[str, float] = {}
    n = 0
    for vb, real in loader.iter_with_sizes():
        vb = vb.to(device)
        gmask = torch.arange(loader.batch_size, device=device) < real
        m = eval_fn(np.uint32(seed), vb, gmask,
                    **(draws(vb) if draws is not None else {}))
        for k in ACC_KEYS:
            if k in m:
                tot[k] = tot.get(k, 0.0) + float(m[k]) * real
        n += real
    return {k: round(v / max(n, 1), 4) for k, v in tot.items()}
