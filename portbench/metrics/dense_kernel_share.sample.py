"""Share of the dense triplet bond update's calls that ran the program's
CUDA kernel (`csrc/dense_triplet.cu`), %: the program's counter
`DENSE_TRIP` (`models/layers.py`), kernel calls over kernel and plain
calls, over the whole run. Nothing where the program has no such counter
or no dense call ran. Moves `sample_mol_per_s`."""


def read(rec):
    if rec.get("kind") != "sample":
        return None
    from phoregen_tpu_torch.models import layers
    counts = getattr(layers, "DENSE_TRIP", None)
    if not counts:
        return None
    n = counts["kernel"] + counts["plain"]
    if not n:
        return None
    return 100.0 * counts["kernel"] / n
