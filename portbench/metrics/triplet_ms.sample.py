"""Device ms a sampling step spends inside the program's `bond.triplet`
span (the bond update, six calls a step): the device's busy time inside
the span's device-side ranges (`devspans.py`), over the traced steps.
Nothing where the program has no such span. Moves `sample_mol_per_s`."""


def read(rec):
    if rec.get("kind") != "sample":
        return None
    return rec.get("span_dev_ms", {}).get("bond.triplet")
