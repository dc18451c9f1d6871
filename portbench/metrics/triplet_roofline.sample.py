"""The dense triplet bond update against its roofline, %: the least time
the chip could take for a step's dense bond layers (per layer the larger
of bytes over HBM bandwidth and operations over the TF32 tensor-core
rate, on real atoms, bonds and triplets only, every term hoisted off the
triplets that can be: `workcount_dense.roofline_s`) over the device ms a
step inside the program's `bond.triplet` span. Nothing without that span
or outside a dense cell. Moves `sample_mol_per_s`."""


def read(rec):
    if rec.get("kind") != "sample" or \
            rec.get("triplet_roofline_s_per_step") is None:
        return None
    ms = rec.get("span_dev_ms", {}).get("bond.triplet")
    if not ms:
        return None
    return 100.0 * rec["triplet_roofline_s_per_step"] * 1e3 / ms
