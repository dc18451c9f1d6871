"""Device operations (kernels, copies, sets) launched a sampling step,
counted in the profiler's window. Moves `sample_mol_per_s`."""


def read(rec):
    if rec.get("kind") != "sample" or not rec.get("dev"):
        return None
    return len(rec["dev"]) / rec["traced_steps"]
