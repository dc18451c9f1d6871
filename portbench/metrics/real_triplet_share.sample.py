"""Share of the directed triplets (k, j, i) of distinct ligand slots of
the run's sampling pools that are triplets of three atoms, %: the
program's `SLOTS` counter (`data/batching.py`, `trip_real` over
`trip_slots`, counted where `replicate_phore` pads the pool to its
bucket), over the whole run. Nothing where the program has no such
counter. Moves `sample_mol_per_s`."""


def read(rec):
    if rec.get("kind") != "sample":
        return None
    from phoregen_tpu_torch.data import batching
    slots = getattr(batching, "SLOTS", None)
    if not slots or not slots.get("trip_slots"):
        return None
    return 100.0 * slots["trip_real"] / slots["trip_slots"]
