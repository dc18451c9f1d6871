"""Share of the ligand slots of the run's sampling pools that hold atoms,
%: the program's `SLOTS` counter (`data/batching.py`, counted where
`replicate_phore` pads the pool to its bucket), over the whole run.
Nothing where the program has no such counter. Moves
`sample_mol_per_s`."""


def read(rec):
    if rec.get("kind") != "sample":
        return None
    from phoregen_tpu_torch.data import batching
    slots = getattr(batching, "SLOTS", None)
    if not slots or not slots["lig_slots"]:
        return None
    return 100.0 * slots["lig_real"] / slots["lig_slots"]
