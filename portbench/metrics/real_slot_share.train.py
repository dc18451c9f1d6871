"""Share of the ligand slots of the run's training batches that hold
atoms, %: the program's `SLOTS` counter (`data/batching.py`, counted where
the loader pads a batch to its bucket), over the whole run. Nothing where
the program has no such counter. Moves `train_graphs_per_s`."""


def read(rec):
    if rec.get("kind") != "train":
        return None
    from phoregen_tpu_torch.data import batching
    slots = getattr(batching, "SLOTS", None)
    if not slots or not slots["lig_slots"]:
        return None
    return 100.0 * slots["lig_real"] / slots["lig_slots"]
