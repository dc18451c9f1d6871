"""Host ms a train step spends in the program's input spans:
`data.batch` (the loader's batch assembly) and `data.to_device`
(`PhoreGraphBatch.to`), over the traced steps; the in-program
counterpart of `data_ms.train`. Nothing where the program has no such
span. Moves `train_graphs_per_s`."""
from portbench import spans


def read(rec):
    if rec.get("kind") != "train" or not rec.get("host"):
        return None
    us = spans.total_us(rec["host"], ("data.batch", "data.to_device"))
    if not us:
        return None
    return us / rec["traced_steps"] / 1e3
