"""Host ms a sampling step spends enqueuing: the program's `sample.step`
span, less the time of the synchronizing runtime calls that begin inside
it, mean over the traced steps. Nothing where the program has no such
span. Moves `sample_mol_per_s`."""
from portbench import spans


def read(rec):
    if rec.get("kind") != "sample" or not rec.get("host"):
        return None
    steps = spans.named(rec["host"], "sample.step")
    if not steps:
        return None
    waits = spans.inside_us(rec["host"], steps, spans.SYNC)
    busy = sum(e - s - w for (_, s, e), w in zip(steps, waits))
    return busy / len(steps) / 1e3
