"""Host ms a train step spends in the program's `train.backward` span
(`loss.backward()` and the gradients' reduction over ranks), over the
traced steps. Nothing where the program has no such span. Moves
`train_graphs_per_s`."""
from portbench import spans


def read(rec):
    if rec.get("kind") != "train" or not rec.get("host"):
        return None
    us = spans.total_us(rec["host"], "train.backward")
    if not us:
        return None
    return us / rec["traced_steps"] / 1e3
