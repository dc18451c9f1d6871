"""Share of the traced training window in which no device operation
ran, %: one minus the union of the device events' intervals over the
window. Moves `train_graphs_per_s`."""
from portbench import trace


def read(rec):
    if rec.get("kind") != "train" or not rec.get("dev"):
        return None
    w = trace.window_us(rec["dev"])
    return 100.0 * (1.0 - trace.busy_us(rec["dev"]) / w)
