"""Host ms a train step spends in the benchmark's span around the
loader's next batch and its `.to(device)`, mean over the traced run's
window. Moves `train_graphs_per_s`."""


def read(rec):
    ms = rec.get("data_ms") if rec.get("kind") == "train" else None
    if not ms:
        return None
    return sum(ms) / len(ms)
