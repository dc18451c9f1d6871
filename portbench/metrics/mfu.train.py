"""The whole train step's share of the chip's bf16 tensor-core peak (the
configuration trains in bf16), %: three times the forward's operations
(`workcount.network_ops` on each traced batch's atom counts; the backward
counted as twice the forward) over the traced window's length on the
device's clock. Moves `train_graphs_per_s`."""
from portbench import trace


def read(rec):
    if rec.get("kind") != "train" or not rec.get("dev"):
        return None
    w = trace.window_us(rec["dev"]) / 1e6
    return 100.0 * 3.0 * rec["forward_ops"] / w / \
        rec["peaks"]["bf16_flops_per_s"]
