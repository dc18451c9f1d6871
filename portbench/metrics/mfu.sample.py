"""The whole sampling step's share of the chip's TF32 tensor-core peak,
%: the network's operations a step (`workcount.network_ops`, counted
from the shapes) times the traced steps, over the traced window's length
on the device's clock (first kernel's start to last kernel's end). Moves
`sample_mol_per_s`."""
from portbench import trace


def read(rec):
    if rec.get("kind") != "sample" or not rec.get("dev"):
        return None
    w = trace.window_us(rec["dev"]) / 1e6
    ops = rec["ops_per_step"] * rec["traced_steps"]
    return 100.0 * ops / w / rec["peaks"]["tf32_flops_per_s"]
