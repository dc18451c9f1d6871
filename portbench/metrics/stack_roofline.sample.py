"""The fused stack's stage kernels against their roofline, %: the least
time the chip could take for the traced steps' attention stages (per
stage call the larger of bytes over HBM bandwidth and operations over the
TF32 tensor-core rate, `workcount.stack_roofline_s`) over the summed
device time of the kernels the stages launch, matched by name. Nothing
on a path without stage kernels. Moves `sample_mol_per_s`."""
from portbench import trace

# the layer-stack kernels of `phoregen_tpu_torch/csrc/layer_stack.cu`
FRAGMENTS = ("node_kernel", "node_pre_kernel", "trip_pre_kernel",
             "trip_att_kernel", "pos_kernel", "att_pos_kernel",
             "pos_query_kernel", "rows_gemm")


def read(rec):
    if rec.get("kind") != "sample" or not rec.get("dev") or \
            rec.get("stack_roofline_s_per_step") is None:
        return None
    t = trace.kernel_time_us(rec["dev"], FRAGMENTS) / 1e6
    if t <= 0:
        return None
    return 100.0 * rec["stack_roofline_s_per_step"] * rec["traced_steps"] / t
