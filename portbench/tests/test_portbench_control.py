"""The control of `correct` at a size a test run holds: the plain
reference in the program's place, its matrix products one precision below
what the configuration states (TF32 for the float32 sampling, e4m3 fp8 for
the bf16 training), fails at least one of the cell's numbers against the
cell's limits, while the program passes them. On the card the same
readings come from `python3 -m portbench.control`."""
import pytest

from portbench import control, harness
from portbench.kinds import finetune
from portbench.reference.precision import BITS, round_mantissa

from .small import small_cell


def test_round_mantissa():
    import torch
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -3.0,
                      1.0 + 2.0 ** -20])
    got = round_mantissa(x, 10)
    assert got.tolist() == [1.0 + 2.0 ** -10, 1.0 + 2 * 2.0 ** -10, -3.0,
                            1.0]


@pytest.mark.parametrize("name", ["sample-lig-module", "sample-cpx-pallas"])
def test_sampling_control_fails(name):
    edits = {} if name == "sample-lig-module" else \
        {"model.denoiser.fused_stack": "xla"}
    cell = small_cell(name, **edits)
    row = next(control.sample_readings(cell, [2**31 + 5], 0, "cpu",
                                       BITS["tf32"], steps_override=3))
    assert harness.judge(row["program"], cell.limits)[0], row
    assert not harness.judge(row["control"], cell.limits)[0], row


def test_training_control_fails():
    cell = small_cell("train-cpx-pallas",
                      **{"model.denoiser.fused_stack": "xla"})
    row = next(finetune.readings(cell, [2**32 + 9], "cpu",
                                 BITS["fp8_e4m3"]))
    assert harness.judge(row["program"], cell.limits)[0], row
    assert not harness.judge(row["control"], cell.limits)[0], row
