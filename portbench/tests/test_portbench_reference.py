"""The plain reference against the program's own paths at a small size on
the CPU, through the harness's run (set-up, window, check): the module
path's sampling step, the fused stack's mathematics (its plain stages,
`xla`, kNN frozen per block) and a float32 train step."""
import time

import pytest

from portbench.kinds import finetune, sample_pools

from .small import small_cell


def test_sampling_module_path_equals_the_reference():
    cell = small_cell("sample-lig-module")
    out = sample_pools.run(cell, 2**31 + 17, 0, False, "cpu",
                           time.perf_counter(), steps_override=3)
    assert set(out["values"]) == {"net_err", "post_err", "choice_mismatch",
                                  "pos_err"}
    # the same operations on the same shapes as the copied module path
    assert out["values"] == {k: 0.0 for k in out["values"]}
    assert out["correct"] and out["failed"] == 0


def test_sampling_fused_stack_mathematics_equal_the_reference():
    cell = small_cell("sample-cpx-pallas",
                      **{"model.denoiser.fused_stack": "xla"})
    out = sample_pools.run(cell, 2**33 + 5, 0, False, "cpu",
                           time.perf_counter(), steps_override=2)
    v = out["values"]
    assert v["net_err"] < 1e-5 and v["pos_err"] < 1e-5
    assert v["post_err"] < 1e-5 and v["choice_mismatch"] == 0


@pytest.mark.parametrize("stack", ["none", "xla"])
def test_float32_train_steps_equal_the_reference(stack):
    cell = small_cell("train-cpx-pallas",
                      **{"model.denoiser.fused_stack": stack,
                         "train.dtype": "float32"})
    out = finetune.run(cell, 2**32 + 3, 0, False, "cpu",
                       time.perf_counter(), steps_override=1)
    v = out["values"]
    assert v["batch_mismatch"] == 0
    assert v["loss_gap"] < 1e-5 and v["grad_gap"] < 1e-4
    assert v["change_gap"] < 1e-2
