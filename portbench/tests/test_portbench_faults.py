"""A run of each kind with its timed path broken underneath (the look
for a card skipped, everything else as in a run) comes out not correct,
once for each fault the cell can have (`portbench/faults.py`)."""
import time

import pytest

from portbench import faults
from portbench.kinds import finetune, sample_pools

from .small import small_cell


@pytest.mark.parametrize("fault", faults.SAMPLING)
def test_broken_sampling_step_is_not_correct(fault):
    cell = small_cell("sample-lig-module")
    with faults.planted("sample_pools", fault):
        out = sample_pools.run(cell, 2**31 + 99, 0, False, "cpu",
                               time.perf_counter(), steps_override=3)
    assert not out["correct"] and out["failed"] > 0, out["values"]


@pytest.mark.parametrize("fault", faults.TRAINING)
def test_broken_train_step_is_not_correct(fault):
    cell = small_cell("train-cpx-pallas",
                      **{"model.denoiser.fused_stack": "none"})
    with faults.planted("finetune", fault):
        out = finetune.run(cell, 2**32 + 77, 0, False, "cpu",
                           time.perf_counter(), steps_override=1)
    assert not out["correct"] and out["failed"] > 0, out["values"]
