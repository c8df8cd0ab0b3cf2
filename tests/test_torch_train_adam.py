"""The port's train step against the JAX package's with Adam, on the CPU
in f32: the 8-step lockstep of tests/test_torch_train_step.py for the four
families (torch_train_helpers.train_step_lockstep says what it holds)."""

import pytest

from torch_train_helpers import VARIANTS, train_step_lockstep
from torch_train_helpers import few_torch_threads  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("variant", VARIANTS)
def test_train_step_lockstep_adam(variant):
    train_step_lockstep(variant, "Adam")
