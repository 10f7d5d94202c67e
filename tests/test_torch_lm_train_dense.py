"""Training's loss and gradients against the reference's, part 2 of 4: the
other dense architectures and the VLM, float32 and bf16 (tolerances in
``tests/_torch_lm_train_ref.py``)."""

import pytest

from _torch_lm_train_ref import (  # noqa: F401 (one_thread: autouse)
    check_bfloat16, check_float32, one_thread)

ARCHS = ("internlm2-20b", "stablelm-12b", "granite-8b", "internvl2-26b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_float32(arch):
    check_float32(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_bfloat16(arch):
    check_bfloat16(arch)
