"""Training of the port's reduced MoE archs (qwen2-moe-a2.7b, arctic-480b)
against the reference on the CPU: the loss and every gradient against
``jax.value_and_grad(bundle.loss)`` on an Auto-axis 1 x 1 mesh, then one
AdamW step (test_torch_train_lm.py's ``check_arch_against_reference``).
"""
import pytest

from test_torch_train_lm import check_arch_against_reference


@pytest.mark.parametrize("arch", ("qwen2-moe-a2.7b", "arctic-480b"))
def test_loss_and_gradients_match_reference(arch):
    check_arch_against_reference(arch)
