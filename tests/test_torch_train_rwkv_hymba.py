"""Training of the port's reduced rwkv6-1.6b and hymba-1.5b against the
reference on the CPU: the loss and every gradient against
``jax.value_and_grad(bundle.loss)`` on an Auto-axis 1 x 1 mesh, then one
AdamW step (test_torch_train_lm.py's ``check_arch_against_reference``).
"""
import pytest

from test_torch_train_lm import check_arch_against_reference


@pytest.mark.parametrize("arch", ("rwkv6-1.6b", "hymba-1.5b"))
def test_loss_and_gradients_match_reference(arch):
    check_arch_against_reference(arch)
