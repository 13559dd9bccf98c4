"""``Model.loss_fn`` of the PyTorch port and its gradients against
``jax.value_and_grad`` of the JAX package's, at ``reduced_config``, for
the seven decoder-only attention architectures (dense GQA, the
embedding frontend stub, MoE and MLA): loss rel 1e-5, each gradient leaf rel 1e-4 of
its max (``tests/_lm_train_parity.py``)."""
import pytest

from _lm_train_parity import check_loss_and_grads

ARCHS = ("qwen2.5-14b", "qwen1.5-32b", "yi-34b", "qwen3-4b", "chameleon-34b",
         "kimi-k2-1t-a32b", "deepseek-v2-236b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)
