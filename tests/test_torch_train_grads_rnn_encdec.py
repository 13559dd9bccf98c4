"""``Model.loss_fn`` of the PyTorch port and its gradients against
``jax.value_and_grad`` of the JAX package's, at ``reduced_config``, for
the recurrent architectures (mLSTM/sLSTM, RG-LRU with local
attention) and the encoder-decoder: loss rel 1e-5, each gradient leaf rel 1e-4 of
its max (``tests/_lm_train_parity.py``)."""
import pytest

from _lm_train_parity import check_loss_and_grads

ARCHS = ("xlstm-350m", "recurrentgemma-2b", "whisper-small")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)
