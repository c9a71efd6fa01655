"""The port's ``loss_fn`` and its gradients against the reference's for
the moe/MLA, ssm, hybrid and encdec families at the reduced configs
(deepseek-v2-lite-16b, deepseek-v2-236b with its q-LoRA,
falcon-mamba-7b, zamba2-1.2b whose shared block's gradient sums over its
applications, and whisper-base whose encoder gets its gradient through
the cross attention).  Inputs, weights and tolerances as
``test_torch_loss_grads.py``, whose check this file runs."""
import pytest

from test_torch_loss_grads import check_loss_and_grads

FAMILIES = ("deepseek-v2-lite-16b", "deepseek-v2-236b", "falcon-mamba-7b",
            "zamba2-1.2b", "whisper-base")


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_grads_match_reference(name):
    check_loss_and_grads(name)
