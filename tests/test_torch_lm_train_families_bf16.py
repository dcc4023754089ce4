"""`model_loss` and its gradients in bf16, the port (autograd) against
the reference run op by op (`jax.disable_jit`: its jitted bf16 rounds
apart, ROADMAP.md Queue 3 item 16), for both MoE archs (the dense one is
in tests/test_torch_lm_train.py):
loss and metrics within 3e-2 relative, every gradient leaf within 3e-2
of its largest magnitude. Both packages' gradients are bf16 like their
params; the embedding's gather and the COO combine sum in another order
in each."""
import pytest

import _torch_parity  # noqa: F401  (one intra-op thread per process)
from _lm_parity import check_loss_and_grads


@pytest.mark.parametrize("name", ["deepseek-v3-671b", "grok-1-314b"])
def test_loss_and_grads_match_reference_op_by_op(name):
    check_loss_and_grads(name, "bfloat16")
