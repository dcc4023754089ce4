"""`model_loss` and its gradients in the port (autograd) against
`jax.value_and_grad` on the reduced configs of the five archs beyond the
dense trunk, in float32: MLA + MoE + the MTP head (deepseek-v3), MoE
with COO dispatch (grok-1), the Mamba2 hybrid (zamba2), RWKV6 and the
encoder-decoder (seamless-m4t, whose reference runs op by op: ROADMAP.md
Queue 3 item 18). Losses and metrics 1e-5 relative; every gradient leaf
within 1e-5 of its largest magnitude, except the seamless encoder's
first norm gain, whose gradient passes the reference's bf16 cast of the
frames (one bf16 ulp of its largest; `_lm_parity.BF16_ULP`, ROADMAP.md
Queue 3 item 24). RWKV6 is in tests/test_torch_lm_train_rwkv.py."""
import pytest

import _torch_parity  # noqa: F401  (one intra-op thread per process)
from _lm_parity import (BF16_ULP, FAMILIES, check_loss_and_grads,
                        leaf_rel_errs)


@pytest.mark.parametrize("name", [f for f in FAMILIES
                                  if f != "rwkv6-1.6b"])
def test_loss_and_grads_match_reference(name):
    """rwkv6's case is in tests/test_torch_lm_train_rwkv.py."""
    check_loss_and_grads(name, "float32")


def test_seamless_encoder_norm_gain_is_differentiated_through_bf16():
    """ROADMAP.md Queue 3 item 24: at seed 3 the seamless encoder's first
    norm gain (read through the reference's bf16 cast of the frames)
    lies past 1e-5 of its largest from the reference, within one bf16
    ulp; every other leaf within 1e-5."""
    jg, tg = check_loss_and_grads("seamless-m4t-large-v2", "float32",
                                  seed=3)
    errs = leaf_rel_errs(tg, jg)
    assert 1e-5 < errs.pop("['enc']['ln1']") <= BF16_ULP
    assert max(errs.values()) <= 1e-5
