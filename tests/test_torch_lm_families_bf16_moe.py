"""The bf16 cases of tests/test_torch_lm_families.py's reference parity
for the MoE archs (deepseek-v3: MLA and the bitmap dispatch of its
reduced config; grok-1: GQA and the COO dispatch): prefill and decode in
bf16 against the reference run op by op (`jax.disable_jit`), to 3e-2."""
import pytest

from _lm_parity import check_prefill_and_decode


@pytest.mark.parametrize("name", ["deepseek-v3-671b", "grok-1-314b"])
def test_prefill_and_decode_match_reference_in_bf16(name):
    check_prefill_and_decode(name, "bfloat16")
