"""The bf16 cases of tests/test_torch_lm_families.py's reference parity
for the hybrid, RWKV6 and encoder-decoder archs: prefill and decode in
bf16 against the reference run op by op (`jax.disable_jit`), to 3e-2.
The reference's op-by-op runs are slow, so the bf16 cases are spread
over two files (the MoE archs' in test_torch_lm_families_bf16_moe.py)
that the test workers take one each."""
import pytest

from _lm_parity import check_prefill_and_decode


@pytest.mark.parametrize("name", ["zamba2-7b", "rwkv6-1.6b",
                                  "seamless-m4t-large-v2"])
def test_prefill_and_decode_match_reference_in_bf16(name):
    check_prefill_and_decode(name, "bfloat16")
