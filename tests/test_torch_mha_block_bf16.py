"""bf16 half of the mha_layer_block parity cases (see
tests/test_torch_mha_block.py for the setup and the stated tolerances)."""

import pytest

from tests.test_torch_mha_block import cases, check_against_jax


@pytest.mark.parametrize("dtype, mode, heads, t, with_lens", cases("bfloat16"))
def test_plain_matches_jax_kernel_bf16(dtype, mode, heads, t, with_lens):
    check_against_jax(dtype, mode, heads, t, with_lens)
