"""The large models' layers and routes against the JAX package: the large
cascaded branch's one 1024-wide attention head (MultiheadAttentionAndNorm,
D = 1024) under "auto" and "pallas" in f32 and bf16, JAX dispatching its
Pallas kernel (interpret mode) as on one TPU: at precision 32 under
"pallas" both packages run ``flash_attention``'s f32 form at Dh = 1024;
and the gates at the large widths, number for number: HuBERT-large's layer
(1024 wide, 16 heads) fused up to T = 460, ``attention_vmem`` past it on
the eval buckets, the FFN never fused at F = 4096, the large branch's layer
(8 heads of 128) fused at 6.4 s.

Tolerances as in ``tests/test_torch_cascaded.py``: f32 max abs diff <=
1e-4; bf16 per-row cosine >= 0.999.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechclip_tpu.kernels import attention_vmem as jav
from speechclip_tpu.kernels import ffn_block as jffn
from speechclip_tpu.kernels import mha_block as jmb
from speechclip_tpu.ops import attention as jattn
from speechclip_tpu.ops import transformer as jtr
from speechclip_tpu_torch.kernels import attention_vmem as pav
from speechclip_tpu_torch.kernels import ffn_block as pffn
from speechclip_tpu_torch.kernels import flash_attention as pfa
from speechclip_tpu_torch.kernels import mha_block as pmb
from speechclip_tpu_torch.models.hubert import HUBERT_LARGE, conv_output_length
from speechclip_tpu_torch.models.speechclip import cast_params
from speechclip_tpu_torch.ops import attention as pattn
from speechclip_tpu_torch.ops import transformer as ptr
from tests.test_torch_cascaded import _jdt, _tensors, jax_on_one_tpu  # noqa: F401
from tests.test_torch_hubert import DTYPES, assert_match

torch.set_num_threads(2)

D, T = 1024, 40


@pytest.fixture(scope="module")
def head():
    rng = np.random.default_rng(8)
    jmn = jtr.mha_and_norm_init(jax.random.key(9), D)
    return dict(jmn=jmn, pmn=_tensors(jmn), src=rng.standard_normal((2, T, D)).astype(np.float32),
                lens=np.array([T, 23], np.int32))


@pytest.mark.parametrize("backend", ["auto", "pallas"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_large_cascaded_head_matches_jax(head, jax_on_one_tpu, backend, dtype, monkeypatch):
    src, lens = head["src"], head["lens"]
    kpm = np.arange(T)[None, :] >= lens[:, None]
    with jattn.attention_backend(backend):
        want, _ = jtr.mha_and_norm_apply(
            head["jmn"], jnp.asarray(src).astype(_jdt(dtype)), nhead=1,
            key_padding_mask=jnp.asarray(kpm), key_valid_lens=jnp.asarray(lens))
    called = []
    monkeypatch.setattr(pattn, "flash_attention",
                        lambda q, *a, **k: called.append((q.dtype, q.shape[-1]))
                        or pfa.flash_attention(q, *a, **k))
    with pattn.attention_backend(backend):
        got, _ = ptr.mha_and_norm_apply(
            cast_params(head["pmn"], dtype, device="cpu"), torch.from_numpy(src).to(dtype),
            nhead=1, key_padding_mask=torch.from_numpy(kpm), key_valid_lens=torch.from_numpy(lens))
    assert jax_on_one_tpu == (["flash_attention"] if backend == "pallas" else [])
    assert called == ([(dtype, D)] if backend == "pallas" else [])
    assert got.dtype == dtype
    assert_match(got, want, dtype)


def test_f32_flash_form_takes_the_1024_wide_head():
    """The f32 form's head-dim limit covers the large cascaded head; past it
    the wrapper raises (on the card), as the kernel's C entry does."""
    assert pfa.F32_MAX_HEAD_DIM == 1024


@pytest.mark.parametrize("b", [16, 64, 256])
def test_gates_at_the_large_widths_match_jax(b):
    d, h, f = HUBERT_LARGE.encoder_embed_dim, HUBERT_LARGE.encoder_heads, HUBERT_LARGE.encoder_ffn_dim
    eval_t = [conv_output_length(HUBERT_LARGE, n) for n in (102400, 108800, 163200, 220800, 272000)]
    assert eval_t == [319, 339, 509, 689, 849]
    for t in eval_t + [460, 461]:
        assert pmb.block_eligible(b, t, d, h, 2) == jmb.block_eligible(b, t, d, h, 2)
        assert pffn.ffn_eligible(b, t, d, f, 2) == jffn.ffn_eligible(b, t, d, f, 2) is False
        assert pav.vmem_eligible(b, h, t, t, d // h, 2) == jav.vmem_eligible(b, h, t, t, d // h, 2)
        route = pattn.attention_route(b, t, t, d, h, 2)
        assert route == ("mha_block" if t <= 460 else "attention_vmem"), (t, route)
    # the large parallel branch: T + 1 rows, 8 heads of 128
    assert pmb.block_eligible(b, 320, d, 8, 2) and jmb.block_eligible(b, 320, d, 8, 2)
    # the large cascaded head under "auto" takes sdpa_plain (Dh = 1024)
    assert pattn.attention_route(b, 327, 327, d, 1, 2) == "sdpa"
    assert pattn.attention_route(b, 327, 327, d, 1, 4, backend="pallas") == "flash_attention"
