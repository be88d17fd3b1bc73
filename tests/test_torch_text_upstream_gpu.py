"""The text side and the APC upstream on the card (marker ``gpu``; skipped
without one). On a machine with the card, and without jax installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_text_upstream_gpu.py

- ``ClipWrapper.encode_text`` (ViT-B/32's text tower, seeded init) on
  captions tokenized over chip_smoke.py's synthetic full-size merges file,
  under "pallas": 12 causal ``flash_attention`` launches in their f32 form,
  held to the plain path with chip_smoke.py's f32 limits (max abs 1e-4 of
  max(1, max |feat|), row cosine 0.99999); with the reduced Flickr
  vocabulary too.
- The APC upstream under the parallel branch at D = 512 (8 heads, FFN 2048)
  in bf16: the branch layer takes ``mha_layer_block`` and ``ffn_block`` once
  a forward, the features held to the plain path (row cosine 0.999).
This file imports torch and the port only."""

import dataclasses

import pytest
import torch

pytestmark = pytest.mark.gpu

F32_TOL, MIN_F32_COSINE, MIN_COSINE = 1e-4, 0.99999, 0.999
CAPTIONS = ["a dog runs across the grass", "two men ride bikes on a dirt road",
            "a child in a red coat plays in the snow", "people sit at a table outside"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device")
    return torch.device("cuda")


def _row_cos_min(a, b):
    return float(torch.nn.functional.cosine_similarity(a.float(), b.float(), dim=-1).min())


@pytest.mark.parametrize("reduced", [False, True])
def test_clip_wrapper_encode_text_pallas(cuda, tmp_path, reduced):
    import chip_smoke
    from speechclip_tpu_torch.config import FLICKR_VOCAB
    from speechclip_tpu_torch.kernels.flash_attention import flash_attention
    from speechclip_tpu_torch.models import clip as clip_mod
    from speechclip_tpu_torch.models.clip_api import ClipWrapper
    from speechclip_tpu_torch.models.tokenizer import CLIPTokenizer
    from speechclip_tpu_torch.ops.attention import attention_backend

    tok = CLIPTokenizer(chip_smoke.write_synthetic_merges(str(tmp_path / "m.txt.gz")))
    clip = ClipWrapper("ViT-B/32", tokenizer=tok, seed=0,
                       reduce_subword_embbedding=FLICKR_VOCAB if reduced else None)
    # reduced: captions of words that are rows of the table (chip_smoke.py's
    # phase 24 helpers; over the synthetic merges a caption's subwords need
    # not be in the Flickr table)
    captions = (chip_smoke._seeded_captions(chip_smoke._table_words(tok, clip.reduced_vocab), 8,
                                            0) if reduced else CAPTIONS)
    ids, eot = clip.prep_text(captions)
    flash_attention.launches = 0
    with attention_backend("pallas"):
        got = clip.encode_text(ids, eot)
        torch.cuda.synchronize()
        launches = flash_attention.launches
        want = clip_mod.encode_text(clip.params, clip.cfg.text, ids, eot, plain=True)
    assert launches == clip.cfg.text.layers == 12
    assert got.dtype == torch.float32 and got.shape == (len(captions), 512)
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= F32_TOL * scale
    assert _row_cos_min(got, want) >= MIN_F32_COSINE


def test_apc_encode_launches_and_agreement(cuda):
    from speechclip_tpu_torch import base_config
    from speechclip_tpu_torch.kernels.ffn_block import ffn_block
    from speechclip_tpu_torch.kernels.mha_block import mha_layer_block
    from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel, cast_params
    from speechclip_tpu_torch.models.upstream import APCConfig

    base = base_config()
    cfg = dataclasses.replace(
        base, audio=APCConfig(), audio_encoder_type="s3prl_plus",
        parallel_branch=dataclasses.replace(base.parallel_branch, d_model=512,
                                            dim_feedforward=2048))
    model = SpeechCLIPModel(cfg)
    params, state = (cast_params(t, model.compute_dtype) for t in model.init(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    wav = torch.randn(8, 102400, generator=gen, device="cuda") * 0.1
    wav_len = torch.randint(51200, 102401, (8,), generator=gen, device="cuda")
    wav = wav.masked_fill(torch.arange(102400, device="cuda")[None] >= wav_len[:, None], 0.0)
    mha_layer_block.launches = ffn_block.launches = 0
    got = model.encode_speech(params, state, wav, wav_len)["parallel_audio_feat"]
    torch.cuda.synchronize()
    assert (mha_layer_block.launches, ffn_block.launches) == (1, 1)
    want = model.encode_speech(params, state, wav, wav_len, plain=True)["parallel_audio_feat"]
    assert got.shape == (8, 512) and bool(torch.isfinite(got).all())
    assert _row_cos_min(got, want) >= MIN_COSINE
