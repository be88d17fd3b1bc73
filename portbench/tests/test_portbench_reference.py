"""The plain reference on cases worked by hand, and against the program's
own plain forward at tiny sizes (float32, CPU)."""

import math

import numpy as np
import pytest
import torch

from portbench.reference import speechclip_par as R
from portbench.reference.train_ref import to_f32
from portbench.tests import tiny
from portbench.weights import make_params


def test_contrastive_loss_by_hand():
    a = torch.eye(2)
    loss = R.contrastive_loss(a, a, torch.tensor([0, 1]), torch.tensor(1.0))
    assert math.isclose(float(loss), math.log(1 + math.e) - 1, rel_tol=1e-6)
    # the other caption of the same image is no negative: only the positive is left
    assert float(R.contrastive_loss(a, a, torch.tensor([3, 3]), torch.tensor(1.0))) == 0.0


def test_attention_masks_keys_by_hand():
    x = torch.tensor([[[1.0, 2.0], [3.0, -1.0]]])
    eye = torch.eye(2)
    p = {"in_proj": {"w": torch.cat([eye, eye, eye], 1), "b": torch.zeros(6)},
         "out_proj": {"w": eye, "b": torch.zeros(2)}}
    out = R.attention(R.Precision(), x, p, 1, torch.tensor([1]))
    assert torch.equal(out, x[:, :1].expand(1, 2, 2))


def test_small_pieces_by_hand():
    y = R.layer_norm(torch.tensor([1.0, 3.0]), None)
    assert torch.allclose(y, torch.tensor([-1.0, 1.0]) / math.sqrt(1 + 1e-5))
    assert R.feature_lens(torch.tensor([480, 800, 801]), 320, 100).tolist() == [2, 2, 3]
    assert R.frame_lens(torch.tensor([1001, 3200]), 3200, 159).tolist() == [51, 159]
    assert math.isclose(R.linear_warmup_decay(0, 1e-4, 5000, 50000, 1e-8), 2e-8, rel_tol=1e-6)
    p = torch.tensor([1.0])
    adam = R.Adam([p], wd=0.1)
    taken = adam.step([torch.tensor([0.5])], lr=0.1)
    assert torch.allclose(taken[0], torch.tensor([0.6]))
    assert torch.allclose(p, torch.tensor([0.9]))
    g = R.clip_global([torch.tensor([3.0]), torch.tensor([4.0])], 1.0)
    assert torch.allclose(torch.cat(g), torch.tensor([0.6, 0.8]))


def test_fp8_control_rounds():
    P = R.Precision(fp8=True)
    t = torch.linspace(-1, 1, 101)
    err = (P.q(t) - t).abs().max()
    assert 0 < float(err) < 0.07


def _sizes(large: bool):
    sizes = tiny.sizes_of(tiny.tiny_tree())
    if large:
        sizes["audio"].update(extractor_mode="layer_norm", conv_bias=True, layer_norm_first=True,
                              normalize_waveform=True)
    return sizes


@pytest.mark.parametrize("large", [False, True], ids=["base", "large"])
def test_hubert_and_branch_agree_with_the_program(large):
    from speechclip_tpu_torch.config import BranchConfig
    from speechclip_tpu_torch.models import branches
    from speechclip_tpu_torch.models.hubert import HubertConfig, hubert_apply

    sizes = _sizes(large)
    a = dict(sizes["audio"])
    cfg = HubertConfig(**{**a, "conv_layers": tuple(tuple(c) for c in a["conv_layers"])})
    params = to_f32(make_params(sizes, 3, "cpu"))
    rng = np.random.default_rng(0)
    wav = torch.from_numpy(rng.standard_normal((3, 3200)).astype(np.float32)) * 0.1
    lens = torch.tensor([3200, 2100, 901])
    want, feat_len = hubert_apply(params["audio_encoder"], cfg, wav, lens, plain=True)
    got = R.hubert_states(R.Precision(), params["audio_encoder"], a, wav, lens)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    frames = got[0].shape[1]
    assert torch.equal(R.feature_lens(lens, a["downsample_rate"], frames).int(), feat_len)
    br = sizes["parallel_branch"]
    bcfg = BranchConfig(**{k: br[k] for k in br})
    want_b = branches.parallel_branch_apply(params["parallel_branch"], bcfg, want[-1], feat_len,
                                            plain=True)
    got_b = R.branch(R.Precision(), params["parallel_branch"], br, got[-1],
                     R.feature_lens(lens, a["downsample_rate"], frames))
    torch.testing.assert_close(got_b, want_b, rtol=1e-4, atol=1e-4)


def test_vit_agrees_with_the_program():
    from speechclip_tpu_torch.config import CLIPVisionConfig
    from speechclip_tpu_torch.models import clip

    sizes = _sizes(False)
    v = sizes["vision"]
    params = to_f32(make_params(sizes, 4, "cpu"))
    images = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    want = clip.encode_image(params["clip"], CLIPVisionConfig(**v), images, plain=True)
    got = R.vit(R.Precision(), params["clip"]["visual"], v, images)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
