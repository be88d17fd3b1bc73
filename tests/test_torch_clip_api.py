"""The port's ``ClipWrapper`` (speechclip_tpu_torch/models/clip_api.py)
against the JAX package's at tiny width (a "tiny" entry added to both
packages' named CLIP configs, its text vocabulary the tiny merges file's
519 ids), from one JAX init carried with ``convert/from_jax.py``, with the
full token table and a reduced one: ``prep_text`` equal, ``encode_text``,
``encode_keywords``, ``encode_image`` and ``get_scores`` at f32 1e-4,
``deTokenize`` equal, ``prep_image`` equal; the reduced table cut only from
a full-size one, SOT and EOT remapped."""

import jax
import numpy as np
import pytest
import torch

from speechclip_tpu.models import clip as jax_clip
from speechclip_tpu.models.clip_api import ClipWrapper as JaxClipWrapper
from speechclip_tpu.models.tokenizer import CLIPTokenizer as JaxTokenizer
from speechclip_tpu_torch import config as port_config
from speechclip_tpu_torch.convert.from_jax import speechclip_params_from_jax
from speechclip_tpu_torch.data.vocab_stats import compute_vocab_usage, save_vocab_usage
from speechclip_tpu_torch.models.clip_api import ClipWrapper
from speechclip_tpu_torch.models.tokenizer import CLIPTokenizer
from tests.test_data import write_jpg
from tests.test_trainer import make_tiny_bpe

RTOL, ATOL = 1e-4, 1e-4
SENTS = ["the thing of in", "a photo of the thing number 3 .", "er in the", "x"]
VOCAB = 519  # make_tiny_bpe: 512 byte symbols + 5 merges + SOT + EOT
TINY = dict(vision=dict(image_size=32, patch_size=8, width=32, layers=2, heads=4, output_dim=16),
            text=dict(vocab_size=VOCAB, width=32, layers=2, heads=4, output_dim=16))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("clip_api")
    bpe = make_tiny_bpe(root / "merges.txt.gz")
    save_vocab_usage(compute_vocab_usage(SENTS, CLIPTokenizer(bpe)), str(root / "stat"))
    jax_cfg = jax_clip.CLIPConfig(vision=jax_clip.CLIPVisionConfig(**TINY["vision"]),
                                  text=jax_clip.CLIPTextConfig(**TINY["text"]))
    port_cfg = port_config.CLIPConfig(vision=port_config.CLIPVisionConfig(**TINY["vision"]),
                                      text=port_config.CLIPTextConfig(**TINY["text"]))
    full = jax_clip.clip_init(jax.random.key(3), jax_cfg)
    carried = speechclip_params_from_jax({"clip": jax.tree.map(np.asarray, full)})["clip"]
    return dict(bpe=bpe, table=str(root / "stat" / "text_clip_vocab_usage_byfreq.npy"),
                jax_cfg=jax_cfg, port_cfg=port_cfg, full=full, carried=carried, root=root)


@pytest.fixture(params=["full", "reduced"])
def wrappers(request, setup, monkeypatch):
    monkeypatch.setitem(jax_clip.NAMED_CONFIGS, "tiny", setup["jax_cfg"])
    monkeypatch.setitem(port_config.NAMED_CLIP_CONFIGS, "tiny", setup["port_cfg"])
    table = setup["table"] if request.param == "reduced" else None
    jw = JaxClipWrapper("tiny", params=setup["full"], reduce_subword_embbedding=table,
                        tokenizer=JaxTokenizer(setup["bpe"]))
    pw = ClipWrapper("tiny", params=setup["carried"], reduce_subword_embbedding=table,
                     tokenizer=CLIPTokenizer(setup["bpe"]), device="cpu")
    return request.param, jw, pw


def _close(got, want):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_ids_and_table(wrappers):
    name, jw, pw = wrappers
    assert (pw.sot_id, pw.eot_id, pw.out_dim) == (jw.sot_id, jw.eot_id, jw.out_dim)
    rows = pw.params["text"]["token_embedding"].shape[0]
    assert rows == jw.params["text"]["token_embedding"].shape[0]
    if name == "reduced":
        assert rows == pw.reduced_vocab.size < VOCAB
        assert pw.reduced_vocab.reduced_to_original[pw.sot_id] == VOCAB - 2
        assert pw.reduced_vocab.reduced_to_original[pw.eot_id] == VOCAB - 1
    else:
        assert rows == VOCAB and (pw.sot_id, pw.eot_id) == (VOCAB - 2, VOCAB - 1)
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(pw.params))


def test_prep_text_and_encode_text(wrappers):
    _, jw, pw = wrappers
    ids, eot = pw.prep_text(SENTS)
    jids, jeot = jw.prep_text(SENTS)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(eot.numpy(), np.asarray(jeot))
    _close(pw.encode_text(ids, eot), jw.encode_text(jids, jeot))


def test_detokenize(wrappers):
    _, jw, pw = wrappers
    ids, eot = pw.prep_text(SENTS)
    got = pw.deTokenize(ids)
    assert got == jw.deTokenize(np.asarray(ids)) == pw.deTokenize(ids.numpy().tolist())
    assert pw.deTokenize(ids[0]) == got[:1]
    # the pad id 0 is the real token "!": cut at the EOT, each row is its caption
    for row, end, sent in zip(ids, eot, SENTS):
        assert pw.deTokenize(row[:int(end) + 1]) == [sent]


def test_encode_keywords(wrappers):
    _, jw, pw = wrappers
    kw = np.random.default_rng(0).standard_normal((3, 4, 32)).astype(np.float32)
    _close(pw.encode_keywords(torch.from_numpy(kw), 4), jw.encode_keywords(kw, 4))
    with pytest.raises(ValueError, match="expected 5"):
        pw.encode_keywords(torch.from_numpy(kw), 5)


def test_encode_image_and_scores(wrappers):
    _, jw, pw = wrappers
    images = np.random.default_rng(1).standard_normal((3, 32, 32, 3)).astype(np.float32)
    _close(pw.encode_image(torch.from_numpy(images)), jw.encode_image(images))
    ids, eot = pw.prep_text(SENTS)
    jids, jeot = jw.prep_text(SENTS)
    got = pw.get_scores(torch.from_numpy(images), ids, eot)
    want = jw.get_scores(images, jids, jeot)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w)


def test_prep_image(setup, wrappers):
    _, jw, pw = wrappers
    paths = []
    for i in range(2):
        paths.append(str(setup["root"] / f"im{i}.jpg"))
        write_jpg(paths[-1], size=48, seed=i)
    got = pw.prep_image(paths)
    assert got.shape == (2, 32, 32, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jw.prep_image(paths)))


def test_reduced_table_given_already_cut(setup, monkeypatch):
    """Params whose table is already the reduced one are not cut again."""
    monkeypatch.setitem(port_config.NAMED_CLIP_CONFIGS, "tiny", setup["port_cfg"])
    pw = ClipWrapper("tiny", params=setup["carried"], reduce_subword_embbedding=setup["table"],
                     device="cpu")
    again = ClipWrapper("tiny", params=pw.params, reduce_subword_embbedding=setup["table"],
                        device="cpu")
    assert torch.equal(again.params["text"]["token_embedding"],
                       pw.params["text"]["token_embedding"])


def test_random_init_and_tokenizer_guard(setup, monkeypatch):
    monkeypatch.setitem(port_config.NAMED_CLIP_CONFIGS, "tiny", setup["port_cfg"])
    a, b = (ClipWrapper("tiny", device="cpu", seed=5) for _ in range(2))
    assert torch.equal(a.params["visual"]["proj"], b.params["visual"]["proj"])
    assert a.params["text"]["token_embedding"].shape == (VOCAB, 32)
    with pytest.raises(ValueError, match="tokenizer"):
        a.prep_text(["x"])


@pytest.mark.parametrize("option", ["text_encoder_trainable", "image_encoder_trainable",
                                    "reduce_subword_embedding"])
def test_an_unknown_option_raises(setup, monkeypatch, option):
    """The wrapper holds frozen towers and takes no catch-all keywords: an
    option it does not read (a trainable flag, a misspelt name) raises
    instead of being dropped."""
    monkeypatch.setitem(port_config.NAMED_CLIP_CONFIGS, "tiny", setup["port_cfg"])
    with pytest.raises(TypeError, match=option):
        ClipWrapper("tiny", device="cpu", **{option: True})
