"""The port's CLIP tokenizer (speechclip_tpu_torch/models/tokenizer.py)
against the JAX package's: ``encode``, ``decode``, ``tokenize`` (both
``truncate`` modes), ``vocab_size`` and the special ids equal, on
tests/test_trainer.py's tiny merges file and on chip_smoke.py's synthetic
full-size one (CLIP's id layout), over fixed strings and hypothesis-drawn
ones; the mojibake repair's pinned cases; ``default_bpe_path``."""

import gzip

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from speechclip_tpu.models import tokenizer as jax_tok
from speechclip_tpu_torch.models import tokenizer as port_tok
from tests.test_trainer import make_tiny_bpe

TEXTS = [
    "the thing number 3 in photo 1 .",
    "A dog's   ball&amp;amp;stick, it's 12,345 miles!!",
    "café Ã© donâ€™t Ð¿Ñ€Ð¸Ð²ÐµÑ‚ naïve 東京 😀",
    "<|startoftext|>hi<|endoftext|> there",
    "",
    "   ",
    "x" * 300,
    " ".join(["word"] * 80),
]


@pytest.fixture(scope="module", params=["tiny", "full"])
def pair(request, tmp_path_factory):
    root = tmp_path_factory.mktemp("bpe")
    if request.param == "tiny":
        path = make_tiny_bpe(root / "merges.txt.gz")
    else:
        path = chip_smoke.write_synthetic_merges(str(root / "merges.txt.gz"))
    return request.param, jax_tok.CLIPTokenizer(path), port_tok.CLIPTokenizer(path)


def _same(jt, pt, text):
    assert pt.encode(text) == jt.encode(text), text
    ids = jt.encode(text) + [jt.sot_id, jt.eot_id]
    assert pt.decode(ids) == jt.decode(ids), text
    np.testing.assert_array_equal(pt.tokenize(text), jt.tokenize(text))


def test_vocabulary_layout(pair):
    name, jt, pt = pair
    assert (pt.vocab_size, pt.sot_id, pt.eot_id) == (jt.vocab_size, jt.sot_id, jt.eot_id)
    assert pt.decoder == jt.decoder and pt.bpe_ranks == jt.bpe_ranks
    if name == "full":  # CLIP's layout: 512 byte symbols + 48 894 merges + SOT + EOT
        assert (pt.vocab_size, pt.sot_id, pt.eot_id) == (49408, 49406, 49407)
        assert len(pt.decoder) == pt.vocab_size  # every id decodes


@pytest.mark.parametrize("text", TEXTS)
def test_fixed_strings(pair, text):
    _, jt, pt = pair
    _same(jt, pt, text)


def test_tokenize_batch_and_truncation(pair):
    _, jt, pt = pair
    np.testing.assert_array_equal(pt.tokenize(TEXTS), jt.tokenize(TEXTS))
    long = "x y " * 60
    got = pt.tokenize([long], context_length=16)
    np.testing.assert_array_equal(got, jt.tokenize([long], context_length=16))
    assert got.dtype == np.int64 and got[0, -1] == pt.eot_id
    for tok in (jt, pt):
        with pytest.raises(RuntimeError, match="too long"):
            tok.tokenize([long], context_length=16, truncate=False)
    np.testing.assert_array_equal(pt.tokenize("a b", truncate=False),
                                  jt.tokenize("a b", truncate=False))


@settings(max_examples=60, deadline=None, database=None)
@given(text=st.text(max_size=40))
def test_hypothesis_strings(pair, text):
    _, jt, pt = pair
    _same(jt, pt, text)


@settings(max_examples=40, deadline=None, database=None)
@given(words=st.lists(st.sampled_from(["a", "dog", "the", "runs", "grass", "'s", ".", "2",
                                       "Ã©", "&amp;", "  ", "field", "zebra"]), max_size=30))
def test_hypothesis_captions(pair, words):
    _, jt, pt = pair
    _same(jt, pt, " ".join(words))


@pytest.mark.parametrize("text, want", [
    ("cafÃ©", "café"),
    ("donâ€™t", "don’t"),
    ("é".encode("utf-8").decode("cp1252").encode("utf-8").decode("cp1252"), "é"),
    ("a dog runs.", "a dog runs."),
    ("café", "café"),
    ("café", "café"),  # NFC
    ("Spaß”", "Spaß”"),  # one lead-class letter: left alone
])
def test_mojibake_cases(text, want):
    assert port_tok._fix_mojibake(text) == jax_tok._fix_mojibake(text) == want


def test_clean():
    for text in ("  a&amp;amp;b   c ", "\tx\n\ny  ", "Ã© &lt;b&gt;"):
        assert port_tok._clean(text) == jax_tok._clean(text)
    assert port_tok._clean("  a&amp;amp;b   c ") == "a&b c"


def test_bytes_to_unicode():
    assert port_tok.bytes_to_unicode() == jax_tok.bytes_to_unicode()


def test_default_bpe_path(tmp_path, monkeypatch):
    path = tmp_path / "bpe.txt.gz"
    with gzip.open(path, "wt") as f:
        f.write("#v\n")
    monkeypatch.setenv("SPEECHCLIP_BPE_PATH", str(path))
    assert port_tok.default_bpe_path() == str(path)
    monkeypatch.setenv("SPEECHCLIP_BPE_PATH", str(tmp_path / "missing.gz"))
    repo_file = port_tok.REPO_ROOT / "assets" / port_tok.BPE_FILE
    assert port_tok.default_bpe_path() == (str(repo_file) if repo_file.exists() else None)
    if not repo_file.exists():
        with pytest.raises(FileNotFoundError, match="SPEECHCLIP_BPE_PATH"):
            port_tok.CLIPTokenizer()


def test_plain_text_merges_file(tmp_path):
    """An uncompressed merges file reads as the gzipped one does."""
    gz = make_tiny_bpe(tmp_path / "m.txt.gz")
    plain = tmp_path / "m.txt"
    with gzip.open(gz, "rt") as f:
        plain.write_text(f.read())
    a, b = port_tok.CLIPTokenizer(gz), port_tok.CLIPTokenizer(str(plain))
    assert a.encoder == b.encoder and a.encode(TEXTS[0]) == b.encode(TEXTS[0])
