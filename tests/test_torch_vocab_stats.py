"""The port's subword-usage tables (speechclip_tpu_torch/data/vocab_stats.py)
against the JAX package's: ``compute_vocab_usage`` bitwise (the padded
buffer's pad id 0 counted), ``save_vocab_usage``'s four files byte for byte
(byfreq ties by ascending id), the CLI over tests/test_trainer.py's corpus,
and the refusal of a caption longer than the context."""

import os
import sys

import numpy as np
import pytest

from speechclip_tpu.data import vocab_stats as jax_stats
from speechclip_tpu.models.tokenizer import CLIPTokenizer as JaxTokenizer
from speechclip_tpu_torch.data import vocab_stats as port_stats
from speechclip_tpu_torch.models.tokenizer import CLIPTokenizer
from tests.test_trainer import corpus, make_tiny_bpe  # noqa: F401 (fixture)

# counts with ties: "a" and "b" twice each, "the" and "of" once each
TEXTS = ["a b the", "b a of", "the thing", "in of er", "thing in"]
FILES = [f"text_clip_vocab_usage_{n}.{e}" for n in ("byID", "byfreq") for e in ("npy", "txt")]


@pytest.fixture(scope="module")
def bpe(tmp_path_factory):
    return make_tiny_bpe(tmp_path_factory.mktemp("bpe") / "merges.txt.gz")


def _same_files(a, b):
    for name in FILES:
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def test_tables_bitwise(bpe, tmp_path):
    got = port_stats.compute_vocab_usage(TEXTS, CLIPTokenizer(bpe))
    want = jax_stats.compute_vocab_usage(TEXTS, JaxTokenizer(bpe))
    assert got.dtype == want.dtype == np.int64 and np.array_equal(got, want)
    tok = CLIPTokenizer(bpe)
    assert got[0, 0] == 0 and got[0, 1] == 77 * len(TEXTS) - sum(
        len(tok.encode(t)) + 2 for t in TEXTS)  # the pad, counted over the buffers
    port_stats.save_vocab_usage(got, str(tmp_path / "port"))
    jax_stats.save_vocab_usage(want, str(tmp_path / "jax"))
    _same_files(tmp_path / "port", tmp_path / "jax")
    by_freq = np.load(tmp_path / "port" / FILES[2])
    counts = by_freq[:, 1]
    assert (np.diff(counts) <= 0).all()
    for c in np.unique(counts):  # ties by ascending id
        ids = by_freq[counts == c, 0]
        assert (np.diff(ids) > 0).all()
    assert len(np.unique(counts)) < len(counts)  # the data has ties


def test_too_long_caption_raises(bpe):
    for stats, tok in ((port_stats, CLIPTokenizer(bpe)), (jax_stats, JaxTokenizer(bpe))):
        with pytest.raises(RuntimeError, match="too long"):
            stats.compute_vocab_usage(["x " * 80], tok)


def test_cli_matches_jax(corpus, bpe, tmp_path, monkeypatch):  # noqa: F811
    argv = ["--dataset", "flickr", "--dataset_root", str(corpus), "--bpe_path", bpe]
    port_stats.main(argv + ["--output_dir", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["vocab_stats"] + argv + ["--output_dir",
                                                               str(tmp_path / "jax")])
    jax_stats.main()
    _same_files(tmp_path / "port", tmp_path / "jax")
    assert len(np.load(tmp_path / "port" / FILES[0])) > 10
