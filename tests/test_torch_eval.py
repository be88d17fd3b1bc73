"""The validation epoch's eval side (``training/evaluation.py``) and
``ops.retrieval.mutual_retrieval`` against the JAX package's, on the same
collected arrays: pair ids out of order with five captions an image (and a
duplicate image row under another id, so scores tie), and tied scores
ranked lower index first as ``jax.lax.top_k`` ranks them; the keyword
detokenization with a reduced vocabulary, a small tokenizer, tied token
rows, cosine and pseudo-inverse.

Tolerance: recall@k within 1e-4 (f32 means; a rank flip moves recall by
100 / N >= 0.5).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speechclip_tpu.ops.retrieval import mutual_retrieval as jax_mutual_retrieval
from speechclip_tpu.training import evaluation as jax_eval
from speechclip_tpu_torch.models.clip import ReducedVocab
from speechclip_tpu_torch.ops.retrieval import mutual_retrieval
from speechclip_tpu_torch.training import evaluation as port_eval

torch.set_num_threads(2)

RECALL_AT = (1, 5, 10)


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def collected():
    """40 images x 5 captions, ids shuffled; image 7's feature equals image
    3's (a tie for every query); captions near their image."""
    rng = np.random.default_rng(4)
    n_img, e = 40, 16
    img = _unit(rng.standard_normal((n_img, e)))
    img[7] = img[3]
    ids = rng.permutation(np.repeat(np.arange(100, 100 + n_img), 5))
    order = {i: k for k, i in enumerate(range(100, 100 + n_img))}
    rows = np.array([order[i] for i in ids])
    audio = _unit(img[rows] + 0.9 * rng.standard_normal((len(ids), e)))
    audio[:3] = img[rows[:3]]  # exact matches, tied with their duplicate where 3 / 7
    return {"id": ids.astype(np.int64), "audio_feat": audio, "image_feat": img[rows]}


def test_retrieval_metrics_match_jax(collected):
    want = jax_eval.retrieval_metrics(collected, RECALL_AT)
    got = port_eval.retrieval_metrics(collected, RECALL_AT, device="cpu")
    for g, w in zip(got, want):
        assert set(g) == {f"recall@{k}" for k in RECALL_AT}
        assert g == pytest.approx(w, abs=1e-4)
    assert 0 < got[0]["recall@1"] < got[0]["recall@10"] <= 100


@pytest.mark.parametrize("seed", [0, 1])
def test_mutual_retrieval_matches_jax_on_tied_scores(seed):
    """Scores rounded to one decimal: most rows hold ties at the top."""
    rng = np.random.default_rng(seed)
    s = np.round(rng.standard_normal((30, 12)), 1).astype(np.float32)
    a_ids = rng.integers(0, 12, 30).astype(np.int32)
    b_ids = rng.permutation(12).astype(np.int32)
    want = jax_mutual_retrieval(jnp.asarray(s), jnp.asarray(s.T), jnp.asarray(a_ids),
                                jnp.asarray(b_ids), RECALL_AT)
    got = mutual_retrieval(torch.from_numpy(s), torch.from_numpy(s.T),
                           torch.from_numpy(a_ids), torch.from_numpy(b_ids), RECALL_AT)
    for g, w in zip(got, want):
        assert g == pytest.approx(w, abs=1e-4)


def test_mutual_retrieval_rejects_mismatched_shapes():
    s = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="do not match"):
        mutual_retrieval(s, s.T, torch.arange(3), torch.arange(3), RECALL_AT)


def test_collect_validation_outputs_matches_jax():
    """numpy and torch batches (a bf16 tensor comes back as f32), and the
    gold captions."""
    rng = np.random.default_rng(5)
    batches = [{"id": rng.integers(0, 9, n), "audio_feat": rng.standard_normal((n, 4)),
                "image_feat": rng.standard_normal((n, 4)).astype(np.float32),
                "keywords": rng.standard_normal((n, 2, 4)).astype(np.float32),
                "gold_text": [f"caption {i}" for i in range(n)]} for n in (3, 2)]
    want = jax_eval.collect_validation_outputs(batches)
    as_torch = [dict(b, image_feat=torch.from_numpy(b["image_feat"]),
                     keywords=torch.from_numpy(b["keywords"]).bfloat16()) for b in batches]
    got = port_eval.collect_validation_outputs(as_torch)
    assert set(got) == set(want)
    for key in ("id", "audio_feat", "image_feat"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["keywords"].dtype == np.float32
    np.testing.assert_allclose(got["keywords"], want["keywords"], rtol=2**-8)
    assert got["gold_text"] == want["gold_text"]


class _Tokenizer:
    """A word-level stand-in: word i of the table is token id i."""

    def __init__(self, words):
        self.decoder = dict(enumerate(words))
        self._ids = {w: i for i, w in self.decoder.items()}

    def encode(self, text):
        return [self._ids[w] for w in text.split()]


@pytest.mark.parametrize("method", ["cosine", "pseudo_inverse"])
@pytest.mark.parametrize("reduced", [False, True])
def test_detokenize_keywords_matches_jax(method, reduced):
    rng = np.random.default_rng(6)
    v_full, v, k, d = 30, 20, 3, 8
    table = rng.standard_normal((v, d)).astype(np.float32)
    table[5] = table[9]  # tied neighbours
    keywords = (table[rng.integers(0, v, (7, k))] + 0.3 * rng.standard_normal((7, k, d)))
    tok = _Tokenizer([f"w{i}" for i in range(v_full)])
    selected = np.sort(rng.choice(v_full, v, replace=False)) if reduced else np.arange(v)
    vocab = None
    if reduced:
        vocab = ReducedVocab(selected, {int(o): i for i, o in enumerate(selected)},
                             {i: int(o) for i, o in enumerate(selected)}, np.ones(v) / v)
    gold = [" ".join(f"w{selected[j]}" for j in rng.integers(0, v, 4)) for _ in range(7)]
    args = (keywords.astype(np.float32), table, gold, tok)
    kwargs = dict(reduced_vocab=vocab, k_neighbors=4, retrieve_method=method, batch_size=3)
    want = jax_eval.detokenize_keywords(*args, **kwargs)
    got = port_eval.detokenize_keywords(*args, **kwargs)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and got[2] == want[2]
    assert want[0].max() > 0  # some keyword hits its caption


def test_detokenize_keywords_without_a_tokenizer_matches_jax():
    rng = np.random.default_rng(7)
    kw = rng.standard_normal((4, 2, 8)).astype(np.float32)
    table = rng.standard_normal((12, 8)).astype(np.float32)
    args = (kw, table, ["a"] * 4, None)
    want = jax_eval.detokenize_keywords(*args, k_neighbors=3)
    got = port_eval.detokenize_keywords(*args, k_neighbors=3)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and got[2] == want[2]
    with pytest.raises(ValueError):
        port_eval.detokenize_keywords(*args, retrieve_method="dot")
