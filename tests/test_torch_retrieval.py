"""The port's ``retrieve`` and ``recall_at_k`` against the JAX package on tied
scores: a gallery that holds each row several times under distinct ids
(re-uploaded images, one image per caption). ``jax.lax.top_k`` ranks equal
scores lower index first; the port must give the same indices and recalls
exactly, not merely the same scores.

Exactness: the recall case feeds one f32 score matrix, made in numpy, to
both packages; the retrieve case uses dyadic integer rows (multiples of
1/8, |x| <= 3/8), whose products and sums are exact in f32 in any order, so
both packages' score matmuls give bit-identical ties.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechclip_tpu.ops.retrieval import recall_at_k as jax_recall_at_k
from speechclip_tpu_torch import recall_at_k, retrieve
from speechclip_tpu_torch.ops.retrieval import top_k

torch.set_num_threads(2)

UNIQUE, REPEAT, QUERIES = 50, 3, 64


def duplicated_gallery(rng, rows):
    """``UNIQUE`` rows, each repeated ``REPEAT`` times, shuffled: (gallery,
    the unique row of each gallery row)."""
    which = rng.permutation(np.repeat(np.arange(UNIQUE), REPEAT))
    return rows[which], which


def test_recall_at_k_ranks_ties_as_jax():
    """150 unit rows (50 repeated 3 times), 64 queries near them; gold = the
    lowest index at the top score. JAX scores recall@1 = 100; so must the
    port (``torch.topk`` gave 32.8)."""
    rng = np.random.default_rng(0)
    unit = rng.standard_normal((UNIQUE, 16)).astype(np.float32)
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    gallery, which = duplicated_gallery(rng, unit)
    q = unit[rng.integers(0, UNIQUE, QUERIES)] + 0.05 * rng.standard_normal((QUERIES, 16))
    scores = (q.astype(np.float32) @ gallery.T).astype(np.float32)
    top = scores.max(axis=1, keepdims=True)
    gold = np.argmax(scores == top, axis=1).astype(np.int32)
    assert (np.sum(scores == top, axis=1) == REPEAT).all()  # every top score is a tie
    cand = np.arange(len(gallery), dtype=np.int32)
    recall_at = [1, 2, 5]
    want = jax_recall_at_k(jnp.asarray(scores), jnp.asarray(gold), jnp.asarray(cand), recall_at)
    got = recall_at_k(torch.from_numpy(scores), torch.from_numpy(gold), torch.from_numpy(cand),
                      recall_at)
    assert want["recall@1"] == 100.0
    assert got == want


@pytest.mark.parametrize("k", [1, 3, 10])
def test_retrieve_indices_match_jax_top_k_on_ties(k):
    rng = np.random.default_rng(k)
    rows = rng.integers(-3, 4, (UNIQUE, 16)).astype(np.float32) / 8
    gallery, _ = duplicated_gallery(rng, rows)
    q = rng.integers(-3, 4, (QUERIES, 16)).astype(np.float32) / 8
    scores = jnp.matmul(jnp.asarray(q), jnp.asarray(gallery).T,
                        precision=jax.lax.Precision.HIGHEST)
    want_s, want_i = jax.lax.top_k(scores, k)
    got_s, got_i = retrieve(torch.from_numpy(q), torch.from_numpy(gallery), k)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_top_k_takes_the_last_dim_and_caps_k():
    """Batched scores (the attention map's (B, K, V) keyword scores) and a
    k past the row length, against ``jax.lax.top_k`` on rows of repeats."""
    rng = np.random.default_rng(7)
    s = rng.integers(0, 4, (2, 3, 9)).astype(np.float32)
    want_s, want_i = jax.lax.top_k(jnp.asarray(s), 9)
    got_s, got_i = top_k(torch.from_numpy(s), 20)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
