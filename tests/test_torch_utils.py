"""The port's utilities (speechclip_tpu_torch/utils) against the JAX
package's: the error rates, edit distance and BLEU equal on fixed and
hypothesis-drawn inputs; ``PenaltyScheduler``'s host value equal and its
tensor form (``get_value_traced`` over a tensor step, batched) equal to
JAX's traced form."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from speechclip_tpu import utils as jax_utils
from speechclip_tpu_torch import utils as port_utils

REFS = ["a dog runs in the grass", "two men ride bikes", "", "the cat"]
HYPS = ["a dog run in grass", "two men ride bikes", "x", "the the cat"]


@pytest.mark.parametrize("name", ["wer", "cer", "per", "corpus_bleu", "report_bleu"])
def test_text_metrics(name):
    got = getattr(port_utils, name)(REFS, HYPS)
    assert got == getattr(jax_utils, name)(REFS, HYPS)


def test_ter_and_edit_distance():
    refs, hyps = [[1, 2, 3], [4], []], [[1, 3], [4, 5], [6]]
    assert port_utils.ter(refs, hyps) == jax_utils.ter(refs, hyps)
    assert port_utils.edit_distance("kitten", "sitting") == 3


@settings(max_examples=60, deadline=None, database=None)
@given(pairs=st.lists(st.tuples(st.text("abc ", max_size=12), st.text("abc ", max_size=12)),
                      min_size=1, max_size=5))
def test_metrics_hypothesis(pairs):
    refs, hyps = [p[0] for p in pairs], [p[1] for p in pairs]
    for name in ("wer", "cer", "corpus_bleu"):
        assert getattr(port_utils, name)(refs, hyps) == getattr(jax_utils, name)(refs, hyps)


SCHEDULES = [([0.0, 1.0, 0.5], [10, 20, 40]), ([2.0], [5]), ([1.0, 0.0], [0, 3])]


@pytest.mark.parametrize("weights, keypoints", SCHEDULES)
def test_penalty_scheduler(weights, keypoints):
    ps, js = (m.PenaltyScheduler(weights, keypoints) for m in (port_utils, jax_utils))
    steps = list(range(-2, 45))
    assert [ps.get_value(s) for s in steps] == [js.get_value(s) for s in steps]
    assert ps.update(15) == js.update(15) and ps.value == js.value
    got = ps.get_value_traced(torch.tensor(steps))
    want = js.get_value_traced(jnp.asarray(steps))
    assert got.dtype == torch.float32 and got.shape == (len(steps),)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(ps.get_value_traced(torch.tensor(15))) == float(js.get_value_traced(15))


def test_penalty_scheduler_checks():
    with pytest.raises(ValueError, match="weights"):
        port_utils.PenaltyScheduler([1.0], [1, 2])
    with pytest.raises(ValueError, match="ascending"):
        port_utils.PenaltyScheduler([1.0, 2.0], [2, 1])
