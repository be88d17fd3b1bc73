"""tests/test_torch_tensor_parallel.py's checks at ``(data 2, model 2)``:
four gloo ranks, two model groups of two over two data groups, against
JAX's step on ``make_mesh(data=2, model=2)`` and the port's world 1. Both
subgroups carry collectives here: the features' gather and the gradients'
mean over the data groups, the heads and the partials over the model
groups."""

import pytest

from tests.test_torch_tensor_parallel import *  # noqa: F401,F403 (the tests and their fixture)


@pytest.fixture(scope="module")
def mesh_shape():
    return 2, 2  # (data, model)
