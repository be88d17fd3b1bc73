"""tests/test_torch_data_parallel.py's checks at world 4: four gloo ranks of
two rows each against JAX's step on ``make_mesh(data=4)``. kw-BN's
``replica_groups`` 2 puts one group across two ranks here, and 4 one group
on each rank."""

import pytest

from tests.test_torch_data_parallel import *  # noqa: F401,F403 (the tests and their fixture)


@pytest.fixture(scope="module")
def world_size():
    return 4
