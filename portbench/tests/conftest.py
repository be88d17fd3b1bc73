"""Shared fixtures of the benchmark's CPU tests: a tiny benchmark root and a
cache directory (the corpus and the native library) for the session."""

import pytest

from portbench.tests import tiny


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture(scope="session")
def cache_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("cache"))
