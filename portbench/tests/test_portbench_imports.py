"""No module of the benchmark imports JAX, jaxlib, flax or the JAX package
(by whole top-level name: ``speechclip_tpu_torch`` is the measured port),
and the plain reference imports nothing of the measured package."""

import ast
import os

import pytest

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "speechclip_tpu"}
SOURCES = sorted(os.path.relpath(os.path.join(d, f), harness.ROOT)
                 for d, _s, fs in os.walk(harness.HERE) for f in fs
                 if f.endswith(".py") and ".cache" not in d)


def imported(path):
    with open(os.path.join(harness.ROOT, path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES)
def test_no_jax(path):
    assert not FORBIDDEN & set(imported(path))


@pytest.mark.parametrize("path", [p for p in SOURCES if "/reference/" in p]
                         + ["portbench/weights.py", "portbench/compare.py"])
def test_reference_is_independent(path):
    assert "speechclip_tpu_torch" not in set(imported(path))


def test_whole_names():
    names = ["speechclip_tpu_torch", "speechclip_tpu_torch.models", "jaxtyping", "flaxen",
             "jax.numpy", "speechclip_tpu.models", "jaxlib", "flax.linen"]
    assert harness.jax_modules(names) == ["flax.linen", "jax.numpy", "jaxlib",
                                          "speechclip_tpu.models"]
