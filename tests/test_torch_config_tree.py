"""The port's config tree (``speechclip_tpu_torch.config``: ``ConfigTree``,
the YAML-subset reader ``load_config``, ``to_yaml`` and
``model_config_from_tree``) against PyYAML and the JAX package's
``ConfigNode``: every shipped config reads as ``yaml.safe_load`` reads it,
scalars resolve as PyYAML resolves them, what either side writes the other
reads back, and the model config equals the test side's mapping of the JAX
tree (``port_config_from_jax``)."""

import dataclasses
import glob
import math
import os

import pytest
import yaml

from speechclip_tpu.config import ConfigNode, load_config as jax_load_config
from speechclip_tpu_torch.config import (
    ConfigTree,
    YamlSubsetError,
    load_config,
    model_config_from_tree,
    parse_override_value,
    parse_yaml,
)
from tests.test_models import tiny_speechclip_config
from tests.test_torch_config import port_config_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))
BASE = [c for c in CONFIGS if os.sep + "base" + os.sep in c]
LARGE = [c for c in CONFIGS if os.sep + "large_" in c]


def _same(a, b) -> bool:
    """Equal values of equal types, NaN equal to NaN, recursively."""
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return type(a) is type(b) and a == b


def test_every_shipped_config_reads_as_safe_load():
    assert len(CONFIGS) == 6 and len(BASE) == 2
    for path in CONFIGS:
        with open(path) as f:
            source = f.read()
        assert _same(parse_yaml(source), yaml.safe_load(source)), path
        assert _same(load_config(path).to_dict(), jax_load_config(path).to_dict()), path


SCALARS = ["1e-4", "1.0e-05", "yes", "off", "~", "010", "0x10", "fixed=0.1", "[1, 5, 10]",
           "ViT-B/32", "null", "True", "0b101", "1_000", "1:30", "-.inf", ".nan", "09", "+1.5",
           "1.5E+3", "'yes'", '"a\\tb"', "[[16, 10, 5], [16, 3, 2]]", "[]", "{}", "-0", "0."]


@pytest.mark.parametrize("text", SCALARS)
def test_scalars_resolve_as_pyyaml(text):
    """Overrides and values alike: ``1e-4`` stays a string (YAML 1.1 wants
    a dot), ``010`` is octal, ``yes``/``off`` are booleans."""
    want = yaml.safe_load(text)
    assert _same(parse_override_value(text), want)
    assert _same(parse_yaml(f"k: {text}\n"), yaml.safe_load(f"k: {text}\n"))


def _tree():
    return ConfigTree({
        "a": {"b": [[1, 2], [3]], "c": [1, 5, 10], "d": None, "e": "yes", "f": 1e-5,
              "g": "x" * 90 + " " + "y" * 30, "h": [], "i": {}, "j": "010", "k": "fixed=0.1",
              "l": True, "m": [{"x": 1, "y": [2, 3]}], "n": "a: b", "o": "it's", "p": "- x",
              "q": "#x", "r": 1e16, "s": -0.0, "t": "", "u": " lead", "v": "tab\there",
              "w": float("inf"), "z": 1e-4}})


def test_to_yaml_reads_back_in_both_readers():
    tree = _tree()
    text = tree.to_yaml()
    assert _same(yaml.safe_load(text), tree.to_dict())
    assert _same(parse_yaml(text), tree.to_dict())


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_port_reads_jax_to_yaml(path, tmp_path):
    """``ConfigNode.to_yaml()`` (``yaml.safe_dump``: block sequences, ``- -``
    nesting, folded long strings) reads back to the same tree."""
    node = jax_load_config(path)
    node.merge_({"extra": {"nested": [[1, 2], [3, 4]], "long": "w" * 100 + " tail"}})
    out = tmp_path / "c.yaml"
    out.write_text(node.to_yaml())
    assert _same(load_config(str(out)).to_dict(), node.to_dict())
    assert _same(parse_yaml(ConfigTree(node.to_dict()).to_yaml()), node.to_dict())


def test_overrides_and_tree_protocol():
    tree = load_config(BASE[1], overrides=["trainer.max_steps=6", "trainer.save_at_steps=[3]",
                                           "data.dev_batch_size=16", "a.b.c=1e-4"])
    assert tree.trainer.max_steps == 6 and tree.trainer.save_at_steps == [3]
    assert tree.get_path("data.dev_batch_size") == 16 and tree.a.b.c == "1e-4"
    node = jax_load_config(BASE[1], overrides=["trainer.max_steps=6", "trainer.save_at_steps=[3]",
                                               "data.dev_batch_size=16", "a.b.c=1e-4"])
    assert _same(tree.to_dict(), node.to_dict())
    copy = ConfigTree(tree)
    copy.trainer.merge_({"max_steps": 1})
    assert tree.trainer.max_steps == 6  # a snapshot: no shared subtree
    assert tree.get_path("no.such.key", 5) == 5
    with pytest.raises(ValueError, match="key.path=value"):
        load_config(None, overrides=["novalue"])


@pytest.mark.parametrize("source, line", [
    ("a: 1\nb: |\n  text\n", 2), ("a: &x 1\n", 1), ("a:\n  b: 1\n   c: 2\n", 3),
    ("a: {b: 1}\n", 1), ("a: 1\na: 2\n", 2), ("when: 2001-12-14\n", 1)])
def test_outside_the_subset_raises_with_the_line(source, line):
    with pytest.raises(YamlSubsetError, match=f"^line {line}: "):
        parse_yaml(source)


def _tiny_trainer_tree(tmp_path):
    """``tests/test_trainer.py``'s trainer config (its model part)."""
    cfg = tiny_speechclip_config(tmp_path)
    cfg.merge_({
        "audio_encoder": {
            "max_audio_len": 2400,
            "optim": {"name": "Adam", "args": {"lr": 1e-3, "weight_decay": 1e-6}},
            "scheduler": {"name": "linear_warmup_decay", "warmup": 2, "max_step": 10,
                          "final_lr": 1e-8}},
        "trainer": {"max_steps": 3, "gradient_clip_val": 4, "precision": 32}})
    return cfg


@pytest.mark.parametrize("which", ["spchclp_c", "spchclp_p", "tiny"])
def test_model_config_equals_port_config_from_jax(which, tmp_path):
    if which == "tiny":
        node = _tiny_trainer_tree(tmp_path)
        path = tmp_path / "tiny.yaml"
        path.write_text(node.to_yaml())
        tree = load_config(str(path))
    else:
        path = next(c for c in BASE if os.path.basename(c).startswith(which))
        node, tree = jax_load_config(path), load_config(path)
    want = dataclasses.asdict(port_config_from_jax(node))
    got = dataclasses.asdict(model_config_from_tree(tree))
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], key


@pytest.mark.parametrize("path", LARGE, ids=lambda p: p.split(os.sep)[-2])
def test_large_configs_raise_by_name(path):
    with pytest.raises(NotImplementedError, match="hubert_large_ll60k.*Variants"):
        model_config_from_tree(load_config(path))


@pytest.mark.parametrize("override, item", [
    ("audio_encoder.wsum_remat=true", "Training, the rest"),
    ("audio_encoder.trainable=true", "Training, the rest"),
    ("clip.image_encoder_trainable=true", "Training, the rest"),
    ("audio_encoder.type=s3prl_plus", "Variants")])
def test_what_the_port_lacks_raises_naming_its_item(override, item):
    with pytest.raises(NotImplementedError, match=item):
        model_config_from_tree(load_config(BASE[1], overrides=[override]))


def test_config_tree_pickles_and_merges_like_config_node():
    import pickle

    tree = load_config(BASE[0])
    assert pickle.loads(pickle.dumps(tree)) == tree
    assert isinstance(pickle.loads(pickle.dumps(tree)).trainer, ConfigTree)
    node = ConfigNode(jax_load_config(BASE[0]).to_dict())
    for t in (tree, node):
        t.merge_({"trainer": {"max_steps": 2, "new": [1]}, "x": 1})
        t.set_path("model_settings.cascaded_branch.keyword.number", 4)
    assert _same(tree.to_dict(), node.to_dict())
