"""The trainable CLIP towers (``clip.image_encoder_trainable``,
``clip.text_encoder_trainable``) against the JAX package at tiny dims
(``flagship_tiny_config()``, precision 32, dropout 0), from ONE JAX
``create_train_state`` carried over by convert.from_jax
(tests/test_torch_train_step.py's helpers and limits: the loss 1e-5 abs +
1e-4 relative, each trainable leaf's gradient 1e-5 abs + 1e-4 of its
largest JAX gradient).

- The ViT image tower trainable: the loss and every trainable leaf's
  gradient, the tower's included; ``forward_image`` keeps a graph only for
  a trainable tower.
- The text tower trainable (the cascaded branch's pass through it): the
  same, the tower's leaves included.
- Under "pallas" the towers' attention takes ``flash_attention`` with a
  gradient (one recompute a layer): the gradients equal "auto"'s.
- The RN towers refuse ``image_encoder_trainable`` with JAX's message; the
  trainer's image-feature cache refuses a trainable tower with JAX's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from speechclip_tpu.config import flagship_tiny_config
from speechclip_tpu.models.speechclip import SpeechCLIPModel as JaxModel
from speechclip_tpu_torch.config import load_config
from speechclip_tpu_torch.kernels.flash_attention import flash_attention
from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel
from speechclip_tpu_torch.ops.attention import attention_backend
from speechclip_tpu_torch.training.trainer import Trainer
from tests.test_torch_config import port_config_from_jax
from tests.test_torch_config_tree import _tiny_trainer_tree
from tests.test_torch_train_step import (
    ATOL,
    RTOL,
    assert_grads_match,
    flat,
    jax_batch,
    jax_config,
    jax_loss_and_grads,
    make_batch,
    port_grads,
    port_tree,
)
from tests.test_torch_trainable_encoder import init_both

torch.set_num_threads(2)

TOWERS = {"image": ("image_encoder_trainable", "visual"),
          "text": ("text_encoder_trainable", "text")}


def tower_config(tower):
    cfg = jax_config()
    cfg.clip[TOWERS[tower][0]] = True
    return cfg


@pytest.fixture(scope="module", params=sorted(TOWERS))
def trained(request):
    return request.param, init_both(tower_config(request.param))


def test_tower_gradients_match_jax(trained):
    tower, (jm, jstate, _, pm, state) = trained
    batch = make_batch()
    (_, jlosses), jgrads = jax_loss_and_grads(jm, jstate, jax_batch(batch))
    grads, losses = port_grads(pm, state, batch)
    for key, value in losses.items():
        np.testing.assert_allclose(value, float(jlosses[key]), atol=ATOL, rtol=RTOL)
    prefix = f"['clip']['{TOWERS[tower][1]}']"
    mine = [k for k in grads if k.startswith(prefix)]
    assert mine and len(mine) == len([k for k in flat(state.params) if k.startswith(prefix)])
    assert not any(k.startswith("['clip']") and not k.startswith(prefix) for k in grads)
    assert_grads_match(grads, flat(port_tree(jgrads)))


def test_pallas_tower_gradients_equal_auto(trained):
    """Under "pallas" each tower layer's attention is ``flash_attention``
    with a gradient (its plain recompute); the gradients equal "auto"'s
    (``sdpa_plain``) to f32 rounding."""
    tower, (_, _, _, pm, state) = trained
    batch = make_batch()
    want, _ = port_grads(pm, state, batch)
    flash_attention.recomputes = 0
    with attention_backend("pallas"):
        got, _ = port_grads(pm, state, batch)
    cfg = pm.config
    # the tower's layers, the cascaded head and the parallel branch's layer
    # carry a gradient; HuBERT's frozen layers record none
    layers = cfg.clip_vision.layers if tower == "image" else cfg.clip_text.layers
    assert flash_attention.recomputes == layers + 1 + cfg.parallel_branch.n_layers + (
        cfg.clip_text.layers if tower == "image" else 0)
    for key, g in got.items():
        scale = np.abs(want[key]).max()
        np.testing.assert_allclose(g, want[key], atol=ATOL + RTOL * scale, rtol=0, err_msg=key)


def test_forward_image_keeps_a_graph_only_for_a_trainable_tower(trained):
    tower, (_, _, _, pm, state) = trained
    images = torch.from_numpy(make_batch()["image"])
    out = pm.forward_image(state.params, images)
    assert out.requires_grad == (tower == "image")
    text = pm.forward_text(state.params, torch.zeros(2, 77, dtype=torch.long),
                           torch.tensor([3, 5]))
    assert text.requires_grad == (tower == "text")


def test_rn_towers_refuse_a_trainable_image_tower():
    cfg = flagship_tiny_config()
    cfg.clip.custom = None
    cfg.clip.name = "RN50"
    cfg.clip.image_encoder_trainable = True
    with pytest.raises(NotImplementedError) as jax_error:
        JaxModel(cfg)
    cfg.clip.image_encoder_trainable = False
    port_cfg = dataclasses.replace(port_config_from_jax(cfg), image_encoder_trainable=True)
    with pytest.raises(NotImplementedError) as port_error:
        SpeechCLIPModel(port_cfg, device="cpu")
    assert str(port_error.value) == str(jax_error.value)


def test_the_image_cache_refuses_a_trainable_image_tower(tmp_path):
    tree = _tiny_trainer_tree(tmp_path)
    tree.merge_({"trainer": {"cache_image_features": True},
                 "clip": {"image_encoder_trainable": True}})
    path = tmp_path / "cache.yaml"
    path.write_text(tree.to_yaml())
    trainer = Trainer(load_config(str(path)), workdir=str(tmp_path / "run"), device="cpu")
    assert trainer.model.config.image_encoder_trainable
    with pytest.raises(ValueError, match="^trainer.cache_image_features requires a frozen "
                                         "image tower$"):
        trainer._cache_image_features()
