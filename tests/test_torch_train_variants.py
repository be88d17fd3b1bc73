"""The train-mode loss and gradients of the flagship's tiny preset with the
configured variants the flagship itself does not run, against the JAX
package's, from one JAX ``init`` carried over by convert.from_jax: a
trainable contrastive temperature (``criterion.log_inv_temp``) with a
learnable VQ temperature (``vq.curr_temp``), and SupConLoss with a trainable
temperature (``criterion.temp``). Precision 32, dropout 0.

Tolerances as tests/test_torch_train_step.py: the losses 1e-5 abs + 1e-4
relative; each trainable leaf's gradient 1e-5 abs + 1e-4 of the leaf's
largest JAX gradient (a gradient that cancels to rounding, under 1e-4 of
the largest, held to that level).
"""

import numpy as np
import pytest
import torch

import jax

from speechclip_tpu.models.speechclip import SpeechCLIPModel as JaxModel
from speechclip_tpu_torch.convert.from_jax import (
    speechclip_params_from_jax,
    speechclip_state_from_jax,
)
from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel
from speechclip_tpu_torch.training.train_step import create_train_state
from tests.test_torch_config import port_config_from_jax
from tests.test_torch_train_step import (
    ATOL,
    RTOL,
    _np,
    assert_grads_match,
    flat,
    jax_batch,
    jax_config,
    jax_loss_and_grads,
    make_batch,
    port_grads,
    port_tree,
)

torch.set_num_threads(2)


def trainable_temperatures(cfg):
    cfg.cl_loss.args.temperature_trainable = True
    cfg.model_settings.cascaded_branch.vq.args.temp = "learnable=0.5"
    return cfg


def supcon(cfg):
    cfg.cl_loss = {"type": "SupConLoss",
                   "args": {"temperature": 0.1, "learnable_temperature": True,
                            "base_temperature": 0.07, "contrast_mode": "all"}}
    return cfg


@pytest.mark.parametrize("variant", [trainable_temperatures, supcon])
def test_variant_loss_and_gradients_match_jax(variant):
    cfg = variant(jax_config())
    jm = JaxModel(cfg)
    jparams, jstate = jax.jit(jm.init)(jax.random.key(1))
    jtrain = type("S", (), {"params": jparams, "model_state": jstate})
    (_, jlosses), jgrads = jax_loss_and_grads(jm, jtrain, jax_batch(make_batch()))
    pm = SpeechCLIPModel(port_config_from_jax(cfg), device="cpu")
    state = create_train_state(pm, params=speechclip_params_from_jax(_np(jparams)),
                               model_state=speechclip_state_from_jax(_np(jstate)))
    own, _ = pm.init(0)  # the port's init builds the same criterion and VQ leaves
    assert set(own["criterion"]) == set(state.params["criterion"]) == set(jparams["criterion"])
    assert set(own["cascaded_branch"]["vq"]) == set(jparams["cascaded_branch"]["vq"])
    mask = flat(pm.trainable_mask(state.params))
    assert all(mask[k] for k in mask if "criterion" in k or "vq" in k)
    grads, losses = port_grads(pm, state, make_batch())
    for key, value in losses.items():
        np.testing.assert_allclose(value, float(jlosses[key]), atol=ATOL, rtol=RTOL)
    assert any("criterion" in k for k in grads)
    assert_grads_match(grads, flat(port_tree(jgrads)))
    with torch.no_grad():
        _, metrics, _, _ = pm.forward(state.params, state.model_state,
                                      {k: torch.from_numpy(v) for k, v in make_batch().items()})
    _, jmetrics, _, _ = jax.jit(jm.forward)(jparams, jstate, jax_batch(make_batch()))
    for key in ("cl_temp", "softmax_temp"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=1e-6)
