"""Shared by tests/test_torch_serving*.py: the tiny both-branch config of
``tests/test_models.py``, JAX's seeded init carried into the port
(``convert/from_jax.py``), and each package's ``EncoderService.from_model``
over the same params on the CPU."""

import io

import jax
import numpy as np
import torch

from speechclip_tpu.models.speechclip import SpeechCLIPModel as JaxModel
from speechclip_tpu.serving import EncoderService as JaxService
from speechclip_tpu_torch.config import ConfigTree, model_config_from_tree
from speechclip_tpu_torch.convert.from_jax import (
    speechclip_params_from_jax,
    speechclip_state_from_jax,
)
from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel, cast_params
from speechclip_tpu_torch.serving import EncoderService
from tests.test_models import tiny_speechclip_config

BUCKET = 2000  # samples of the tiny model's one speech bucket
ATOL = 1e-4  # f32 features, port against JAX
MIN_COSINE = 0.999  # bf16-cast weights, port against JAX, per row


class Models:
    """(JAX model, params, state) and (port model, params, state) from one
    JAX ``init``."""

    def __init__(self, tmp_dir):
        cfg = tiny_speechclip_config(tmp_dir)
        self.jax_model = JaxModel(cfg)
        self.jax_params, self.jax_state = self.jax_model.init(jax.random.key(0))
        np_tree = lambda t: jax.tree.map(np.asarray, t)
        self.model = SpeechCLIPModel(model_config_from_tree(ConfigTree(cfg.to_dict())),
                                     device="cpu")
        self.params = cast_params(speechclip_params_from_jax(np_tree(self.jax_params)),
                                  torch.float32, "cpu")
        self.state = cast_params(speechclip_state_from_jax(np_tree(self.jax_state)),
                                 torch.float32, "cpu")

    def port(self, **kw):
        kw.setdefault("wav_buckets", (BUCKET,))
        kw.setdefault("batch", 4)
        kw.setdefault("max_wait_ms", 5.0)
        return EncoderService.from_model(self.model, self.params, self.state, **kw)

    def jax(self, **kw):
        kw.setdefault("wav_buckets", (BUCKET,))
        kw.setdefault("batch", 4)
        kw.setdefault("max_wait_ms", 5.0)
        return JaxService.from_model(self.jax_model, self.jax_params, self.jax_state, **kw)


def npy_bytes(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def row_cosine(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def text_ids(model, n_mid=3):
    """A caption as the service takes it: SOT, a few ids, EOT; and its EOT
    index."""
    ids = [int(model.sot_id)] + list(range(5, 5 + n_mid)) + [int(model.eot_id)]
    return np.asarray(ids, np.int32), len(ids) - 1
